"""physattn_fwd_roofline.train: Physics-Attention's forward
(models/transolver.py _PhysicsAttention): the least time of its work on
real points (portbench.flops_transolver.physattn_fwd_work) over the device
time of every kernel launched inside the function's host ranges."""

from portbench import flops_transolver as FT


def read(view):
    t = view.trace
    if view.kind != "train" or t is None or not view.profiled:
        return None
    dev_s = t.function_device_s(("_PhysicsAttention",), (r".",))
    if not dev_s:
        return None
    return 100.0 * FT.least_physattn_s(view, backward=False) / dev_s
