"""physattn_bwd_roofline.train: Physics-Attention's backward
(models/transolver.py _PhysicsAttention.backward): the least time of its
work on real points (portbench.flops_transolver.physattn_bwd_work) over
the device time of every kernel launched inside the backward's host
ranges, less any forward range nested in them."""

from portbench import flops_transolver as FT

RANGES = ("_PhysicsAttentionBackward",
          "autograd::engine::evaluate_function: _PhysicsAttentionBackward")


def read(view):
    t = view.trace
    if view.kind != "train" or t is None or not view.profiled:
        return None
    dev_s = t.function_device_s(RANGES, (r".",),
                                exclude=("_PhysicsAttention",))
    if not dev_s:
        return None
    return 100.0 * FT.least_physattn_s(view, backward=True) / dev_s
