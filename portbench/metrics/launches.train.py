"""launches.train: the CUDA launch calls (``cudaLaunchKernel*``,
``cuLaunchKernel*``) the trace shows inside the port's ``aero.step``
ranges, per profiled step."""

from portbench.program import launches_per_step


def read(view):
    return launches_per_step(view) if view.kind == "train" else None
