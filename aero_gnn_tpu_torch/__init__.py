"""PyTorch + CUDA port of aero_gnn_tpu for NVIDIA Hopper (H100).

The JAX package ``aero_gnn_tpu`` is the reference; this package mirrors its
layout and names so each module's counterpart is easy to find. The kernels
the JAX package runs as Pallas TPU kernels are hand-written CUDA C++ for
``sm_90a`` here (``csrc/``), each with a plain PyTorch version beside it.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(see ``device.resolve_device``). This package never imports JAX or
``aero_gnn_tpu``.
"""

from aero_gnn_tpu_torch.device import resolve_device  # noqa: F401
