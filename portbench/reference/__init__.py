"""The plain reference: MeshGraphNet and BSMS forward passes, the masked
MSE loss, Adam and the bistride hierarchy in plain PyTorch and NumPy, in
float32 with TF32 off. It imports nothing of the port (``aero_gnn_tpu_torch``)
and nothing of the JAX package, and works every derived quantity (graphs,
hierarchies, weights' layout) out again from the benchmark's inputs.

A model module (``mgn``, ``bsms``) gives ``layout(cfg)`` -- the weights'
names, shapes and init kind, in the port's parameter naming -- and
``prepare(cfg, mesh, device)`` / ``forward(w, cfg, inputs, mm, ckpt)``.
``mm`` is the matmul of a precision (``precision.matmul``).
"""
