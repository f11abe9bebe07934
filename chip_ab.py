"""Compare checkouts of the port on one NVIDIA GPU, in one process each.

    python3 chip_ab.py TREE [TREE ...]

Each TREE is a directory holding a checkout (this one, ``.``, or another
unpacked with ``git archive``). In the order given -- give parent, change,
change, parent to see the spread -- each builds its kernels, times K1-K5
at the flagship shapes with that tree's own ``chip_smoke.phase_kernels``
(CUDA events, median of 20), and times 12 bf16 train steps and 10 bf16
forwards of the flagship MeshGraphNet on mesh 0 (host clock to a
synchronize, both switches unset). One line per tree starts with "AB "
and holds a JSON object. Nothing of JAX is imported.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time


def host_ms(torch, fn, n: int, skip: int = 2) -> float:
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[skip:])


def measure(tree: str) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    import chip_smoke as C
    from aero_gnn_tpu_torch.inference.engine import AeroInference
    from aero_gnn_tpu_torch.training import loop as TL

    torch.backends.cuda.matmul.allow_tf32 = False
    C.phase_build()
    sample, g = C.flagship_graph(0, torch.device("cuda"))
    out = {"tree": tree, "kernel_ms": {
        r["name"]: r["ms"] for r in C.phase_kernels(torch, g)}}
    cfg = C.flagship_config(compute_dtype="bfloat16")
    params = cfg.init(torch.Generator().manual_seed(0), device=g.device)
    fns = TL.make_step_fns(cfg, TL.make_optimizer(params, 1e-3),
                           device=g.device)
    out["bf16_step_ms"] = host_ms(torch, lambda: fns.train_step(params, g),
                                  14)
    eng = AeroInference(cfg, params, {"target_mean": np.zeros(4),
                                      "target_std": np.ones(4)},
                        device=g.device)
    out["bf16_forward_ms"] = host_ms(torch, lambda: eng.predict(g), 12)
    return out


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print("AB " + json.dumps(measure(sys.argv[2])), flush=True)
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    for tree in sys.argv[1:]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        tree], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
