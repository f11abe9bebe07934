"""The readings the limits of ``limits/<workload>.json`` are set from; the
benchmark's own runs never run this.

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,... \
        --control-seeds 101,102,103 [--out FILE]

For each of ``--seeds`` it runs the cell's set-up and first steps (a
serving cell: ``check_requests`` requests) through the port exactly as a
run does, without the measured window, and prints the compared numbers
(the lower reading: the program's). For each of ``--control-seeds`` it
prints the numbers of the control -- the reference in the configuration's
``control`` precision (``fp8`` below bfloat16, ``tf32`` below float32)
in the program's place -- and of each fault the cell can have, planted in
the program's timed path (training: a step that leaves its state
unchanged, half of the batch left out; serving: the answers altered where
they are produced).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

from portbench import check, inputs, run
from portbench import weights as W
from portbench.reference import train as RT

FAULTS = {"train": ("half_batch", "frozen_state"),
          "serve": ("altered_answer",)}


def _detail(prog: dict, ref: dict) -> dict:
    """Per-step loss gaps and the three worst leaves of each leaf number,
    for the look at what a reading is made of."""
    def worst(p, r, keys):
        scale = float(np.median(list(r.values())))
        gaps = sorted(((abs(p[k] - r[k]) / max(r[k], scale, 1e-30), k)
                       for k in keys), reverse=True)[:3]
        return [[k, g] for g, k in gaps]

    g_med = float(np.median(list(ref["grad1"].values())))
    moved = [k for k, g in ref["grad1"].items() if g >= 1e-3 * g_med]
    return {"step_loss_gaps": [abs(a - b) / abs(b) for a, b in
                               zip(prog["losses"], ref["losses"])],
            "ref_losses": ref["losses"],
            "worst_grad": worst(prog["grad1"], ref["grad1"], ref["grad1"]),
            "worst_update": worst(prog["delta"], ref["delta"], moved)}


def control_numbers(manifest, workload: str, seed: int, device):
    """(the control's compared numbers, what they are made of)."""
    cell = manifest.cells[workload]
    cfg, tr = manifest.config(cell), manifest.traffic(cell)
    ref = run._ref_model(cfg)
    meshes = run.make_pool(tr, seed)
    w0 = W.make(ref.layout(cfg), inputs.sub_seed(seed, 2), device)
    low = cfg["control"]
    if tr["kind"] == "train":
        # the first steps' meshes in the Loader's shuffled order
        order = np.arange(len(meshes))
        np.random.default_rng(inputs.sub_seed(seed, 3)).shuffle(order)
        first = [meshes[i] for i in order[:tr["check_steps"]]]
        judge = RT.adam_steps(ref, cfg, w0, first, device,
                              lr=cfg["learning_rate"])
        ctrl = RT.adam_steps(ref, cfg, w0, first, device, precision=low,
                             lr=cfg["learning_rate"])
        return check.train_numbers(ctrl, judge), _detail(ctrl, judge)
    gaps = []
    lo_m, hi_m = tr["mach"]
    lo_a, hi_a = tr["alpha"]
    for k in range(tr["check_requests"]):
        rng = np.random.default_rng(inputs.sub_seed(seed, 4, k))
        mesh = meshes[int(rng.integers(len(meshes)))]
        mesh.meta = {"mach": float(rng.uniform(lo_m, hi_m)),
                     "alpha": float(rng.uniform(lo_a, hi_a))}
        inputs.compute_features(mesh)
        judge = RT.predict(ref, cfg, w0, mesh, device).cpu().numpy()
        ctrl = RT.predict(ref, cfg, w0, mesh, device, low).cpu().numpy()
        gaps.append(check.pred_rms_err(ctrl, judge))
    return {"pred_rms_err": max(gaps)}, {"gaps": gaps}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--manifest", default="BENCHMARK.json")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    ap.add_argument("--no-faults", action="store_true",
                    help="the control alone on --control-seeds")
    args = ap.parse_args(argv)
    manifest = run.Manifest(Path(args.manifest))
    tr = manifest.traffic(manifest.cells[args.workload])
    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    def program(seed, fault=None):
        res = run.run_cell(manifest, args.workload, seed, 0.0, False,
                           device=args.device, fault=fault,
                           min_requests=tr.get("check_requests", 0),
                           use_limits=False)
        rec = res["record"]
        if "program" in rec:
            return {**rec["numbers"],
                    **_detail(rec["program"], rec["reference"])}
        return {**rec["numbers"], "gaps": rec["gaps"]}

    for s in [int(v) for v in args.seeds.split(",") if v]:
        emit({"what": "program", "seed": s, **program(s)})
    for s in [int(v) for v in args.control_seeds.split(",") if v]:
        numbers, detail = control_numbers(manifest, args.workload, s,
                                          args.device)
        emit({"what": "control", "seed": s, **numbers, **detail})
        for f in () if args.no_faults else FAULTS[tr["kind"]]:
            emit({"what": f, "seed": s, **program(s, f)})
    summary = {}
    for what in sorted({r["what"] for r in rows}):
        sel = [r for r in rows if r["what"] == what]
        summary[what] = {k: [min(r[k] for r in sel), max(r[k] for r in sel)]
                         for k in sel[0] if isinstance(sel[0][k], float)}
    print("SUMMARY " + json.dumps({"workload": args.workload, **summary}),
          flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            for r in rows:
                f.write(json.dumps({"workload": args.workload, **r}) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
