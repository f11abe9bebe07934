"""A configuration, a traffic mix, a cell and a per-layer metric added as
files and manifest entries are found by name and run, with no existing
file of portbench/ edited."""

import json

from portbench import run


def test_added_files_are_found_and_run(tiny):
    root = tiny.parent
    b = json.loads(tiny.read_text())
    cfg = json.loads((root / b["configs"][0]["file"]).read_text())
    cfg["model"]["hidden_dim"] = 8
    (root / "portbench/configs/toy.json").write_text(json.dumps(cfg))
    (root / "portbench/traffic/toy-mix.json").write_text(json.dumps({
        "kind": "train", "nodes": 200, "avg_degree": 6, "pool": 3,
        "batch_size": 2, "warm_epochs": 1, "check_steps": 2,
        "profile_steps": 2}))
    (root / "portbench/limits/toy-cell.json").write_text(json.dumps(
        {"loss_gap": 1.0, "grad_gap": 1.0, "update_gap": 1.0}))
    (root / "portbench/metrics").mkdir(exist_ok=True)
    (root / "portbench/metrics/toy_steps.py").write_text(
        "def read(view):\n    return float(view.count)\n")
    b["configs"].append({"name": "toy", "source": "https://example.org",
                         "file": "portbench/configs/toy.json", "reduced": [],
                         "why": "toy"})
    b["workloads"].append({"name": "toy-cell", "config": "toy",
                           "traffic": "toy-mix", "chips": 1, "why": "toy"})
    b["per_layer"].append({"name": "toy_steps", "unit": "steps",
                           "better": "higher", "source": "program_counter",
                           "layer": "toy", "moves": "train_step_ms",
                           "workloads": ["toy-cell"]})
    next(m for m in b["end_to_end"]
         if m["name"] == "train_step_ms")["workloads"].append("toy-cell")
    tiny.write_text(json.dumps(b))

    m = run.Manifest(tiny)
    out = run.run_cell(m, "toy-cell", 5, 0.3, False, device="cpu")
    assert out["line"]["correct"] is True
    assert set(out["line"]["metrics"]) == {"setup_s", "train_step_ms"}
    traced = run.run_cell(m, "toy-cell", 5, 0.3, True, device="cpu")
    assert traced["line"]["metrics"]["toy_steps"]["value"] >= 1
    assert traced["line"]["metrics"]["toy_steps"]["unit"] == "steps"
