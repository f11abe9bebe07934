"""Port parity for the inference report: aero coefficients, the errors.txt
writer, run_inference end to end (MGN and BSMS) and the rollout harness,
each against the JAX package on the same inputs and weights."""

import os
import re

import jax
import numpy as np
import pytest
import torch

from aero_gnn_tpu.data import dataset as JD
from aero_gnn_tpu.data import synthetic as JS
from aero_gnn_tpu.graph import padded as JP
from aero_gnn_tpu.inference import aero_coeffs as JC
from aero_gnn_tpu.inference import rollout as JR
from aero_gnn_tpu.inference.engine import AeroInference as JaxInference
from aero_gnn_tpu.models.registry import build_model as jax_build_model
from aero_gnn_tpu_torch.data import dataset as TD
from aero_gnn_tpu_torch.data import synthetic as TS
from aero_gnn_tpu_torch.graph import padded as TP
from aero_gnn_tpu_torch.inference import aero_coeffs as TC
from aero_gnn_tpu_torch.inference import rollout as TR
from aero_gnn_tpu_torch.inference.engine import AeroInference
from aero_gnn_tpu_torch.models.convert import params_from_jax
from aero_gnn_tpu_torch.models.registry import build_model

RTOL, ATOL = 2e-4, 2e-5  # fp32 predictions (tests/test_torch_inference.py)
REPORT_RTOL = 1e-3  # printed numbers, plus half a unit in the last place
FEATURES = ["P", "tau_x", "tau_y", "T"]
DIMS = {"input_node_dim": 6, "input_edge_dim": 3, "output_node_dim": 4}
TINY_MGN = {"name": "meshgraphnet", "hidden_dim": 16, "processor_size": 2,
            "num_hidden_layers_node_processor": 2,
            "num_hidden_layers_edge_processor": 2,
            "do_concat_trick": True, "aggregation": "add"}
TINY_BSMS = {"name": "bsms_mgn", "hidden_dim": 16, "processor_size": 3,
             "num_scales": 3, "layers_per_scale": 1, "stride": 2,
             "hierarchy_mode": "stride", "transfer": "mean"}

_NUM = re.compile(r"-?\d+(?:\.(\d+))?")


def assert_report_close(got: str, want: str):
    """Line for line: the same text between the numbers (whitespace
    ignored, as the fixed-width columns pad by the number's sign and size),
    each number within REPORT_RTOL plus half a unit in its last printed
    place."""
    got_lines, want_lines = got.splitlines(), want.splitlines()
    assert len(got_lines) == len(want_lines)
    for g, w in zip(got_lines, want_lines):
        def skeleton(line):
            return "".join(_NUM.sub("#", line).split())

        assert skeleton(g) == skeleton(w), (g, w)
        for mg, mw in zip(_NUM.finditer(g), _NUM.finditer(w)):
            a, b = float(mg.group()), float(mw.group())
            half_ulp = 0.5 * 10.0 ** -len(mw.group(1) or "")
            assert abs(a - b) <= REPORT_RTOL * abs(b) + half_ulp, (g, w)


def test_aero_coefficients_match_jax():
    rng = np.random.default_rng(0)
    s = JS.make_airfoil_dataset(n_cases=1, n_points=64, seed=4)[0]
    kw = dict(pos=s.pos.astype(np.float64),
              normals=s.normals.astype(np.float64), senders=s.senders,
              receivers=s.receivers,
              pressure=rng.standard_normal((s.num_nodes, 1)) * 1e3 + 1e5,
              shear_stress=rng.standard_normal((s.num_nodes, 2)),
              reference_area=1e-2, reference_length=1.0,
              dynamic_pressure=TC.airfoil_dynamic_pressure(0.6))
    assert TC.calculate_aero_coefficients_2d(**kw) == \
        JC.calculate_aero_coefficients_2d(**kw)
    assert TC.airfoil_dynamic_pressure(0.6) == JC.airfoil_dynamic_pressure(0.6)
    n = 50
    kw3 = dict(cell_areas=rng.random(n),
               cell_normals=rng.standard_normal((n, 3)),
               pressure_true=rng.standard_normal(n),
               shear_true=rng.standard_normal((n, 3)),
               pressure_pred=rng.standard_normal(n),
               shear_pred=rng.standard_normal((n, 3)),
               reference_area=0.056,
               dynamic_pressure=TC.ahmed_dynamic_pressure(40.0))
    assert TC.calculate_aero_coefficients_3d(**kw3) == \
        JC.calculate_aero_coefficients_3d(**kw3)
    assert TC.ahmed_dynamic_pressure(40.0) == JC.ahmed_dynamic_pressure(40.0)


@pytest.mark.parametrize("dataset_name", ["synthetic_airfoil", "ahmed_body",
                                          "missile_3d"])
def test_errors_txt_byte_equal(dataset_name, tmp_path):
    rng = np.random.default_rng(1)

    def fw():
        return {f: {"mae": float(rng.random() * 10.0 ** rng.integers(-3, 5)),
                    "mse": float(rng.random() * 10.0 ** rng.integers(-3, 9))}
                for f in FEATURES}

    cases = []
    for i in range(5):
        c = {"case_id": i, "rrmse_percent": float(rng.random() * 120),
             "errors_physical": fw(), "errors_normalized": fw(),
             "coeff_str": f" | CA:{rng.standard_normal():7.4f} (0.1000)"}
        if i != 3:  # one case without its metadata: "N/A" columns
            c.update(airfoil=f"naca{i:02d}", mach=0.3 + 0.1 * i,
                     alpha=-2.0 + i, case_no=f"run{i}")
        cases.append(c)
    mean_phys, mean_norm = fw(), fw()
    out = []
    for cls, name in ((AeroInference, "t"), (JaxInference, "j")):
        path = tmp_path / f"{name}.txt"
        cls._write_errors_txt(str(path), cases, mean_phys, mean_norm,
                              FEATURES, dataset_name)
        out.append(path.read_bytes())
    assert out[0] == out[1]


def _test_set(mod, dmod, n_cases=12, n_points=48):
    samples = mod.make_airfoil_dataset(n_cases=n_cases, n_points=n_points,
                                       seed=5)
    _, _, test, stats = dmod.create_datasets(
        samples, dataset_type="synthetic_airfoil",
        params={"dataset": {"var_keys": ["mach", "alpha"]},
                "training": {"validation_split": 0.25, "test_split": 0.25,
                             "random_seed": 3}})
    return test, stats


def _engines(model_conf, exp, **opts):
    """The JAX engine over a JAX init and the port's over the same weights
    (params_from_jax), with the two packages' test sets and stats."""
    jtest, jstats = _test_set(JS, JD)
    ttest, tstats = _test_set(TS, TD)
    jcfg = jax_build_model(model_conf, DIMS)
    tcfg = build_model(model_conf, DIMS)
    tree = jax.tree.map(np.asarray, jcfg.init(jax.random.PRNGKey(2)))
    jeng = JaxInference(jcfg, tree, jstats, exp, **opts)
    teng = AeroInference(tcfg, params_from_jax(tree, tcfg, device="cpu"),
                         tstats, exp, device="cpu", **opts)
    return (jeng, jtest), (teng, ttest)


def _run(eng, test, out_dir):
    lines = []
    d = eng.run_inference(test, str(out_dir), log_fn=lines.append,
                          timestamp="t")
    return lines, open(os.path.join(d, "errors.txt")).read()


EXP = {"dataset": {"name": "synthetic_airfoil", "output_features": FEATURES},
       "make_plots": False}


@pytest.mark.parametrize("model", ["mgn", "bsms"])
def test_run_inference_matches_jax(model, tmp_path):
    """The same errors.txt and log lines from both packages (the port on
    the CPU, the JAX package on its CPU backend); BSMS through
    AeroInference(needs_hierarchy=True, num_scales=3, hierarchy_mode=
    "stride"), whose run_inference builds its own hierarchy Loader."""
    if model == "mgn":
        conf, opts = TINY_MGN, {}
    else:
        conf = TINY_BSMS
        opts = dict(needs_hierarchy=True, num_scales=3,
                    hierarchy_mode="stride", stride=2)
    (jeng, jtest), (teng, ttest) = _engines(conf, EXP, **opts)
    jlines, jtxt = _run(jeng, jtest, tmp_path / "j")
    tlines, ttxt = _run(teng, ttest, tmp_path / "t")
    assert ttxt.startswith("TEST_MEAN | rrmse:")
    assert len([ln for ln in ttxt.splitlines() if ln.startswith("case_")]) \
        == len(ttest) == 3
    assert_report_close(ttxt, jtxt)
    assert_report_close("\n".join(tlines[:-1]), "\n".join(jlines[:-1]))
    assert tlines[-1].startswith("Inference complete!")


def test_run_inference_batch_size_does_not_change_cases(tmp_path):
    """inference_batch_size 2 packs cases into one pass; the per-case lines
    equal the batch-size-1 run's (tests/test_training.py's contract)."""
    _, (teng, ttest) = _engines(TINY_MGN, EXP)
    logs = {}
    for bs in (1, 2):
        teng.exp_params = dict(EXP, inference_batch_size=bs)
        lines, _ = _run(teng, ttest, tmp_path / f"bs{bs}")
        logs[bs] = [ln for ln in lines if ln.startswith("Error in case")]
    assert logs[1] and logs[1] == logs[2]


def test_run_inference_writes_plots_and_3d_exports(tmp_path):
    """make_plots: one PNG per 2D case; a 3D case without its source mesh
    is exported as a line-graph VTU."""
    pytest.importorskip("matplotlib")
    _, (teng, ttest) = _engines(TINY_MGN, dict(EXP, make_plots=True))
    d = teng.run_inference(ttest[:1], str(tmp_path), log_fn=lambda _: None,
                           timestamp="t")
    assert os.listdir(os.path.join(d, "plots")) == \
        ["prediction_case_000_predictions.png"]
    s = TD.MeshSample(pos=np.c_[ttest[0].pos, np.zeros(ttest[0].num_nodes,
                                                       np.float32)],
                      normals=ttest[0].normals, senders=ttest[0].senders,
                      receivers=ttest[0].receivers, y=ttest[0].y,
                      meta={"case_no": "c7"}, x=ttest[0].x,
                      edge_attr=ttest[0].edge_attr)
    d = teng.run_inference([s], str(tmp_path), log_fn=lambda _: None,
                           timestamp="u")
    assert os.listdir(os.path.join(d, "vtu_exports")) == \
        ["c7_predictions.vtu"]


def _graphs(n_graphs=3):
    out = []
    for k in range(n_graphs):
        s = JS.make_airfoil_dataset(n_cases=1, n_points=40, seed=10 + k)[0]
        JD.compute_features([s], ["mach", "alpha"])
        g = dict(senders=s.senders, receivers=s.receivers, x=s.x,
                 edge_attr=s.edge_attr, pos=s.pos, y=s.y, align_edges=True)
        out.append((JP.build_graph_batch(**g),
                    TP.build_graph_batch(**g, device="cpu")))
    return out


def test_rollouts_match_jax():
    jcfg, tcfg = jax_build_model(TINY_MGN, DIMS), build_model(TINY_MGN, DIMS)
    tree = jax.tree.map(np.asarray, jcfg.init(jax.random.PRNGKey(4)))
    params = params_from_jax(tree, tcfg, device="cpu")
    graphs = _graphs()
    jstack = JR.stack_graphs([j for j, _ in graphs])
    tstack = TR.stack_graphs([t for _, t in graphs])
    assert tstack.x.shape == tuple(jstack.x.shape)
    want = np.asarray(JR.make_batch_rollout(jcfg)(tree, jstack))
    got = TR.make_batch_rollout(tcfg)(params, tstack)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)

    jg, tg = graphs[0]
    x_before = tg.x.clone()
    for cols in (None, [0, 1, 4, 5]):
        want = np.asarray(JR.autoregressive_rollout(
            jcfg, tree, jg, steps=3, feedback_columns=cols))
        got = TR.autoregressive_rollout(tcfg, params, tg, steps=3,
                                        feedback_columns=cols)
        assert got.shape == want.shape == (3, tg.num_nodes_pad, 4)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert torch.equal(tg.x, x_before), "the caller's graph was written"
