"""Port parity: AeroInference.predict_single of the port (device="cpu")
against the JAX package's, same weights and normalisation statistics."""

import jax
import numpy as np

from aero_gnn_tpu.data import dataset as JD
from aero_gnn_tpu.data import synthetic as JS
from aero_gnn_tpu.graph import padded as JP
from aero_gnn_tpu.inference.engine import AeroInference as JaxInference
from aero_gnn_tpu.inference.metrics import compute_rrmse_percent as jax_rrmse
from aero_gnn_tpu.models.mgn import MGNConfig as JaxMGNConfig
from aero_gnn_tpu_torch.data.dataset import denormalize_predictions
from aero_gnn_tpu_torch.graph import padded as TP
from aero_gnn_tpu_torch.inference import metrics as TMET
from aero_gnn_tpu_torch.inference.engine import AeroInference
from aero_gnn_tpu_torch.models.convert import params_from_jax
from aero_gnn_tpu_torch.models.mgn import MGNConfig

RTOL, ATOL = 2e-4, 2e-5  # fp32 CPU bar (tests/test_reference_parity.py)
_CFG = dict(input_node_dim=6, input_edge_dim=3, output_node_dim=4,
            processor_size=2, hidden_dim_processor=32,
            hidden_dim_node_encoder=32, hidden_dim_edge_encoder=32,
            hidden_dim_decoder=32, num_hidden_layers_node_processor=2,
            num_hidden_layers_edge_processor=2, do_concat_trick=True)


def test_predict_single_matches_jax():
    s = JS.make_random_mesh_sample(n_nodes=400, seed=9)
    JD.compute_features([s], ["mach", "alpha"])
    # physical-scale targets so denormalisation is not the identity
    s.y = (s.y * 50.0 + 3.0).astype(np.float32)
    stats = JD.compute_normalization_stats([s])
    JD.normalize_samples([s], stats)
    g = dict(senders=s.senders, receivers=s.receivers, x=s.x,
             edge_attr=s.edge_attr, pos=s.pos, y=s.y, align_edges=True)
    jb = JP.build_graph_batch(**g)
    tb = TP.build_graph_batch(**g, device="cpu")

    jcfg, tcfg = JaxMGNConfig(**_CFG), MGNConfig(**_CFG)
    tree = jcfg.init(jax.random.PRNGKey(1))
    jeng = JaxInference(jcfg, tree, stats, {})
    teng = AeroInference(tcfg, params_from_jax(jax.tree.map(np.asarray, tree),
                                               tcfg, device="cpu"),
                         stats, {}, device="cpu")
    jp, jt, jpn, jtn = jeng.predict_single(jb, {}, s.num_nodes)
    tp, tt, tpn, ttn = teng.predict_single(tb, {}, s.num_nodes)
    np.testing.assert_array_equal(ttn, jtn)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(denormalize_predictions(tpn, stats), tp)
    np.testing.assert_allclose(tpn, jpn, rtol=RTOL, atol=ATOL)
    # physical units: the normalised tolerance scaled by each field's std
    np.testing.assert_allclose(tp, jp, rtol=RTOL,
                               atol=ATOL * float(stats["target_std"].max()))
    np.testing.assert_allclose(TMET.compute_rrmse_percent(tp, tt),
                               jax_rrmse(jp, jt), rtol=1e-3)
    names = ["p", "tx", "ty", "T"]
    t_fw = TMET.featurewise_mae_mse(tp, tt, names)
    assert set(t_fw) == set(names)
    assert all(np.isfinite(v["mse"]) for v in t_fw.values())
