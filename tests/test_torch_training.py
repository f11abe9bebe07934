"""Port parity for training: first-step gradients of a small flagship-shaped
MeshGraphNet (h = 32, 3 layers, 2 hidden layers per MLP, concat trick) with
JAX-initialised weights against jax.value_and_grad of the JAX package, Adam
steps, the optimizer's L2, the schedulers, the Loader, and fit on the CPU."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from aero_gnn_tpu import ops as jops
from aero_gnn_tpu.data import batching as JB
from aero_gnn_tpu.data import dataset as JD
from aero_gnn_tpu.data import synthetic as JS
from aero_gnn_tpu.graph import padded as JP
from aero_gnn_tpu.models.mgn import MGNConfig as JaxMGNConfig
from aero_gnn_tpu.training import loop as JL
from aero_gnn_tpu.training import schedulers as JSch
from aero_gnn_tpu_torch import ops as tops
from aero_gnn_tpu_torch.data import batching as TB
from aero_gnn_tpu_torch.data import dataset as TD
from aero_gnn_tpu_torch.data import synthetic as TS
from aero_gnn_tpu_torch.graph import padded as TP
from aero_gnn_tpu_torch.inference.engine import AeroInference
from aero_gnn_tpu_torch.models.convert import params_from_jax, params_to_jax
from aero_gnn_tpu_torch.models.mgn import MGNConfig
from aero_gnn_tpu_torch.training import loop as TL
from aero_gnn_tpu_torch.training import schedulers as TSch

H = 32
_SMALL = dict(input_node_dim=6, input_edge_dim=3, output_node_dim=4,
              processor_size=3, hidden_dim_processor=H,
              hidden_dim_node_encoder=H, hidden_dim_edge_encoder=H,
              hidden_dim_decoder=H, num_hidden_layers_node_processor=2,
              num_hidden_layers_edge_processor=2,
              num_hidden_layers_node_encoder=2,
              num_hidden_layers_edge_encoder=2, num_hidden_layers_decoder=2,
              do_concat_trick=True)


def _graphs(align=True):
    s = JS.make_random_mesh_sample(n_nodes=500, avg_degree=6, seed=2)
    JD.compute_features([s], ["mach", "alpha"])
    g = dict(senders=s.senders, receivers=s.receivers, x=s.x,
             edge_attr=s.edge_attr, pos=s.pos, y=s.y)
    return (JP.build_graph_batch(**g, align_edges=align),
            TP.build_graph_batch(**g, align_edges=align, device="cpu"))


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _jax_grads(jcfg, tree, jb, jax_backend):
    def loss_fn(p):
        return JL.masked_mse(jcfg.apply(p, jb), jb.y, jb.node_mask)

    with jops.use_backend(jax_backend), pltpu.force_tpu_interpret_mode():
        loss, grads = jax.value_and_grad(loss_fn)(tree)
    return float(loss), _leaves(grads)


def _port_grads(tcfg, tree, tb, port_backend):
    params = params_from_jax(jax.tree.map(np.asarray, tree), tcfg,
                             device="cpu")
    with tops.use_backend(port_backend):
        loss = TL.masked_mse(tcfg.apply(params, tb), tb.y, tb.node_mask)
        loss.backward()
    return float(loss.detach()), _leaves(params_to_jax(params, tcfg,
                                                       grads=True))


@pytest.mark.parametrize("port_backend", ["cuda", "torch"])
@pytest.mark.parametrize("jax_backend,remat", [("xla", True),
                                               ("pallas", False)])
def test_first_step_grads_match_jax(jax_backend, remat, port_backend):
    """port_backend "cuda": fused path, K1-K5 plain versions on CPU tensors;
    "torch": the unfused composition, with per-layer checkpoints when remat
    is on. Interpret-mode pallas_call cannot sit under jax.checkpoint, so
    the pallas reference runs with remat off."""
    jcfg = JaxMGNConfig(**_SMALL, remat=remat)
    tcfg = MGNConfig(**_SMALL, remat=remat)
    tree = jcfg.init(jax.random.PRNGKey(7))
    jb, tb = _graphs()
    jloss, jgrads = _jax_grads(jcfg, tree, jb, jax_backend)
    tloss, tgrads = _port_grads(tcfg, tree, tb, port_backend)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    assert tgrads.keys() == jgrads.keys()
    for name, g in jgrads.items():
        np.testing.assert_allclose(tgrads[name], g, rtol=1e-3,
                                   atol=1e-5 * np.abs(g).max(initial=1e-30),
                                   err_msg=name)


def test_full_remat_gives_the_same_grads():
    """remat_policy="full" recomputes each fused layer in the backward
    (torch.utils.checkpoint): the same gradients as no remat."""
    tree = JaxMGNConfig(**_SMALL).init(jax.random.PRNGKey(7))
    _, tb = _graphs()
    out = [_port_grads(MGNConfig(**_SMALL, remat=remat, remat_policy=pol),
                       tree, tb, "cuda")
           for remat, pol in ((False, "save_fused"), (True, "full"))]
    for name, g in out[0][1].items():
        np.testing.assert_array_equal(out[1][1][name], g, err_msg=name)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        params = params_from_jax(jax.tree.map(np.asarray, tree),
                                 MGNConfig(**_SMALL), device="cpu")
        MGNConfig(**_SMALL, remat_group=3).apply(params, tb)


def test_bf16_grads_are_rounded_then_cast_up():
    """compute_dtype bfloat16: the fp32 masters get fp32 gradients whose
    values are bf16 numbers (rounded in the compute dtype, then cast up, as
    the JAX cast_params VJP does)."""
    tcfg = MGNConfig(**_SMALL, compute_dtype="bfloat16")
    _, tb = _graphs()
    params = tcfg.init(0, device="cpu")
    TL.masked_mse(tcfg.apply(params, tb), tb.y, tb.node_mask).backward()
    for name, p in params.named_parameters():
        assert p.dtype == p.grad.dtype == torch.float32, name
        assert torch.equal(p.grad, p.grad.bfloat16().float()), name
        assert torch.isfinite(p.grad).all(), name


def test_five_adam_steps_track_jax():
    jcfg = JaxMGNConfig(**_SMALL)
    tcfg = MGNConfig(**_SMALL)
    tree = jcfg.init(jax.random.PRNGKey(7))
    jb, tb = _graphs()
    opt = JL.make_optimizer(1e-3)
    fns = JL.make_step_fns(jcfg, opt, donate=False)
    p, st, jlosses = tree, opt.init(tree), []
    for _ in range(5):
        p, st, loss = fns.train_step(p, st, jb, None, None)
        jlosses.append(float(loss))
    params = params_from_jax(jax.tree.map(np.asarray, tree), tcfg,
                             device="cpu")
    tfns = TL.make_step_fns(tcfg, TL.make_optimizer(params, 1e-3),
                            device="cpu")
    tlosses = [float(tfns.train_step(params, tb)) for _ in range(5)]
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    assert tlosses[-1] < tlosses[0]


def test_adam_weight_decay_matches_optax_chain():
    rng = np.random.default_rng(0)
    shapes = [(5, 3), (7,)]
    init = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(5)]
    import optax

    opt = JL.make_optimizer(1e-2, weight_decay=0.1)
    jp = [jax.numpy.asarray(a) for a in init]
    st = opt.init(jp)
    module = torch.nn.ParameterList(
        [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init])
    topt = TL.make_optimizer(module, 1e-2, weight_decay=0.1)
    for step, gs in enumerate(grads):
        lr = 1e-2 * 0.5 ** step
        st = JL.set_learning_rate(st, lr)
        TL.set_learning_rate(topt, lr)
        up, st = opt.update([jax.numpy.asarray(g) for g in gs], st, jp)
        jp = optax.apply_updates(jp, up)
        for prm, g in zip(module, gs):
            prm.grad = torch.from_numpy(g)
        topt.step()
    for prm, a in zip(module, jp):
        np.testing.assert_allclose(prm.detach().numpy(), np.asarray(a),
                                   rtol=1e-5, atol=1e-6)


def test_schedulers_match_jax():
    series = [1.0, 0.9, 0.9, 0.91, 0.95, 0.8, 0.8, 0.85, 0.9, 0.9, 0.7,
              0.7001, 0.71, 0.72, 0.73, 0.74]
    jp, tp = JSch.ReduceLROnPlateau(lr=1e-3, patience=2), \
        TSch.ReduceLROnPlateau(lr=1e-3, patience=2)
    je, te = JSch.EarlyStopping(patience=3), TSch.EarlyStopping(patience=3)
    assert [jp.step(m) for m in series] == [tp.step(m) for m in series]
    assert [je.step(m) for m in series] == [te.step(m) for m in series]
    assert te.should_stop


@pytest.mark.parametrize("align", [False, True])
def test_loader_matches_jax(align):
    jsam = [JS.make_random_mesh_sample(n_nodes=150 + 40 * i, seed=i)
            for i in range(5)]
    tsam = [TS.make_random_mesh_sample(n_nodes=150 + 40 * i, seed=i)
            for i in range(5)]
    JD.compute_features(jsam, ["mach", "alpha"])
    TD.compute_features(tsam, ["mach", "alpha"])
    jl = JB.Loader(jsam, 2, shuffle=True, seed=3, align_edges=align)
    tl = TB.Loader(tsam, 2, shuffle=True, seed=3, align_edges=align,
                   device="cpu")
    assert len(tl) == len(jl) == 3
    assert dataclasses.asdict(tl.pad_spec) == dataclasses.asdict(jl.pad_spec)
    for _ in range(2):  # two epochs: the shuffle follows the epoch
        for (jg, jaux), (tg, taux) in zip(jl, tl):
            assert [s.meta for s in jaux["samples"]] == \
                [s.meta for s in taux["samples"]]
            for name in ("senders", "receivers", "sender_perm",
                         "senders_sorted", "x", "edge_attr", "y",
                         "edge_mask", "node_mask", "node_graph",
                         "graph_mask"):
                np.testing.assert_array_equal(
                    getattr(tg, name).numpy(), np.asarray(getattr(jg, name)),
                    err_msg=name)
    # with num_scales > 1 the batches carry the hierarchy (BSMS); its
    # arrays are compared with JAX's in test_torch_hierarchy.py
    _, aux = next(iter(TB.Loader(tsam, 2, num_scales=2, device="cpu")))
    assert len(aux["hierarchy"]) == 1


def test_fit_on_cpu_and_dropout():
    tsam = [TS.make_random_mesh_sample(n_nodes=300, seed=i) for i in range(3)]
    TD.compute_features(tsam, ["mach", "alpha"])
    cfg = MGNConfig(**{**_SMALL, "processor_size": 2}, dropout=0.1)
    loader = TB.Loader(tsam, 2, shuffle=True, device="cpu")
    logs = []
    res = TL.fit(model_cfg=cfg, params=cfg.init(0, device="cpu"),
                 train_loader=loader, val_loader=loader,
                 training_config={"epochs": 4, "learning_rate": 3e-3},
                 log_fn=logs.append, device="cpu")
    assert res.epochs_run == 4 and len(logs) == 4
    assert res.train_losses[-1] < res.train_losses[0]
    # dropout acts only with a generator; the same seed, the same masks
    g = next(iter(loader))[0]
    with torch.no_grad():
        plain = cfg.apply(res.params, g)
        runs = [cfg.apply(res.params, g,
                          generator=torch.Generator().manual_seed(5))
                for _ in range(2)]
        no_drop = dataclasses.replace(cfg, dropout=0.0).apply(
            res.params, g, generator=torch.Generator().manual_seed(5))
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], plain)
    assert torch.equal(no_drop, plain)


def test_checkpoint_resume(tmp_path):
    """fit(checkpoint_dir=, resume) as the JAX package's
    (tests/test_training.py::test_checkpoint_resume): 4 epochs saved every
    2, then a resumed run to 6 continues from epoch 4 with the saved
    history, params and Adam state restored in place; metrics.jsonl beside
    the checkpoint directory."""
    import json
    import os

    from aero_gnn_tpu_torch.training import checkpoint as C

    tsam = [TS.make_random_mesh_sample(n_nodes=200, seed=i) for i in range(4)]
    TD.compute_features(tsam, ["mach", "alpha"])
    cfg = MGNConfig(**{**_SMALL, "processor_size": 2})
    ckpt = str(tmp_path / "ckpt")
    common = dict(model_cfg=cfg,
                  train_loader=TB.Loader(tsam, 2, shuffle=True,
                                         device="cpu"),
                  val_loader=TB.Loader(tsam[:2], 2, device="cpu"),
                  log_every=0, log_fn=lambda _: None, checkpoint_dir=ckpt,
                  device="cpu")
    base = {"learning_rate": 1e-3, "checkpoint_every": 2,
            "early_stopping": False}
    r1 = TL.fit(params=cfg.init(0, device="cpu"),
                training_config=dict(base, epochs=4), **common)
    assert sorted(os.listdir(ckpt)) == ["ckpt_00000002.pt",
                                        "ckpt_00000004.pt"]
    saved = {n: p.detach().clone() for n, p in r1.params.named_parameters()}
    logs = []
    fresh = cfg.init(1, device="cpu")
    r2 = TL.fit(params=fresh, training_config=dict(base, epochs=6,
                                                   resume=True),
                **dict(common, log_fn=logs.append))
    assert logs[0] == "resumed from checkpoint at epoch 4"
    assert r2.epochs_run == 6  # 4 restored + 2 new
    assert r2.train_losses[:4] == r1.train_losses
    assert len(r2.val_losses) == 6
    # the newest checkpoint is epoch 6's; epoch 4's holds r1's params, and
    # the resumed Adam carried its step count on (6 epochs of 2 steps)
    probe = cfg.init(2, device="cpu")
    assert C.restore_latest(ckpt, probe,
                            TL.make_optimizer(probe, 1e-3))[0] == 6
    payload = torch.load(os.path.join(ckpt, "ckpt_00000004.pt"),
                         weights_only=True)
    probe.load_state_dict(payload["params"])
    for n, p in probe.named_parameters():
        assert torch.equal(p, saved[n]), n
    assert {int(st["step"]) for st in r2.optimizer.state.values()} == {12}
    lines = [json.loads(ln) for ln in open(tmp_path / "metrics.jsonl")]
    assert [ln["step"] for ln in lines] == [0, 1, 2, 3, 4, 5]
    assert all({"train_loss", "val_loss", "lr", "time"} <= set(ln)
               for ln in lines)


def test_engine_casts_once_and_serves_without_grad():
    cfg = MGNConfig(**_SMALL, compute_dtype="bfloat16")
    params = cfg.init(0, device="cpu")
    eng = AeroInference(cfg, params, {"target_mean": np.zeros(4),
                                      "target_std": np.ones(4)},
                        device="cpu")
    assert all(p.dtype == torch.bfloat16 and not p.requires_grad
               for p in eng.params.parameters())
    assert all(p.dtype == torch.float32 for p in params.parameters())
    out = eng.predict(_graphs()[1])
    assert out.dtype == torch.float32 and not out.requires_grad
