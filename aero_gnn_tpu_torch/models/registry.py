"""Model registry: build a model config from the experiment's model dict
(counterpart of aero_gnn_tpu.models.registry, with the same names, aliases,
keys and defaults), and the port's own ``transolver``.

``build_model({"name": "fouriermgn", ...}, dims)`` returns the config
(``dims``: input_node_dim, input_edge_dim, output_node_dim); its
``init(seed, device=...)`` makes the parameters, and ``AeroInference`` /
``training.loop.make_step_fns`` serve and train it, with
``needs_hierarchy=canonical_name(name) in NEEDS_HIERARCHY``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

from aero_gnn_tpu_torch.models.bsms import BSMSConfig
from aero_gnn_tpu_torch.models.fouriermgn import FourierMGNConfig
from aero_gnn_tpu_torch.models.mgn import MGNConfig
from aero_gnn_tpu_torch.models.mgn_v2 import MGNv2Config
from aero_gnn_tpu_torch.models.mlpnet import MLPNetConfig
from aero_gnn_tpu_torch.models.poolmgn import PoolMGNConfig
from aero_gnn_tpu_torch.models.transolver import TransolverConfig

# model kinds whose apply takes a graph hierarchy (the Loader's
# aux["hierarchy"], num_scales > 1)
NEEDS_HIERARCHY = ("bsms_mgn",)

_ALIASES = {
    "mlpnet": ("mlp", "mlpnet"),
    "mgn": ("meshgraphnet", "mgn"),
    "bsms_mgn": ("bsms_mgn", "bsms", "bsms-mgn"),
    "poolmgn": ("poolmgn",),
    "fouriermgn": ("fouriermgn", "fourier_mgn"),
    "mgn_v2": ("trial1", "mgn_v2", "meshgraphnet_v2"),
    # the port's own: no counterpart in the JAX package
    "transolver": ("transolver",),
}


def canonical_name(name: str) -> str:
    """The model kind of ``name`` (case-insensitive, any alias);
    ValueError on an unknown name."""
    n = name.lower()
    for kind, aliases in _ALIASES.items():
        if n in aliases:
            return kind
    raise ValueError(f"Unknown model type: {name}")


def _mgn_kwargs(mc: Dict[str, Any], dims: Dict[str, int]) -> Dict[str, Any]:
    h = mc.get("hidden_dim", 128)
    return dict(
        input_node_dim=dims["input_node_dim"],
        input_edge_dim=dims["input_edge_dim"],
        output_node_dim=dims["output_node_dim"],
        processor_size=mc.get("processor_size", 15),
        activation=mc.get("activation_fn", "relu"),
        num_hidden_layers_node_processor=mc.get(
            "num_hidden_layers_node_processor", 1),
        num_hidden_layers_edge_processor=mc.get(
            "num_hidden_layers_edge_processor", 1),
        hidden_dim_processor=h,
        num_hidden_layers_node_encoder=mc.get(
            "num_hidden_layers_node_encoder", 1),
        hidden_dim_node_encoder=h,
        num_hidden_layers_edge_encoder=mc.get(
            "num_hidden_layers_edge_encoder", 1),
        hidden_dim_edge_encoder=h,
        aggregation=mc.get("aggregation", "add"),
        hidden_dim_decoder=h,
        num_hidden_layers_decoder=mc.get("num_hidden_layers_decoder", 1),
        dropout=mc.get("dropout", 0.0),
        remat=mc.get("remat", True),
        remat_policy=mc.get("remat_policy", "save_fused"),
        remat_group=mc.get("remat_group", 0),
        compute_dtype=mc.get("compute_dtype", "float32"),
        unroll=mc.get("unroll", False),
    )


def build_model(model_config: Dict[str, Any], dims: Dict[str, int]):
    """``model_config`` is the merged model section (with 'name'); ``dims``
    carries input_node_dim / input_edge_dim / output_node_dim."""
    mc = model_config
    kind = canonical_name(mc["name"])
    if kind == "mlpnet":
        return MLPNetConfig(
            input_node_dim=dims["input_node_dim"],
            output_node_dim=dims["output_node_dim"],
            hidden_dim=mc.get("hidden_dim", 128),
            num_hidden_layers_encoder=mc.get("num_hidden_layers_encoder", 2),
            num_hidden_layers_decoder=mc.get("num_hidden_layers_decoder", 2),
            activation=mc.get("activation", "relu"),
            dropout=mc.get("dropout", 0.0),
        )
    if kind == "mgn":
        return MGNConfig(**_mgn_kwargs(mc, dims),
                         do_concat_trick=mc.get("do_concat_trick", False),
                         separate_decoders=mc.get("separate_decoders",
                                                  False))
    if kind == "bsms_mgn":
        return BSMSConfig(
            **_mgn_kwargs(mc, dims),
            do_concat_trick=mc.get("do_concat_trick", False),
            num_scales=mc.get("num_scales", 3),
            layers_per_scale=mc.get("layers_per_scale", 2),
            stride=mc.get("stride", 2),
            hierarchy_mode=mc.get("hierarchy_mode", "stride"),
            transfer=mc.get("transfer", "mean"),
        )
    if kind == "poolmgn":
        return PoolMGNConfig(
            **_mgn_kwargs(mc, dims),
            global_pool_method=mc.get("global_pool_method", "mean"),
            num_hidden_layers_global_encoder=mc.get(
                "num_hidden_layers_global_encoder", 1),
            global_dim=mc.get("global_dim", 128),
        )
    if kind == "transolver":
        # the keys the section sets; the dataclass holds the defaults
        keys = {f.name for f in dataclasses.fields(TransolverConfig)}
        return TransolverConfig(
            input_node_dim=dims["input_node_dim"],
            output_node_dim=dims["output_node_dim"],
            **{k: v for k, v in mc.items() if k in keys - {
                "input_node_dim", "output_node_dim"}})
    if kind == "fouriermgn":
        return FourierMGNConfig(
            **_mgn_kwargs(mc, dims),
            fourier_features_dim=mc.get("fourier_features_dim", 2),
            fourier_freq_start=mc.get("fourier_freq_start", -3),
            fourier_freq_length=mc.get("fourier_freq_length", 7),
        )
    return MGNv2Config(
        node_input_size=dims["input_node_dim"],
        edge_input_size=dims["input_edge_dim"],
        hidden_channels=mc.get("hidden_dim", 128),
        out_channels=dims["output_node_dim"],
        unroll=mc.get("unroll", False),
        num_graph_conv_layers=mc.get("num_message_passing_layers", 15),
        num_encoder_layers=mc.get("number_of_encoding_layers", 2),
        num_decoder_layers=mc.get("number_of_decoding_layers", 2),
        dropout=mc.get("dropout", 0.0),
    )
