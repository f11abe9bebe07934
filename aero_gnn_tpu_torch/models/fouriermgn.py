"""Fourier-feature MeshGraphNet (counterpart of
aero_gnn_tpu.models.fouriermgn).

The embedding is ``[cos, sin](2^i * pi * u)`` for i in [freq_start,
freq_start + freq_length) over the FIRST ``fourier_features_dim`` columns
of the node features, concatenated onto the node input before encoding.
Per node and per feature column: [cos(f_0 u) .. cos(f_{L-1} u), sin(f_0 u)
.. sin(f_{L-1} u)], columns in order (the row-major flatten of [N, d, 2L]).
The rest is the MeshGraphNet over the expanded input, with its parameters,
its compute-dtype policy and its processor: the registry's FourierMGN
leaves ``do_concat_trick`` off, so on an aligned graph its layers run the
unfused layer (K6 and K5 on the card).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import torch

from aero_gnn_tpu_torch.device import DeviceLike
from aero_gnn_tpu_torch.graph.padded import GraphBatch
from aero_gnn_tpu_torch.models.mgn import MeshGraphNet, MGNConfig, mgn_base


def fourier_embedding(features: torch.Tensor, *, dims: int, freq_start: int,
                      freq_length: int) -> torch.Tensor:
    """[N, >= dims] -> [N, 2 * freq_length * dims] Fourier features, in the
    features' dtype with the frequencies ``(2.0 ** i) * pi`` formed in it."""
    u = features[:, :dims]
    i = torch.arange(freq_start, freq_start + freq_length,
                     dtype=features.dtype, device=features.device)
    freqs = (2.0 ** i) * math.pi
    phase = u[:, :, None] * freqs[None, None, :]
    emb = torch.cat([torch.cos(phase), torch.sin(phase)], dim=-1)
    return emb.reshape(features.shape[0], -1)


@dataclasses.dataclass(frozen=True)
class FourierMGNConfig(MGNConfig):
    fourier_features_dim: int = 2
    fourier_freq_start: int = -3
    fourier_freq_length: int = 7

    @property
    def base(self) -> MGNConfig:
        """The MeshGraphNet over the expanded node input."""
        n_emb = 2 * self.fourier_freq_length * self.fourier_features_dim
        return mgn_base(self, self.input_node_dim + n_emb)

    def init(self, generator: Union[torch.Generator, int, None] = None, *,
             device: DeviceLike = None) -> MeshGraphNet:
        """The MeshGraphNet parameters of ``base`` (MGNConfig.init)."""
        return self.base.init(generator, device=device)

    def apply(self, params: MeshGraphNet, graph: GraphBatch, *,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Forward pass -> fp32 [N_pad, output_node_dim]."""
        emb = fourier_embedding(graph.x, dims=self.fourier_features_dim,
                                freq_start=self.fourier_freq_start,
                                freq_length=self.fourier_freq_length)
        expanded = dataclasses.replace(graph,
                                       x=torch.cat([graph.x, emb], dim=-1))
        return self.base.apply(params, expanded, generator=generator)
