"""Graph convolutional networks (counterpart of `rlsolver_tpu/models/gcn.py`):
PI-GNN's node classifier and an actor-critic backbone, as dense
symmetric-normalized adjacency matmuls D^-1/2 (A + I) D^-1/2 · H · W.

Parameters keep flax's names and [in, out] kernel layouts (`gcn0.kernel`,
..., `out.bias`; the actor-critic's `actor`, `critic`, `vh`), so a flax
tree converts by joining its keys (`convert.gcn_state_dict`). `gcn_apply`
runs the classifier on a parameter dict; its tensors may carry a leading
instance axis ([G, in, out] kernels, [G, out] biases, with [G, N, N]
adjacencies), which trains a cell of graphs at once.
"""

from __future__ import annotations

from typing import Mapping, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from rlsolver_tpu_torch.core.graph import Graph
from rlsolver_tpu_torch.device import resolve_device
from rlsolver_tpu_torch.models.transformer import Dense


def normalized_adjacency(graph: Graph, self_loops: bool = True) -> np.ndarray:
    """Symmetric-normalized adjacency D^-1/2 (A [+ I]) D^-1/2, f32 [N, N]."""
    a = graph.adjacency_dense().astype(np.float64)
    if self_loops:
        a = a + np.eye(graph.num_nodes)
    d = a.sum(axis=1)
    d_inv_sqrt = 1.0 / np.sqrt(np.maximum(d, 1e-12))
    return (a * d_inv_sqrt[:, None] * d_inv_sqrt[None, :]).astype(np.float32)


def _dense(params: Mapping[str, torch.Tensor], name: str, x: torch.Tensor) -> torch.Tensor:
    bias = params[name + ".bias"]
    return x @ params[name + ".kernel"] + (bias if bias.dim() == 1 else bias.unsqueeze(-2))


def gcn_apply(params: Mapping[str, torch.Tensor], x: torch.Tensor, a_norm: torch.Tensor,
              num_layers: int) -> torch.Tensor:
    """x [..., N, F] -> [..., N, out_dim]."""
    for i in range(num_layers):
        x = torch.relu(_dense(params, f"gcn{i}", a_norm @ x))
    return _dense(params, "out", a_norm @ x)


class GCN(nn.Module):
    """Stacked GCN layers -> per-node outputs [..., N, out_dim] (the JAX
    module's dropout, which no caller turns on, is left out)."""

    def __init__(self, in_features: int, hidden: Sequence[int] = (64,), out_dim: int = 1, seed: int = 0,
                 device=None):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.hidden = tuple(hidden)
        widths = (in_features,) + self.hidden
        for i, h in enumerate(self.hidden):
            setattr(self, f"gcn{i}", Dense(widths[i], h, gen))
        self.out = Dense(widths[-1], out_dim, gen)
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor, a_norm: torch.Tensor) -> torch.Tensor:
        """x: [..., N, F]; a_norm: [N, N] normalized adjacency."""
        return gcn_apply(dict(self.named_parameters()), x, a_norm, len(self.hidden))


class GCNActorCritic(nn.Module):
    """Per-node policy logits and a mean-pooled state value."""

    def __init__(self, in_features: int, hidden: Sequence[int] = (64, 64), seed: int = 0, device=None):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.hidden = tuple(hidden)
        widths = (in_features,) + self.hidden
        for i, h in enumerate(self.hidden):
            setattr(self, f"gcn{i}", Dense(widths[i], h, gen))
        self.actor = Dense(widths[-1], 1, gen)
        self.vh = Dense(widths[-1], 64, gen)
        self.critic = Dense(64, 1, gen)
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor, a_norm: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        h = x
        for i in range(len(self.hidden)):
            h = torch.relu(getattr(self, f"gcn{i}")(a_norm @ h))
        logits = self.actor(h)[..., 0]  # [..., N]
        value = self.critic(torch.relu(self.vh(h.mean(dim=-2))))[..., 0]
        return logits, value
