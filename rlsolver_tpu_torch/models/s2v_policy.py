"""S2V constructive maxcut policy (counterpart of
`rlsolver_tpu/models/s2v_policy.py`; the rl4co S2V zoo vendored in RLSolver,
`methods/ECO_S2V/rl4co/models/zoo/S2V/`).

A structure2vec encoder embeds the instance once; a pointer decoder then
moves one not-yet-moved node from side 0 to side 1 a step, for `horizon`
steps, and the reward is the cut. Parameters keep flax's names and [in,
out] kernels (`encoder.Dense_0` .. `Dense_{3L}`, `encoder.LayerNorm_i`,
`dec_node`, `dec_state`, `dec_out`), so a flax tree converts by joining its
keys (`convert.s2v_state_dict`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from rlsolver_tpu_torch.models.transformer import Dense, LayerNorm
from rlsolver_tpu_torch.ops.sampling import gumbel_noise


class S2VEncoder(nn.Module):
    """structure2vec over a dense adjacency [B, N, N]: per layer
    h <- LayerNorm(relu(W1 h + W2 (A h / max(deg, 1)) + W3 deg_n))."""

    def __init__(self, embed_dim: int = 64, num_layers: int = 3, gen: Optional[torch.Generator] = None):
        super().__init__()
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        self.num_layers = num_layers
        self.Dense_0 = Dense(2, embed_dim, gen)
        for i in range(num_layers):
            setattr(self, f"Dense_{3 * i + 1}", Dense(embed_dim, embed_dim, gen))
            setattr(self, f"Dense_{3 * i + 2}", Dense(embed_dim, embed_dim, gen))
            setattr(self, f"Dense_{3 * i + 3}", Dense(1, embed_dim, gen))
            setattr(self, f"LayerNorm_{i}", LayerNorm(embed_dim))

    def forward(self, adj: torch.Tensor) -> torch.Tensor:  # [B, N, N] -> [B, N, D]
        deg = adj.sum(dim=-1, keepdim=True)
        deg_n = deg / torch.clamp(deg.mean(dim=1, keepdim=True), min=1e-6)
        h = self.Dense_0(torch.cat([deg_n, torch.ones_like(deg_n)], dim=-1))
        for i in range(self.num_layers):
            agg = torch.bmm(adj, h) / torch.clamp(deg, min=1.0)
            pre = (getattr(self, f"Dense_{3 * i + 1}")(h) + getattr(self, f"Dense_{3 * i + 2}")(agg)
                   + getattr(self, f"Dense_{3 * i + 3}")(deg_n))
            h = getattr(self, f"LayerNorm_{i}")(torch.relu(pre))
        return h


class S2VConstructivePolicy(nn.Module):
    """Encoder and pointer decoder; `rollout_s2v_maxcut` runs it. On `cuda`
    only where moved there (`.to(device)`), initialised as flax does from a
    seeded CPU generator."""

    def __init__(self, embed_dim: int = 64, num_layers: int = 3, seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.encoder = S2VEncoder(embed_dim, num_layers, gen)
        self.dec_node = Dense(embed_dim, embed_dim, gen)
        self.dec_state = Dense(embed_dim + 2, embed_dim, gen)
        self.dec_out = Dense(embed_dim, 1, gen)

    def encode(self, adj: torch.Tensor) -> torch.Tensor:
        return self.encoder(adj)

    def decode_logits(self, h: torch.Tensor, assigned: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        """Selection logits [B, N] from the embeddings h [B, N, D], the side
        bits [B, N] and the adjacency: the mean embedding of side 1, each
        node's normalised gain of moving to side 1 now, its side."""
        side = assigned.float()
        cnt1 = torch.clamp(side.sum(dim=1, keepdim=True), min=1.0)
        mean1 = torch.einsum("bn,bnd->bd", side, h) / cnt1
        frontier = torch.einsum("bij,bj->bi", adj, side)
        deg = torch.clamp(adj.sum(dim=-1), min=1.0)
        gain = (deg - 2.0 * frontier) / deg
        ctx = torch.cat([mean1[:, None, :].expand_as(h), gain[..., None], side[..., None]], dim=-1)
        z = torch.tanh(self.dec_node(h) + self.dec_state(ctx))
        return 10.0 * torch.tanh(self.dec_out(z)[..., 0])

    def forward(self, adj: torch.Tensor) -> torch.Tensor:
        """One decode from the empty assignment."""
        h = self.encode(adj)
        return self.decode_logits(h, torch.zeros(adj.shape[:2], dtype=torch.bool, device=adj.device), adj)


def cut_value_dense(xs: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
    """Cut of bool xs [B, N] on dense adj [B, N, N], f32 [B]."""
    s = torch.where(xs, 1.0, -1.0)
    quad = torch.einsum("bi,bij,bj->b", s, adj, s)
    w_total = adj.sum(dim=(1, 2)) / 2.0
    return (w_total - quad / 2.0) / 2.0


def rollout_s2v_maxcut(model: S2VConstructivePolicy, adj: torch.Tensor, gen: Optional[torch.Generator] = None,
                       horizon: Optional[int] = None, greedy: bool = False,
                       gumbel: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Construct solutions step by step; returns (xs bool [B, N], logp [B],
    rewards [B] = cut values). A step picks argmax(logits) with `greedy`,
    else argmax(logits + Gumbel noise) (JAX's `categorical`), the noise
    [horizon, B, N] from `gen` unless `gumbel` gives it; a moved node is
    masked to -inf."""
    b, n = adj.shape[0], adj.shape[1]
    horizon = horizon or n // 2
    h = model.encode(adj)
    assigned = torch.zeros(b, n, dtype=torch.bool, device=adj.device)
    logp = torch.zeros(b, device=adj.device)
    rows = torch.arange(b, device=adj.device)
    for t in range(horizon):
        logits = model.decode_logits(h, assigned, adj).masked_fill(assigned, float("-inf"))
        if greedy:
            pick = logits.argmax(dim=1)
        else:
            noise = gumbel_noise((b, n), gen, adj.device) if gumbel is None else gumbel[t].to(adj.device)
            pick = (logits + noise).argmax(dim=1)
        logp = logp + torch.log_softmax(logits, dim=1)[rows, pick]
        assigned = assigned.clone()
        assigned[rows, pick] = True
    return assigned, logp, cut_value_dense(assigned, adj)
