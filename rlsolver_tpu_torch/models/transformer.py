"""Graph-embedding transformer and the L2A policy/value cell (counterpart of
`rlsolver_tpu/models/transformer.py`).

  * `GraphEncoder`: adjacency rows -> per-node embeddings, with a
    reconstruction head for its pretraining; `embed` gives the frozen,
    std-normalised `seq_graph` [B, N, D] that the policy reads.
  * `PolicyTrsWithValue`: (solution as +-1 channels, seq_graph) -> per-node
    two-way logits and a value summed over nodes.

Parameters keep the JAX package's layout and names, so that a flax tree
converts by joining its keys (`convert.flax_state_dict`): Dense kernels are
[in, out], the attention's query/key/value kernels [D, H, dh] and its output
kernel [H, dh, D]; unnamed flax submodules keep flax's automatic names
(`LayerNorm_0`, `Dense_0`). They are initialised as flax does: lecun-normal
kernels (a normal truncated to +-2 standard deviations, variance 1 / fan_in)
and zero biases, LayerNorm scale 1, from a seeded CPU generator, and then
moved to the module's device (`cuda` unless `device="cpu"`). flax's `gelu` is
the tanh approximation and its LayerNorm's eps is 1e-6; both are kept.

The attention is plain tensor code (XLA in the JAX package, not Pallas).
`ChunkedMHA` keeps the JAX package's bound on the score tensor: above
`score_budget` bytes of f32 scores it attends a chunk of queries at a time
(exact: every chunk sees all keys), and under autograd each chunk is
recomputed in the backward pass (`_RecomputedAttention`), as
`jax.checkpoint` does, so that the [B, H, N, N] scores never exist whole:
at 256 sims and N = 2000 they would take 16 GB.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rlsolver_tpu_torch.device import resolve_device

# 1 / the standard deviation of a unit normal truncated to [-2, 2], by which
# flax's variance_scaling widens its truncated draws
_TRUNC_STD = 0.87962566103423978


def solution_to_prob_channels(xs: torch.Tensor) -> torch.Tensor:
    """bool [B, N] -> f32 [B, N, 2] with (+1, -1) channels (RLSolver's
    `convert_solution_to_prob`)."""
    s = torch.where(xs, 1.0, -1.0).to(torch.float32)
    return torch.stack([s, -s], dim=-1)


def lecun_normal(shape: Sequence[int], fan_in: int, gen: torch.Generator) -> torch.Tensor:
    """flax's lecun_normal on the CPU: a unit normal truncated to [-2, 2]
    (inverse CDF of a uniform draw, as jax.random.truncated_normal), times
    sqrt(1 / fan_in) / 0.8796..."""
    lo, hi = (1.0 + math.erf(-2.0 / math.sqrt(2.0))) / 2.0, (1.0 + math.erf(2.0 / math.sqrt(2.0))) / 2.0
    u = lo + (hi - lo) * torch.rand(tuple(shape), generator=gen, dtype=torch.float64)
    z = (math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)).clamp(-2.0, 2.0)
    return (z * (math.sqrt(1.0 / fan_in) / _TRUNC_STD)).to(torch.float32)


class Dense(nn.Module):
    """flax `nn.Dense`: x @ kernel [in, out] + bias [out]."""

    def __init__(self, in_features: int, out_features: int, gen: torch.Generator):
        super().__init__()
        self.kernel = nn.Parameter(lecun_normal((in_features, out_features), in_features, gen))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.kernel + self.bias


class LayerNorm(nn.Module):
    """flax `nn.LayerNorm` over the last axis (eps 1e-6)."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, (x.shape[-1],), self.scale, self.bias, eps=1e-6)


class _Heads(nn.Module):
    """flax `nn.DenseGeneral((H, dh))`: [.., D] -> [.., H, dh]."""

    def __init__(self, dim: int, heads: int, gen: torch.Generator):
        super().__init__()
        self.kernel = nn.Parameter(lecun_normal((dim, heads, dim // heads), dim, gen))
        self.bias = nn.Parameter(torch.zeros(heads, dim // heads))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.einsum("bnd,dhk->bnhk", x, self.kernel) + self.bias


class _Merge(nn.Module):
    """flax `nn.DenseGeneral(D, axis=(-2, -1))`: [.., H, dh] -> [.., D]."""

    def __init__(self, dim: int, heads: int, gen: torch.Generator):
        super().__init__()
        self.kernel = nn.Parameter(lecun_normal((heads, dim // heads, dim), dim, gen))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.einsum("bnhk,hkd->bnd", x, self.kernel) + self.bias


def _attend(qc: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[B, H, qc, dh] queries against all keys and values -> [B, H, qc, dh]."""
    return torch.softmax(qc @ k.transpose(-1, -2), dim=-1) @ v


class _RecomputedAttention(torch.autograd.Function):
    """`_attend` keeping only its inputs for the backward pass, which
    recomputes the chunk's scores: what `torch.utils.checkpoint` does, by
    hand, since its first call in a process imports `torch._dynamo` (and
    with it sympy and torch.distributed's packages), seconds that every
    fresh process, a spawned rank too, would pay in its first update."""

    @staticmethod
    def forward(ctx, qc, k, v):
        ctx.save_for_backward(qc, k, v)
        return _attend(qc, k, v)

    @staticmethod
    def backward(ctx, grad):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = _attend(*inputs)
        return torch.autograd.grad(out, inputs, grad)


class ChunkedMHA(nn.Module):
    """Multi-head attention whose f32 score tensor stays within
    `score_budget` bytes (see the module notes)."""

    def __init__(self, dim: int, num_heads: int, gen: torch.Generator, score_budget: int = 1 << 28):
        super().__init__()
        self.num_heads, self.score_budget = num_heads, score_budget
        self.query, self.key, self.value = (_Heads(dim, num_heads, gen) for _ in range(3))
        self.out = _Merge(dim, num_heads, gen)

    def forward(self, q_in: torch.Tensor, kv_in: torch.Tensor) -> torch.Tensor:
        h = self.num_heads
        # heads-major [B, H, N, dh], made contiguous once: each chunk's
        # products are then plain batched matmuls with no copies
        q, k, v = (t.transpose(1, 2).contiguous() for t in (self.query(q_in), self.key(kv_in), self.value(kv_in)))
        q = q / torch.sqrt(torch.tensor(float(q.shape[-1]), device=q.device))
        b, n = q.shape[0], q.shape[2]
        if 4 * b * h * n * n <= self.score_budget:
            out = _attend(q, k, v)
        else:
            qc = max(1, self.score_budget // (4 * b * h * n))
            nc = -(-n // qc)
            qc = -(-n // nc)
            grad = torch.is_grad_enabled() and q.requires_grad
            chunks = [q[:, :, i : i + qc] for i in range(0, n, qc)]
            attend = _RecomputedAttention.apply if grad else _attend
            out = torch.cat([attend(c, k, v) for c in chunks], 2)
        return self.out(out.transpose(1, 2))


class _MLP(nn.Module):
    """Dense layers `fc0..fc{k-1}` of widths `dims`, an activation between."""

    def __init__(self, in_features: int, dims: Sequence[int], gen: torch.Generator, act: str = "gelu"):
        super().__init__()
        self.act = act
        widths = [in_features, *dims]
        for i, (a, b) in enumerate(zip(widths, widths[1:])):
            self.add_module(f"fc{i}", Dense(a, b, gen))
        self.num_layers = len(dims)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"fc{i}")(x)
            if i < self.num_layers - 1:
                x = F.gelu(x, approximate="tanh") if self.act == "gelu" else torch.tanh(x)
        return x


class EncoderBlock(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, mlp_dim: int, gen: torch.Generator):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(embed_dim)
        self.attn = ChunkedMHA(embed_dim, num_heads, gen)
        self.LayerNorm_1 = LayerNorm(embed_dim)
        self.Dense_0 = Dense(embed_dim, mlp_dim, gen)
        self.Dense_1 = Dense(mlp_dim, embed_dim, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.LayerNorm_0(x)
        x = x + self.attn(h, h)
        h = self.Dense_1(F.gelu(self.Dense_0(self.LayerNorm_1(x)), approximate="tanh"))
        return x + h


class GraphEncoder(nn.Module):
    """Adjacency rows -> per-node embeddings, with a reconstruction head."""

    def __init__(self, num_nodes: int, embed_dim: int = 64, num_heads: int = 4, num_layers: int = 2,
                 mlp_dim: int = 256, seed: int = 0, device=None):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.inp = _MLP(num_nodes, (num_nodes, mlp_dim, embed_dim), gen)
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"enc{i}", EncoderBlock(embed_dim, num_heads, mlp_dim, gen))
        self.emb = _MLP(embed_dim, (embed_dim, embed_dim), gen)
        self.dec = _MLP(embed_dim, (mlp_dim, num_nodes), gen)
        self.to(resolve_device(device))

    def forward(self, adj_rows: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """adj_rows f32 [B, N, N] -> (recon_logits [B, N, N], seq_graph [B, N, D])."""
        x = self.inp(adj_rows)
        for i in range(self.num_layers):
            x = getattr(self, f"enc{i}")(x)
        seq_graph = self.emb(x)
        return self.dec(seq_graph), seq_graph

    def embed(self, adj_rows: torch.Tensor) -> torch.Tensor:
        """The frozen features: seq_graph over its (population) std per node."""
        _, seq_graph = self(adj_rows)
        return seq_graph / (torch.std(seq_graph, dim=-1, keepdim=True, correction=0) + 1e-6)


class PolicyTrs(nn.Module):
    """(solution channels [B, N, 2], seq_graph [N, D]) -> (logits [B, N, 2],
    memory [B, N, D]). As in the JAX package, "cross_attn" attends x to
    itself, like "self_attn"."""

    def __init__(self, embed_dim: int, num_heads: int, gen: torch.Generator):
        super().__init__()
        self.prob_embed = Dense(2, embed_dim // 4, gen)
        self.mix = Dense(embed_dim + embed_dim // 4, embed_dim, gen)
        self.self_attn = ChunkedMHA(embed_dim, num_heads, gen)
        self.cross_attn = ChunkedMHA(embed_dim, num_heads, gen)
        self.mem_out = Dense(embed_dim, embed_dim, gen)
        self.prob_out = Dense(embed_dim, 2, gen)

    def forward(self, prob_ch: torch.Tensor, seq_graph: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        g = seq_graph[None].expand(prob_ch.shape[0], *seq_graph.shape)
        x = self.mix(torch.cat([g, self.prob_embed(prob_ch)], dim=-1))
        x = x + self.self_attn(x, x)
        x = x + self.cross_attn(x, x)
        t = torch.tanh(x)
        return self.prob_out(t), self.mem_out(t)


class PolicyTrsWithValue(nn.Module):
    """PolicyTrs and the node-summed value head: value = MLP(tanh(memory))
    summed over nodes."""

    def __init__(self, embed_dim: int = 64, num_heads: int = 4, seed: int = 0, device=None):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.cell = PolicyTrs(embed_dim, num_heads, gen)
        self.value_mlp = _MLP(embed_dim, (embed_dim, 1), gen, act="tanh")
        self.to(resolve_device(device))

    def forward(self, prob_ch: torch.Tensor, seq_graph: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        logits, memory = self.cell(prob_ch, seq_graph)
        return logits, self.value_mlp(torch.tanh(memory))[..., 0].sum(dim=-1)
