"""Attention model (AM) encoder-decoder for TSP with POMO multi-start
(counterpart of `rlsolver_tpu/models/attention_tsp.py`; RLSolver's
`methods/attention_model/AM_TSP/models.py` and `layers.py`).

The encoder (a Dense embedding of the coordinates, then `num_layers` layers
of multi-head attention + residual + LayerNorm and a 512-wide feed-forward
+ residual + LayerNorm) runs once per instance. A decode step forms its
query from the graph mean, the current and the first city's embeddings,
attends over the encodings with the visited cities masked, and scores every
city: logits = C tanh(enc . ctx / sqrt(D)), masked cities -1e4.

Parameters keep flax's names and layouts (`embed`, `enc{i}.mha.query` ...
`ln2`, `ctx`, `cur`, `fst`, `xattn`, `out`; attention kernels [D, H, D/H]
and [H, D/H, D]), so that a flax tree converts by joining its keys
(`convert.attention_tsp_state_dict`). The attention is written out as
flax's `MultiHeadDotProductAttention` computes it: q / sqrt(D/H), masked
scores filled with the f32 minimum, softmax; LayerNorm's eps is flax's 1e-6.
`decoder_cache` computes what every decode step of a rollout shares (the
context query's mean part, the cross-attention's keys and values) once.
The 1 / sqrt scales are host floats (an f32 sqrt of a whole number, so the
same value), never a tensor copied to the card each step.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rlsolver_tpu_torch.device import resolve_device
from rlsolver_tpu_torch.models.transformer import Dense, LayerNorm, _Heads, _Merge


class MultiHeadAttention(nn.Module):
    """flax `MultiHeadDotProductAttention(num_heads, qkv_features=D)`."""

    def __init__(self, dim: int, num_heads: int, gen: torch.Generator):
        super().__init__()
        self.query, self.key, self.value = (_Heads(dim, num_heads, gen) for _ in range(3))
        self.out = _Merge(dim, num_heads, gen)

    def attend(self, q_in: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """q_in [B, Q, D], k/v [B, K, H, dh], mask [B, 1, Q, K] (True =
        attend) -> [B, Q, D]."""
        q = self.query(q_in) / math.sqrt(self.query.kernel.shape[-1])
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if mask is not None:
            scores = torch.where(mask, scores, torch.finfo(scores.dtype).min)
        w = torch.softmax(scores, dim=-1)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", w, v))

    def forward(self, q_in: torch.Tensor, kv_in: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.attend(q_in, self.key(kv_in), self.value(kv_in), mask)


class EncoderLayer(nn.Module):
    """MHA + residual + LN, then the 512-wide FF + residual + LN (`layers.py`)."""

    def __init__(self, embed_dim: int, num_heads: int, ff_hidden: int, gen: torch.Generator):
        super().__init__()
        self.mha = MultiHeadAttention(embed_dim, num_heads, gen)
        self.ln1 = LayerNorm(embed_dim)
        self.ff1 = Dense(embed_dim, ff_hidden, gen)
        self.ff2 = Dense(ff_hidden, embed_dim, gen)
        self.ln2 = LayerNorm(embed_dim)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        h = self.ln1(h + self.mha(h, h))
        return self.ln2(h + self.ff2(F.relu(self.ff1(h))))


class DecoderCache(NamedTuple):
    """What the decode steps of one rollout share."""

    encoded: torch.Tensor  # [B, N, D]
    query: torch.Tensor  # [B, 1, D] = ctx(mean of encoded)
    k: torch.Tensor  # [B, N, H, dh]
    v: torch.Tensor  # [B, N, H, dh]


class AttentionTSP(nn.Module):
    """AM encoder and POMO-aware single-step decoder. Initialised as flax
    does (lecun-normal kernels, zero biases) from a seeded CPU generator,
    then moved to `device` (`cuda` unless "cpu")."""

    def __init__(self, embed_dim: int = 128, num_heads: int = 4, num_layers: int = 3, logit_clip: float = 10.0,
                 ff_hidden: int = 512, seed: int = 0, device=None):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.embed_dim, self.num_layers, self.logit_clip = embed_dim, num_layers, logit_clip
        self.embed = Dense(2, embed_dim, gen)
        for i in range(num_layers):
            self.add_module(f"enc{i}", EncoderLayer(embed_dim, num_heads, ff_hidden, gen))
        self.ctx = Dense(embed_dim, embed_dim, gen)
        self.cur = Dense(embed_dim, embed_dim, gen)
        self.fst = Dense(embed_dim, embed_dim, gen)
        self.xattn = MultiHeadAttention(embed_dim, num_heads, gen)
        self.out = Dense(embed_dim, embed_dim, gen)
        self.to(resolve_device(device))

    def encode(self, nodes: torch.Tensor) -> torch.Tensor:
        """nodes [B, N, 2] -> encodings [B, N, D]."""
        h = self.embed(nodes)
        for i in range(self.num_layers):
            h = getattr(self, f"enc{i}")(h)
        return h

    def decoder_cache(self, encoded: torch.Tensor) -> DecoderCache:
        return DecoderCache(encoded, self.ctx(encoded.mean(dim=1))[:, None, :], self.xattn.key(encoded),
                            self.xattn.value(encoded))

    def decode(self, cache: DecoderCache, current: Optional[torch.Tensor], first: Optional[torch.Tensor],
               mask: torch.Tensor) -> torch.Tensor:
        """Logits [B, P, N] for the current [B, P] and first [B, P] cities
        (None at the first step) under mask [B, P, N] (True = allowed)."""
        enc = cache.encoded
        b, p, n = mask.shape
        query = cache.query.expand(b, p, self.embed_dim)
        bidx = torch.arange(b, device=enc.device)[:, None]
        if current is not None:
            query = query + self.cur(enc[bidx, current])
        if first is not None:
            query = query + self.fst(enc[bidx, first])
        ctx = self.out(self.xattn.attend(query, cache.k, cache.v, mask[:, None, :, :]))
        logits = torch.einsum("bnd,bpd->bpn", enc, ctx) / math.sqrt(self.embed_dim)
        logits = self.logit_clip * torch.tanh(logits)
        return torch.where(mask, logits, torch.full_like(logits, -1e4))

    def forward(self, nodes: torch.Tensor, current: Optional[torch.Tensor], first: Optional[torch.Tensor],
                mask: torch.Tensor, encoded: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logits [B, P, N], encoded [B, N, D]), as the flax module's call."""
        if encoded is None:
            encoded = self.encode(nodes)
        return self.decode(self.decoder_cache(encoded), current, first, mask), encoded
