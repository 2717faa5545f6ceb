"""Message-passing Q-network for the Pattern-I methods (counterpart of
`rlsolver_tpu/models/mpnn.py`).

Per-node observations are embedded, refined by `n_layers` rounds of
degree-normalised neighbourhood aggregation, and read out to one value per
node with a mean-pooled global context. Parameters keep flax's names and
[in, out] kernel layouts (`node_init.kernel`, `message_0.kernel`, ...,
`readout_out.bias`), so a flax tree converts by joining its keys
(`convert.mpnn_state_dict`). They are initialised as flax does
(lecun-normal kernels, zero biases) from a seeded CPU generator.

`dtype` follows flax's `dtype` attribute: inputs and kernels are cast to
it, each aggregation is accumulated in f32 and then cast (JAX's
`preferred_element_type=f32`), the division by the degree is done in
`dtype`, and the output is f32. With a shared [N, N] adjacency the network
runs node-major ([N, B, d]), so each aggregation is one GEMM
[N, N] @ [N, B·d] with the batch folded into its columns; a per-sample
[B, N, N] adjacency runs batch-major through batched GEMMs.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from rlsolver_tpu_torch.device import resolve_device
from rlsolver_tpu_torch.models.transformer import lecun_normal


class Dense(nn.Module):
    """flax `nn.Dense(dtype=...)`: x @ kernel [in, out] (+ bias), computed in
    the dtype of x."""

    def __init__(self, in_features: int, out_features: int, gen: torch.Generator, use_bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(lecun_normal((in_features, out_features), in_features, gen))
        self.bias = nn.Parameter(torch.zeros(out_features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.kernel.to(x.dtype)
        return y if self.bias is None else y + self.bias.to(x.dtype)


class MPNN(nn.Module):
    def __init__(self, num_obs: int = 7, features: int = 64, n_layers: int = 3, tied_weights: bool = False,
                 readout_hidden: Sequence[int] = (), dtype: torch.dtype = torch.float32, seed: int = 0,
                 device=None):
        super().__init__()
        f = features
        self.features, self.n_layers, self.tied_weights = f, n_layers, tied_weights
        self.readout_hidden, self.dtype = tuple(readout_hidden), dtype
        gen = torch.Generator().manual_seed(seed)
        self.node_init = Dense(num_obs, f, gen, use_bias=False)
        self.edge_embed = Dense(num_obs, f - 1, gen, use_bias=False)
        self.edge_feature = Dense(f, f, gen, use_bias=False)
        for i in range(1 if tied_weights else n_layers):
            suffix = "" if tied_weights else f"_{i}"
            setattr(self, f"message{suffix}", Dense(2 * f, f, gen, use_bias=False))
            setattr(self, f"update{suffix}", Dense(2 * f, f, gen, use_bias=False))
        self.pool = Dense(f, f, gen, use_bias=False)
        width = 2 * f
        for k, w in enumerate(self.readout_hidden):
            setattr(self, f"readout_{k}", Dense(width, w, gen))
            width = w
        self.readout_out = Dense(width, 1, gen)
        self.to(resolve_device(device))

    def forward(self, node_obs: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        """node_obs: [B, N, obs]; adj: [N, N] (shared) or [B, N, N].

        Returns per-node values [B, N] in f32."""
        dt = self.dtype
        relu = torch.relu
        a = adj.to(dt)
        norm = (adj != 0).sum(dim=-1, keepdim=True).to(dt).clamp_min(1.0)  # [N, 1] or [B, N, 1]
        if a.dim() == 2:  # node-major [N, B, d]; the batch rides in the GEMM's columns
            nd = 0
            x = node_obs.to(dt).transpose(0, 1).contiguous()
            norm = norm[:, :, None]  # [N, 1, 1]
            rel_deg = norm / norm.max()

            def agg(v):
                n_, b_, d_ = v.shape
                return (a @ v.reshape(n_, b_ * d_)).reshape(n_, b_, d_) / norm
        else:  # batch-major [B, N, d]
            nd = 1
            x = node_obs.to(dt)
            rel_deg = norm / norm.amax(dim=1, keepdim=True)

            def agg(v):
                return torch.bmm(a, v) / norm

        h = relu(self.node_init(x))
        e = relu(self.edge_embed(agg(x)))
        e = relu(self.edge_feature(torch.cat([e, rel_deg.expand(e.shape[:-1] + (1,))], dim=-1)))
        for i in range(self.n_layers):
            suffix = "" if self.tied_weights else f"_{i}"
            m = relu(getattr(self, f"message{suffix}")(torch.cat([agg(h), e], dim=-1)))
            h = relu(getattr(self, f"update{suffix}")(torch.cat([h, m], dim=-1)))

        pooled = self.pool(h.mean(dim=nd))  # [B, f]
        g = pooled.unsqueeze(nd).expand(h.shape)
        z = relu(torch.cat([g, h], dim=-1))
        for k in range(len(self.readout_hidden)):
            z = relu(getattr(self, f"readout_{k}")(z))
        q = self.readout_out(z)[..., 0].to(torch.float32)
        return q.t() if nd == 0 else q
