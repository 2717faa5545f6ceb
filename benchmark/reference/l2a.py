"""Plain PyTorch reference of distribution-wise L2A's training (RLSolver's
`L2A/demo_distribution.py` and `L2A/transformer.py`): the graph encoder and
its adjacency auto-encoding pretraining, the policy transformer, the
REINFORCE loss over `seq_len` unrolled improvement steps, and Adam with
optax's global-norm clip, at a precision given by `dtype`.

Parameters are a dict in flax's layout and names (Dense kernels [in, out],
attention kernels [D, H, dh] and [H, dh, D]); `encoder_shapes` and
`policy_shapes` list them, and `make_params` makes them from a seed on the
device, so that the program and the reference start from the same weights.
Attention runs over a block of sims at a time, so that its scores fit.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def _dense(p: dict, name: str, a: int, b: int):
    p[f"{name}.kernel"], p[f"{name}.bias"] = (a, b), (b,)


def _attn(p: dict, name: str, d: int, h: int):
    for k in ("query", "key", "value"):
        p[f"{name}.{k}.kernel"], p[f"{name}.{k}.bias"] = (d, h, d // h), (h, d // h)
    p[f"{name}.out.kernel"], p[f"{name}.out.bias"] = (h, d // h, d), (d,)


def encoder_shapes(n: int, d: int, h: int, mlp: int = 256, layers: int = 2) -> Dict[str, tuple]:
    p: Dict[str, tuple] = {}
    for i, (a, b) in enumerate([(n, n), (n, mlp), (mlp, d)]):
        _dense(p, f"inp.fc{i}", a, b)
    for i in range(layers):
        p[f"enc{i}.LayerNorm_0.scale"] = p[f"enc{i}.LayerNorm_0.bias"] = (d,)
        _attn(p, f"enc{i}.attn", d, h)
        p[f"enc{i}.LayerNorm_1.scale"] = p[f"enc{i}.LayerNorm_1.bias"] = (d,)
        _dense(p, f"enc{i}.Dense_0", d, mlp)
        _dense(p, f"enc{i}.Dense_1", mlp, d)
    _dense(p, "emb.fc0", d, d)
    _dense(p, "emb.fc1", d, d)
    _dense(p, "dec.fc0", d, mlp)
    _dense(p, "dec.fc1", mlp, n)
    return p


def policy_shapes(d: int, h: int) -> Dict[str, tuple]:
    p: Dict[str, tuple] = {}
    _dense(p, "cell.prob_embed", 2, d // 4)
    _dense(p, "cell.mix", d + d // 4, d)
    _attn(p, "cell.self_attn", d, h)
    _attn(p, "cell.cross_attn", d, h)
    _dense(p, "cell.mem_out", d, d)
    _dense(p, "cell.prob_out", d, 2)
    _dense(p, "value_mlp.fc0", d, d)
    _dense(p, "value_mlp.fc1", d, 1)
    return p


def make_params(shapes: Dict[str, tuple], seed: int, device) -> Params:
    """Kernels ~ N(0, 1 / fan_in) (fan_in: the product of all axes but the
    last), biases 0, LayerNorm scales 1; all kernels from one draw of a
    generator on the device seeded `seed`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    sizes = {k: math.prod(s) for k, s in shapes.items() if k.endswith("kernel")}
    z = torch.randn(sum(sizes.values()), generator=gen, device=device)
    out, at = {}, 0
    for k, s in shapes.items():
        if k.endswith("kernel"):
            out[k] = (z[at : at + sizes[k]] / math.sqrt(math.prod(s[:-1]))).reshape(s)
            at += sizes[k]
        elif k.endswith("scale"):
            out[k] = torch.ones(s, device=device)
        else:
            out[k] = torch.zeros(s, device=device)
    return out


def _lin(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    return x @ p[f"{name}.kernel"] + p[f"{name}.bias"]


def _mha(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    """Self-attention of x [B, N, D]."""
    q, k, v = (torch.einsum("bnd,dhk->bhnk", x, p[f"{name}.{t}.kernel"]) + p[f"{name}.{t}.bias"][None, :, None]
               for t in ("query", "key", "value"))
    q = q / math.sqrt(q.shape[-1])
    o = torch.softmax(q @ k.transpose(-1, -2), dim=-1) @ v  # [B, H, N, dh]
    return torch.einsum("bhnk,hkd->bnd", o, p[f"{name}.out.kernel"]) + p[f"{name}.out.bias"]


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _ln(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), p[f"{name}.scale"], p[f"{name}.bias"], eps=1e-6)


def encoder(p: Params, adj: torch.Tensor, layers: int = 2):
    """adjacency rows [B, N, N] -> (reconstruction [B, N, N], seq [B, N, D])."""
    x = _lin(p, "inp.fc2", _gelu(_lin(p, "inp.fc1", _gelu(_lin(p, "inp.fc0", adj)))))
    for i in range(layers):
        x = x + _mha(p, f"enc{i}.attn", _ln(p, f"enc{i}.LayerNorm_0", x))
        x = x + _lin(p, f"enc{i}.Dense_1", _gelu(_lin(p, f"enc{i}.Dense_0", _ln(p, f"enc{i}.LayerNorm_1", x))))
    seq = _lin(p, "emb.fc1", _gelu(_lin(p, "emb.fc0", x)))
    return _lin(p, "dec.fc1", _gelu(_lin(p, "dec.fc0", seq))), seq


def embed(p: Params, adj: torch.Tensor) -> torch.Tensor:
    """The policy's frozen features of one graph: seq over its per-node std."""
    with torch.no_grad():
        _, seq = encoder(p, adj[None])
    seq = seq[0]
    return seq / (torch.std(seq, dim=-1, keepdim=True, correction=0) + 1e-6)


def policy_probs(p: Params, xs: torch.Tensor, seq: torch.Tensor) -> torch.Tensor:
    """P(bit = 1) of each node of each sim, xs bool [B, N]: the policy's
    two-way logits, softmax, channel 0."""
    s = torch.where(xs, 1.0, -1.0).to(seq.dtype)
    ch = torch.stack([s, -s], dim=-1)
    g = seq[None].expand(xs.shape[0], *seq.shape)
    x = _lin(p, "cell.mix", torch.cat([g, _lin(p, "cell.prob_embed", ch)], dim=-1))
    x = x + _mha(p, "cell.self_attn", x)
    x = x + _mha(p, "cell.cross_attn", x)
    logits = _lin(p, "cell.prob_out", torch.tanh(x))
    return torch.softmax(logits, dim=-1)[..., 0]


def flip_sweep(bits: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
    """One greedy 1-flip sweep, ascending nodes, strict gains (integer
    weights: exact in float32)."""
    s = bits.to(torch.float32) * 2.0 - 1.0
    for i in range(adj.shape[0]):
        gain = s[:, i] * (s @ adj[i])
        s[:, i] = torch.where(gain > 0, -s[:, i], s[:, i])
    return s > 0


def cut(bits: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    return (bits[:, edges[:, 0]] != bits[:, edges[:, 1]]).sum(dim=1).to(torch.float64)


class Adam:
    """optax.chain(clip_by_global_norm(max_norm), adam(lr)) (no clip with
    max_norm None) on a dict of parameters."""

    def __init__(self, params: Params, lr: float, max_norm=None):
        self.lr, self.max_norm = lr, max_norm
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    def step(self, params: Params, grads: Params) -> Params:
        """Returns the new parameters; `grads` maps every key (zeros where a
        parameter has no gradient)."""
        if self.max_norm is not None:
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
            if float(norm) >= self.max_norm:
                grads = {k: g / norm * self.max_norm for k, g in grads.items()}
        self.count += 1
        c1, c2 = 1.0 - 0.9 ** self.count, 1.0 - 0.999 ** self.count
        out = {}
        for k, g in grads.items():
            self.mu[k] = 0.9 * self.mu[k] + 0.1 * g
            self.nu[k] = 0.999 * self.nu[k] + 0.001 * g * g
            out[k] = params[k] - self.lr * (self.mu[k] / c1) / (torch.sqrt(self.nu[k] / c2) + 1e-8)
        return out


def pretrain_step(p: Params, adj: torch.Tensor):
    """(loss, grads) of the encoder's reconstruction error on one graph."""
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
    recon, _ = encoder(leaves, adj[None])
    loss = torch.mean((recon - adj[None]) ** 2)
    keys = list(leaves)
    g = torch.autograd.grad(loss, [leaves[k] for k in keys], allow_unused=True)
    return float(loss.detach()), {k: (gi if gi is not None else torch.zeros_like(leaves[k])) for k, gi in zip(keys, g)}


def reinforce_step(p: Params, seq: torch.Tensor, xs_steps: Sequence[torch.Tensor], cands: Sequence[torch.Tensor],
                   advs: Sequence[torch.Tensor], block: int = 16):
    """(loss, grads, scale) of -(1 / T) sum_t mean_b(log P(cand_tb | probs_tb)
    adv_tb) over T unrolled steps, the policy read at the incumbents xs_t
    [S, N]; log P of a candidate sums log(clamp(s p + (1 - s)(1 - p), 1e-8))
    over nodes. `scale` is the loss's terms' size, (1 / T) sum_t mean_b
    |log P adv|, against which a loss near 0 is compared. Sims go a block at
    a time (each sim's terms are its own)."""
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
    keys = list(leaves)
    grads = {k: torch.zeros_like(v) for k, v in leaves.items()}
    sims, steps = xs_steps[0].shape[0], len(xs_steps)
    total = scale = 0.0
    for lo in range(0, sims, block):
        loss = 0.0
        for t in range(steps):
            probs = policy_probs(leaves, xs_steps[t][lo : lo + block], seq)
            s = cands[t][lo : lo + block].to(probs.dtype)
            logp = torch.log(torch.clamp(s * probs + (1 - s) * (1 - probs), min=1e-8)).sum(dim=1)
            term = logp * advs[t][lo : lo + block].to(probs.dtype)
            loss = loss - torch.sum(term) / sims
            scale += float(term.detach().abs().sum()) / sims / steps
        loss = loss / steps
        g = torch.autograd.grad(loss, [leaves[k] for k in keys], allow_unused=True)
        for k, gi in zip(keys, g):
            if gi is not None:
                grads[k] += gi
        total += float(loss.detach())
    return total, grads, scale


def to_dtype(p: Params, dtype) -> Params:
    return {k: v.detach().to(dtype) for k, v in p.items()}
