"""Goemans-Williamson-style maxcut relaxation by a low-rank factorization
(counterpart of `rlsolver_tpu/classical/sdp.py`).

Burer-Monteiro: maximize sum_ij w_ij (1 - v_i . v_j) / 4 over unit vectors
v_i in R^k (k >= sqrt(2n) shares the SDP's optimum) by projected gradient
ascent, each step one [n, n] @ [n, k] matmul at full f32 precision (TF32
off, `device.resolve_device`), then random-hyperplane rounding of the
vectors, `num_roundings` hyperplanes at once."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from rlsolver_tpu_torch.core.graph import Graph
from rlsolver_tpu_torch.device import resolve_device
from rlsolver_tpu_torch.ops import cut as cut_ops


@dataclasses.dataclass
class SDPConfig:
    rank: int = 0  # 0 -> ceil(sqrt(2n)) rounded up to 8
    num_iters: int = 300
    lr: float = 0.1
    num_roundings: int = 256
    seed: int = 0


def sdp_rank(n: int, cfg: SDPConfig) -> int:
    return cfg.rank or max(8, int(np.ceil(np.sqrt(2 * n) / 8)) * 8)


def optimize(adj: torch.Tensor, v: torch.Tensor, step: float, num_iters: int) -> torch.Tensor:
    """`num_iters` projected ascent steps from unit rows v [n, k]."""
    for _ in range(num_iters):
        grad = -(adj @ v)  # the ascent direction of -1/4 sum w_ij v_i . v_j, up to a factor
        grad = grad - torch.sum(grad * v, dim=1, keepdim=True) * v  # tangent projection: a rotation
        v = v + step * grad
        v = v / torch.linalg.norm(v, dim=1, keepdim=True)
    return v


def sdp_maxcut(graph: Graph, cfg: SDPConfig = SDPConfig(), device=None, v0: Optional[torch.Tensor] = None,
               h: Optional[torch.Tensor] = None) -> Tuple[np.ndarray, float]:
    """Returns (best bits, best cut). `v0` [n, k] (normal draws, normalized
    here) and the hyperplanes `h` [num_roundings, k] replace the
    generator's."""
    dev = resolve_device(device)
    n = graph.num_nodes
    k = sdp_rank(n, cfg)
    cg = cut_ops.CutGraph.build(graph, dev)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    # the step scaled by the spectral-radius bound (max weighted degree): a
    # fixed step turns the update into power iteration on (I - lr A) and
    # collapses every v_i onto the Perron vector on dense graphs
    max_deg = float(np.abs(graph.weighted_degrees()).max(initial=0.0)) or 1.0
    step = cfg.lr * 8.0 / max_deg
    v0 = torch.randn(n, k, generator=gen, device=dev) if v0 is None else torch.as_tensor(v0, device=dev)
    if h is None:
        h = torch.randn(cfg.num_roundings, k, generator=gen, device=dev)
    v0 = v0 / torch.linalg.norm(v0, dim=1, keepdim=True)
    v = optimize(cg.adj, v0, step, cfg.num_iters)
    bits = (v @ torch.as_tensor(h, device=dev).T).T > 0  # [R, n]
    vs = cut_ops.cut_dense(bits, cg)
    i = int(torch.argmax(vs))
    return bits[i].cpu().numpy(), float(vs[i])
