"""Steepest-ascent 1-flip greedy for maxcut, batched over starts
(counterpart of `rlsolver_tpu/classical/greedy.py:greedy_maxcut`).

Each step every start takes its best single flip while that flip gains;
the gains follow by a rank-1 update of the flipped node's adjacency row.
JAX's `lax.while_loop` becomes a Python loop whose steps carry a device
mask `do` (the starts that still improve), and the loop's condition is
read on the host once every CHECK_EVERY steps: a step where `do` is
false everywhere changes nothing, so the result is the JAX package's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from rlsolver_tpu_torch.core.graph import Graph
from rlsolver_tpu_torch.device import resolve_device
from rlsolver_tpu_torch.ops import cut as cut_ops

CHECK_EVERY = 16  # steps between host reads of the loop's condition


def greedy_maxcut(graph: Graph, num_starts: int = 1, generator: Optional[torch.Generator] = None,
                  device=None) -> Tuple[np.ndarray, float]:
    """Start 0 is all zeros (the reference's deterministic start); the rest
    are uniform random bits from `generator` (seeded 0 if None). Returns
    (best bits, best cut)."""
    dev = resolve_device(device)
    cg = cut_ops.CutGraph.build(graph, dev)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    xs = torch.rand(num_starts, graph.num_nodes, generator=generator, device=dev) < 0.5
    xs[0] = False
    s = cut_ops.signs_from_bits(xs)
    gains = cut_ops.flip_gains_dense(xs, cg)
    vs = cut_ops.cut_dense(xs, cg)
    rows = torch.arange(num_starts, device=dev)
    while bool((gains.max(dim=1).values > 0).any()):
        for _ in range(CHECK_EVERY):
            best = torch.argmax(gains, dim=1)
            g = gains[rows, best]
            do = g > 0  # only the starts that still improve
            s_b = s[rows, best]
            gains = gains + -2.0 * (s_b * do)[:, None] * s * cg.adj[best]
            gains[rows, best] = torch.where(do, -g, g)
            s[rows, best] = torch.where(do, -s_b, s_b)
            vs = vs + torch.where(do, g, 0.0)
    b = int(torch.argmax(vs))
    return (s[b] > 0).cpu().numpy(), float(vs[b])
