"""Pattern-II batched maxcut environment (counterpart of
`rlsolver_tpu/envs/maxcut.py`).

State is `xs: bool [num_sims, num_nodes]`. The objective is one matmul
(dense) or an edge gather (sparse), see `ops/cut.py`. `local_search` is the
reference's `local_search_inplace` (`env_L2A.py:87-116` in RLSolver): noisy
top-k multi-flips with elitist accepts, then a greedy 1-flip sweep.

`sweep_1flip` runs a packed kernel when the env is built with
`packed_sweep=True`, as `engine.FlipSweepEngine` picks: K5 (one warp a chain
over each node's signed neighbour list, level by level of a schedule, from a
copy of the table in shared memory) on sparse {0, +-1}-weight graphs whose
table fits a block's shared memory; else K8a (one warp a chain over each
row's non-zero bit-plane words) where rows are dense, or K8b (K5's walk over
{j, w} lists in device memory). Otherwise
(no `packed_sweep`, or weights `weight_fault` refuses: not integers,
|w| >= 2^15, or no edges) it runs
the f32 sweep with rank-1 gain updates, as the JAX package does: on the card
the kernel K10 (`ops/kernels/sweep_kernel.py`), which walks each accepted
flip's neighbour list (`F32AdjLists`, built once with the env), on the CPU
its plain loop. The packed and f32 sweeps are bit-identical on integer
weights.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from rlsolver_tpu_torch.core.graph import Graph
from rlsolver_tpu_torch.device import resolve_device
from rlsolver_tpu_torch.ops import cut as cut_ops
from rlsolver_tpu_torch.ops.kernels.engine import FlipSweepEngine
from rlsolver_tpu_torch.ops.kernels.sweep_kernel import F32AdjLists, sweep_1flip_f32
from rlsolver_tpu_torch.ops.kernels.weighted_sweep import weight_fault
from rlsolver_tpu_torch.ops.reductions import update_xs_by_vs


class MaxcutEnv:
    """Static per-instance tensors on one device + batched methods. The
    device is `cuda` unless the caller passes `device="cpu"`."""

    def __init__(self, graph: Graph, device=None, mode: str = "auto", packed_sweep: bool = False):
        self.graph = graph
        self.num_nodes = graph.num_nodes
        self.device = resolve_device(device)
        self.mode = mode
        self.cg = cut_ops.CutGraph.build(graph, self.device, with_dense=mode != "sparse")
        self.flip_engine: Optional[FlipSweepEngine] = None
        if packed_sweep and weight_fault(graph.weights) is None:  # else the f32 sweep, as in the JAX package
            self.flip_engine = FlipSweepEngine.build(graph, self.device)
        self.f32_lists: Optional[F32AdjLists] = None  # K10's lists, for the f32 sweep
        if self.flip_engine is None and self.cg.adj is not None:
            self.f32_lists = F32AdjLists.build(self.cg.adj)

    def random_xs(self, gen: torch.Generator, num_sims: int) -> torch.Tensor:
        """Uniform random bits with node 0 pinned to 0 (breaks the cut symmetry)."""
        xs = torch.rand(num_sims, self.num_nodes, generator=gen, device=self.device) < 0.5
        xs[:, 0] = False
        return xs

    def obj(self, xs: torch.Tensor) -> torch.Tensor:
        """Cut values, f32 [B] (integral for integer-weight graphs)."""
        return cut_ops.cut_value(xs, self.cg, self.mode)

    def gains(self, xs: torch.Tensor) -> torch.Tensor:
        """Per-node flip gains, f32 [B, N]."""
        return cut_ops.flip_gains(xs, self.cg, self.mode)

    def node_contrib(self, xs: torch.Tensor) -> torch.Tensor:
        """Per-node cut contributions, f32 [B, N] (the slow twin's
        `calculate_obj_values_for_loop` by node)."""
        if self.cg.adj is not None and self.mode != "sparse":
            return cut_ops.node_cut_contrib_dense(xs, self.cg)
        return cut_ops.node_cut_contrib_sparse(xs, self.cg)

    def local_search(
        self,
        gen: torch.Generator,
        xs: torch.Tensor,
        vs: Optional[torch.Tensor] = None,
        num_iters: int = 8,
        num_spin: int = 8,
        noise_std: float = 0.3,
        noise: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Noisy multi-flip phase, then one greedy 1-flip sweep. The
        standard normals (the threshold's, then each iteration's) come from
        `gen` unless `noise` f32 [num_iters + 1, B, N] gives them."""
        if vs is None:
            vs = self.obj(xs)
        gains = self.gains(xs)
        # per-node spread across sims, as in the reference
        rng_std = (gains.max(dim=0, keepdim=True).values - gains.min(dim=0, keepdim=True).values) * noise_std

        def noisy(i):
            z = torch.randn(gains.shape, generator=gen, device=gains.device) if noise is None else noise[i].to(gains)
            return gains + z * rng_std

        k_small = self.num_nodes - num_spin  # torch.kthvalue is 1-based smallest
        thresh = torch.sort(noisy(0), dim=1).values[:, k_small - 1][:, None]
        for i in range(num_iters):
            xs_try = torch.logical_xor(xs, noisy(i + 1) > thresh)
            xs, vs = update_xs_by_vs(xs, vs, xs_try, self.obj(xs_try))
        return self.sweep_1flip(xs, vs)

    def sweep_1flip(self, xs: torch.Tensor, vs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """One greedy sequential 1-flip sweep over all nodes (ascending),
        strict improvements only. Sign convention: bit 1 -> sign +1."""
        if self.flip_engine is not None:
            out = self.flip_engine.sweep(xs)
            return out, self.obj(out)
        if self.cg.adj is None:
            raise NotImplementedError("sweep_1flip needs the dense adjacency")
        s, _, vs = sweep_1flip_f32(self.cg.adj, cut_ops.signs_from_bits(xs), self.gains(xs), vs, self.f32_lists)
        return s > 0.0, vs
