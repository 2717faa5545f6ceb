"""The greedy 1-flip sweep with f32 incremental gains (counterpart of
`rlsolver_tpu/ops/pallas/sweep_kernel.py:sweep_1flip_pallas`, K10).

One sweep over the nodes in ascending order: at node i every chain flips
when its gain is strictly positive, and all its gains take the rank-1 update
of adjacency row i. This is the sweep of `MaxcutEnv.sweep_1flip` for weights
that the packed kernels K5/K8 do not take (non-integers, |w| >= 2^15), and
for every env built without `packed_sweep`: the local search of L2A, of the
parallel local-search solver and of MCPG's warm start without `--fast`.

`sweep_1flip_f32(adj, s, gains, vs, lists=None)` takes the Pallas kernel's
arguments (adj f32 [N, N], s +-1 f32 [B, N], gains f32 [B, N], vs f32 [B])
without its block size and lane padding, and returns new (s, gains, vs). On
a CUDA tensor it launches the kernel of `csrc/sweep_1flip_f32.cu`, which
reads each accepted flip's row as a neighbour list (`lists`, the
`F32AdjLists` of `adj`, built once by the caller and required there); on a
CPU tensor it runs the plain loop below, which reads `adj`. The two give
the same values: s and vs bit for bit, gains up to the sign of a zero (see
the kernel's notes).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from rlsolver_tpu_torch.ops.kernels.build import Kernel, check_cuda_tensor, register

SWEEP_1FLIP_F32 = register(Kernel(
    "sweep_1flip_f32", "sweep_1flip_f32.cu", "sweep_1flip_f32", "pppppii",
    replaces="rlsolver_tpu/ops/pallas/sweep_kernel.py:71 _sweep_kernel",
))


class F32AdjLists(NamedTuple):
    """The non-zero entries of an f32 adjacency, row by row: row i's entries
    are entries[offsets[i]:offsets[i + 1]], one {j, A[i, j] as f32 bits} per
    non-zero A[i, j], in ascending j. Built from the dense matrix, so each
    weight is A[i, j] bit for bit (duplicate edges already summed)."""

    offsets: torch.Tensor  # [N + 1] int32
    entries: torch.Tensor  # [E, 2] int32 {j, f32 bits}

    @staticmethod
    def build(adj: torch.Tensor) -> "F32AdjLists":
        """From adj f32 [N, N], on its device."""
        n = adj.shape[0]
        rows, cols = torch.nonzero(adj, as_tuple=True)  # row-major: ascending j within a row
        offsets = torch.zeros(n + 1, dtype=torch.int64, device=adj.device)
        offsets[1:] = torch.cumsum(torch.bincount(rows, minlength=n), 0)
        weights = adj[rows, cols].contiguous().view(torch.int32)
        return F32AdjLists(offsets.to(torch.int32), torch.stack([cols.to(torch.int32), weights], dim=1).contiguous())


def sweep_1flip_f32_plain(
    adj: torch.Tensor, s: torch.Tensor, gains: torch.Tensor, vs: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the K10 kernel: one [B, N] rank-1 update per node."""
    s, gains, vs = s.clone(), gains.clone(), vs.clone()
    for i in range(s.shape[1]):
        g_i = gains[:, i].clone()
        accept = g_i > 0.0
        s_i = s[:, i].clone()
        gains += -2.0 * (s_i * accept)[:, None] * s * adj[i][None, :]
        gains[:, i] = torch.where(accept, -g_i, g_i)
        s[:, i] = torch.where(accept, -s_i, s_i)
        vs += torch.where(accept, g_i, 0.0)
    return s, gains, vs


def sweep_1flip_f32(
    adj: torch.Tensor,
    s: torch.Tensor,
    gains: torch.Tensor,
    vs: torch.Tensor,
    lists: Optional[F32AdjLists] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One greedy 1-flip sweep -> (s, gains, vs) after it. `lists` are
    `F32AdjLists.build(adj)`; the kernel needs them, the plain loop not."""
    if not s.is_cuda:
        return sweep_1flip_f32_plain(adj, s, gains, vs)
    b, n = s.shape
    s, gains, vs = (t.clone(memory_format=torch.contiguous_format) for t in (s, gains, vs))
    check_cuda_tensor(adj, "adj", torch.float32, (n, n))
    check_cuda_tensor(s, "s", torch.float32, (b, n))
    check_cuda_tensor(gains, "gains", torch.float32, (b, n))
    check_cuda_tensor(vs, "vs", torch.float32, (b,))
    if lists is None:
        raise ValueError("the kernel reads F32AdjLists.build(adj): pass them as `lists`")
    check_cuda_tensor(lists.offsets, "offsets", torch.int32, (n + 1,))
    check_cuda_tensor(lists.entries, "entries", torch.int32, (lists.entries.shape[0], 2))
    if lists.entries.data_ptr() % 8:
        raise ValueError("entries must be 8-byte aligned (the kernel reads an entry in one 8-byte load)")
    SWEEP_1FLIP_F32.launch(lists.offsets, lists.entries, s, gains, vs, b, n)
    return s, gains, vs
