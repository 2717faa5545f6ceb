"""The greedy 1-flip sweep with f32 incremental gains (counterpart of
`rlsolver_tpu/ops/pallas/sweep_kernel.py:sweep_1flip_pallas`, K10).

One sweep over the nodes in ascending order: at node i every chain flips
when its gain is strictly positive, and all its gains take the rank-1 update
of adjacency row i. This is the sweep of `MaxcutEnv.sweep_1flip` for weights
that the packed kernels K5/K8 do not take (non-integers, |w| >= 2^15), and
for every env built without `packed_sweep`: the local search of L2A, of the
parallel local-search solver and of MCPG's warm start without `--fast`.

`sweep_1flip_f32(adj, s, gains, vs)` takes the Pallas kernel's arguments
(adj f32 [N, N], s +-1 f32 [B, N], gains f32 [B, N], vs f32 [B]) without its
block size and lane padding, and returns new (s, gains, vs). On a CUDA
tensor it launches the kernel of `csrc/sweep_1flip_f32.cu`; on a CPU tensor
it runs the plain loop below. The two give the same values: s and vs bit for
bit, gains up to the sign of a zero (see the kernel's notes).
"""

from __future__ import annotations

from typing import Tuple

import torch

from rlsolver_tpu_torch.ops.kernels.build import Kernel, check_cuda_tensor, register

SWEEP_1FLIP_F32 = register(Kernel(
    "sweep_1flip_f32", "sweep_1flip_f32.cu", "sweep_1flip_f32", "ppppii",
    replaces="rlsolver_tpu/ops/pallas/sweep_kernel.py:71 _sweep_kernel",
))


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
    adj: torch.Tensor, s: torch.Tensor, gains: torch.Tensor, vs: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One greedy 1-flip sweep -> (s, gains, vs) after it."""
    if not s.is_cuda:
        return sweep_1flip_f32_plain(adj, s, gains, vs)
    b, n = s.shape
    s, gains, vs = (t.clone(memory_format=torch.contiguous_format) for t in (s, gains, vs))
    check_cuda_tensor(adj, "adj", torch.float32, (n, n))
    check_cuda_tensor(s, "s", torch.float32, (b, n))
    check_cuda_tensor(gains, "gains", torch.float32, (b, n))
    check_cuda_tensor(vs, "vs", torch.float32, (b,))
    SWEEP_1FLIP_F32.launch(adj, s, gains, vs, b, n)
    return s, gains, vs
