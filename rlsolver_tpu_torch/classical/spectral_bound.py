"""Certified spectral (Poljak-Rendl) maxcut upper bound (counterpart of
`rlsolver_tpu/classical/spectral_bound.py`).

For x in {-1, +1}^n and any correcting vector u,
    cut(x) = (1/4) x^T (L + diag(u)) x - (1/4) sum(u)
           <= (n/4) lambda_max(L + diag(u)) - (1/4) sum(u),
with L the weighted Laplacian. The bound is minimized over u by smoothed
subgradient descent on the top `block_size` Ritz pairs (softmax weights
exp(lambda_j / mu), mu annealed). The block power iteration runs on the
device (`torch.matmul`, f32 at full precision); the k x k Rayleigh-Ritz
runs on the host in float64, as in the JAX package, so both take the same
steps. Power iteration approaches lambda_max from below, so the returned
bound is certified on the host in float64 by the trace-power inequality
lambda_max(M') <= trace(M'^{2k})^{1/(2k)} (M' = M + cI made psd by a
Gershgorin shift), by repeated squaring; the slack is at most n^{1/(2k)}.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from rlsolver_tpu_torch.core.graph import Graph
from rlsolver_tpu_torch.device import resolve_device


@dataclasses.dataclass
class SpectralBoundConfig:
    opt_iters: int = 1500  # smoothed-subgradient steps on u
    block_size: int = 16  # Ritz subspace width (eigenvalue multiplicity)
    power_iters: int = 3  # block-power multiplies between Rayleigh-Ritz steps
    lr: float = 2.0  # base step size (scaled by a 1/sqrt decay)
    mu0: float = 1.0  # initial smoothing temperature (halved on schedule)
    mu_halvings: int = 6
    certify_squarings: int = 10  # k = 2^squarings trace power
    seed: int = 0


def _laplacian(graph: Graph) -> np.ndarray:
    a = graph.adjacency_dense(dtype=np.float64)
    return np.diag(a.sum(axis=1)) - a


def certify_lambda_max(m: np.ndarray, squarings: int = 10) -> float:
    """Rigorous float64 upper bound on lambda_max(m) for symmetric m via
    the trace-power inequality with a Gershgorin psd shift."""
    n = m.shape[0]
    diag = np.diag(m)
    offsum = np.abs(m).sum(axis=1) - np.abs(diag)
    lam_min_lower = float(np.min(diag - offsum))  # Gershgorin
    c = max(0.0, -lam_min_lower)
    mp = m + c * np.eye(n)
    # repeated squaring with log-scale normalization:
    # track  M_true^k = exp(a) * mk  with ||mk||_F == 1
    s = float(np.linalg.norm(mp))
    if s == 0.0:
        return -c
    mk = mp / s
    a = np.log(s)
    k = 1
    for _ in range(squarings):
        mk = mk @ mk
        k *= 2
        s = float(np.linalg.norm(mk))
        mk /= s
        a = 2.0 * a + np.log(s)
    # trace(M_true^{2k}) = ||M_true^k||_F^2 = exp(2a)  (||mk||_F == 1)
    # lambda_max(M') <= trace(M'^{2k})^{1/(2k)} = exp(a / k)
    # inflate by the accumulated matmul rounding (n*eps per squaring)
    fudge = 1.0 + 4.0 * n * np.finfo(np.float64).eps * squarings
    return float(np.exp(a / k)) * fudge - c


def certified_bound(lap64: np.ndarray, u: np.ndarray, squarings: int) -> float:
    """Certified maxcut bound for a given correcting vector u (float64)."""
    n = lap64.shape[0]
    lam = certify_lambda_max(lap64 + np.diag(u), squarings)
    return (n / 4.0) * lam - float(u.sum()) / 4.0


def _shifted(laps: torch.Tensor, u: torch.Tensor, scale: torch.Tensor):
    """M = L + diag(u) [..., n, n] and the shift that makes its algebraically
    largest eigenvalues dominate a block power iteration: the Gershgorin
    lower bound on lambda_min, plus 1e-3 of the scale."""
    m = laps + torch.diag_embed(u)
    diag = torch.diagonal(m, dim1=-2, dim2=-1)
    offsum = torch.sum(torch.abs(m), dim=-1) - torch.abs(diag)
    shift = torch.clamp(-torch.min(diag - offsum, dim=-1).values, min=0.0) + 1e-3 * scale
    return m, shift


def _block_power(m: torch.Tensor, shift: torch.Tensor, v: torch.Tensor, iters: int) -> torch.Tensor:
    """`iters` multiplies of v [..., n, k] by M + shift I, each column normalized."""
    for _ in range(iters):
        w = m @ v + shift[..., None, None] * v
        v = w / (torch.linalg.norm(w, dim=-2, keepdim=True) + 1e-30)
    return v


def maxcut_upper_bound(graph: Graph, cfg: SpectralBoundConfig = SpectralBoundConfig(), record=None,
                       device=None) -> Tuple[float, dict]:
    """Returns (certified upper bound on the maxcut, info): info carries the
    uncertified (Ritz) estimate, the trivial u = 0 bound and the final u."""
    dev = resolve_device(device)
    n = graph.num_nodes
    lap64 = _laplacian(graph)
    lap = torch.tensor(lap64, dtype=torch.float32, device=dev)
    scale = float(np.abs(np.diag(lap64)).mean()) or 1.0
    k = min(cfg.block_size, n)

    rng = np.random.default_rng(cfg.seed)
    v_block = torch.tensor(rng.normal(size=(n, k)), dtype=torch.float32, device=dev)
    u = torch.zeros(n, dtype=torch.float32, device=dev)

    mu = cfg.mu0 * scale * 0.25
    halve_every = max(1, cfg.opt_iters // (cfg.mu_halvings + 1))
    est = np.inf
    u_np = np.zeros(n)
    scale_t = torch.tensor(scale, dtype=torch.float32, device=dev)
    for i in range(cfg.opt_iters):
        m, shift = _shifted(lap, u, scale_t)
        v_block = _block_power(m, shift, v_block, cfg.power_iters)
        # host Rayleigh-Ritz in float64
        vb = v_block.cpu().numpy().astype(np.float64)
        q, _ = np.linalg.qr(vb)
        mq = lap64 @ q + u_np[:, None] * q  # (L + diag(u)) q without [N, N]
        t = q.T @ mq
        lam, y = np.linalg.eigh((t + t.T) / 2.0)
        z = q @ y  # Ritz vectors [n, k]
        w = np.exp((lam - lam[-1]) / mu)
        w /= w.sum()
        grad = (n / 4.0) * (z**2 @ w) - 0.25
        # plain SGD with a 1/sqrt decay (the JAX package measured Adam to stall here)
        lr = cfg.lr / np.sqrt(1.0 + i / 20.0)
        u_np = u_np - lr * grad
        u = torch.tensor(u_np, dtype=torch.float32, device=dev)
        v_block = torch.tensor(q, dtype=torch.float32, device=dev)
        est = (n / 4.0) * lam[-1] - u_np.sum() / 4.0
        if record is not None:
            record(i, est)
        if (i + 1) % halve_every == 0:
            mu *= 0.5

    cert = certified_bound(lap64, u_np, cfg.certify_squarings)
    best_cert, best_u = cert, u_np
    # u = 0 fallback (never worse than the trivial spectral bound)
    cert0 = certified_bound(lap64, np.zeros(n), cfg.certify_squarings)
    if cert0 < best_cert:
        best_cert, best_u = cert0, np.zeros(n)
    return float(best_cert), {"estimate": est, "trivial_bound": cert0, "u": best_u}


def maxcut_upper_bound_cell(graphs: Sequence[Graph], cfg: SpectralBoundConfig = SpectralBoundConfig(),
                            device=None) -> list:
    """Certified bounds for a cell of same-size instances at once: the block
    power iteration and the projections run on [G, n, n] Laplacians (a
    leading instance axis), only the [G, k, k] Gram and projected matrices
    go to the host each iteration, whose Cholesky-QR Rayleigh-Ritz loops
    over the instances; each bound is certified on the host in float64.
    Returns the list of certified bounds."""
    dev = resolve_device(device)
    g_cnt = len(graphs)
    n = graphs[0].num_nodes
    k = min(cfg.block_size, n)
    laps64 = [_laplacian(g) for g in graphs]
    laps = torch.tensor(np.stack(laps64), dtype=torch.float32, device=dev)
    scales = np.array([float(np.abs(np.diag(lap)).mean()) or 1.0 for lap in laps64])
    scale = torch.tensor(scales, dtype=torch.float32, device=dev)

    rng = np.random.default_rng(cfg.seed)
    v_block = torch.tensor(rng.normal(size=(g_cnt, n, k)), dtype=torch.float32, device=dev)
    u = torch.zeros(g_cnt, n, dtype=torch.float32, device=dev)
    mus = scales * cfg.mu0 * 0.25
    halve_every = max(1, cfg.opt_iters // (cfg.mu_halvings + 1))
    eye = np.eye(k)

    for i in range(cfg.opt_iters):
        # device: block power, then the Gram matrix S = V^T V and T0 = V^T M V
        m, shift = _shifted(laps, u, scale)
        v_block = _block_power(m, shift, v_block, cfg.power_iters)
        vt = v_block.transpose(-1, -2)
        st = torch.stack([vt @ v_block, vt @ (m @ v_block)]).cpu().numpy().astype(np.float64)
        cs = np.empty((g_cnt, k, k))
        ps = np.empty((g_cnt, k, k))
        collapsed = []
        for g in range(g_cnt):
            # Cholesky QR: v c is orthonormal for c = R^-1, S = R^T R
            s_g = st[0, g] + 1e-10 * np.trace(st[0, g]) / k * eye
            try:
                r = np.linalg.cholesky(s_g).T
                c = np.linalg.solve(r, eye)
            except np.linalg.LinAlgError:
                # a collapsed block: the raw block this iteration, a fresh
                # random one next (the certificate never depends on this)
                c = eye.copy()
                collapsed.append(g)
            t = c.T @ st[1, g] @ c
            lam, y = np.linalg.eigh((t + t.T) / 2.0)
            w = np.exp((lam - lam[-1]) / mus[g])
            w /= w.sum()
            cs[g] = c
            ps[g] = c @ (y * np.sqrt(w)[None, :])  # sqrt-weighted Ritz directions
        lr = cfg.lr / np.sqrt(1.0 + i / 20.0)
        if collapsed:  # re-randomize the collapsed blocks, keep u
            fresh = rng.normal(size=(len(collapsed), n, k))
            v_block[torch.tensor(collapsed, device=dev)] = torch.tensor(fresh, dtype=torch.float32, device=dev)
        # device: the smoothed subgradient step on u, and V <- V c
        z_w = v_block @ torch.tensor(ps, dtype=torch.float32, device=dev)
        grad = (n / 4.0) * torch.sum(z_w * z_w, dim=-1) - 0.25
        u = u - torch.tensor(lr, dtype=torch.float32) * grad
        v_block = v_block @ torch.tensor(cs, dtype=torch.float32, device=dev)
        if (i + 1) % halve_every == 0:
            mus *= 0.5

    u_np = u.cpu().numpy().astype(np.float64)
    # certified for any u (no u = 0 fallback: it is looser once the descent
    # made progress, and the float64 trace power dominates the host's time)
    return [certified_bound(laps64[g], u_np[g], cfg.certify_squarings) for g in range(g_cnt)]
