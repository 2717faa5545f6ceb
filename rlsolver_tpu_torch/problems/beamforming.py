"""MIMO downlink beamforming: sum-rate precoders, ZF/MMSE baselines, a
two-hop relay and a trained refinement policy (counterpart of
`rlsolver_tpu/problems/beamforming.py`; RLSolver
`methods_problem_specific/mimo_beamforming/`: `env_mimo.py`, `baseline_zf_mmse.py`,
`baseline_mmse.py`, `net_mimo.py`, `train_reinforce_mimo.py`, `env_mimo_relay.py`).

Complex tensors are native `torch.complex64`, and the Hermitian inverses
of ZF and MMSE are `torch.linalg.inv`. (The JAX package carries (re, im)
pairs and inverts by Newton-Schulz because its TPU backend has neither
complex dtypes nor LAPACK; the two agree to the Newton-Schulz iteration's
accuracy, not bit for bit.) `from_numpy`/`to_numpy` move numpy complex
arrays in and out. The policy sees the concatenated real and imaginary
parts, so a flax `PrecoderPolicy`'s weights carry over
(`convert.precoder_state_dict`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from rlsolver_tpu_torch.device import resolve_device
from rlsolver_tpu_torch.models.transformer import Dense
from rlsolver_tpu_torch.optim import ClippedAdam

_INV_SQRT2 = np.float32(1.0 / np.sqrt(2.0))


def from_numpy(z: np.ndarray, device=None) -> torch.Tensor:
    """numpy complex -> complex64 tensor (on the CPU unless `device`)."""
    return torch.from_numpy(np.asarray(z, np.complex64)).to("cpu" if device is None else device)


def to_numpy(z: torch.Tensor) -> np.ndarray:
    return z.detach().cpu().numpy()


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


@dataclasses.dataclass(frozen=True)
class BeamformingSpec:
    num_users: int = 4  # K
    num_antennas: int = 4  # N
    total_power: float = 10.0
    noise_power: float = 1.0


def complex_normal(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """(re + i im) / sqrt(2) from two standard normal tensors."""
    return torch.complex(re * _INV_SQRT2, im * _INV_SQRT2)


def random_channels(gen: Optional[torch.Generator], spec: BeamformingSpec, batch: int, device=None,
                    normal: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """H complex64 [B, K, N], unit-average-power Rayleigh: its real and
    imaginary standard normals from `gen` (on `device`, by default `cuda`)
    unless `normal` gives them."""
    if normal is None:
        dev = resolve_device(device)
        shape = (batch, spec.num_users, spec.num_antennas)
        normal = (torch.randn(shape, generator=gen, device=dev), torch.randn(shape, generator=gen, device=dev))
    return complex_normal(*normal)


def sum_rate(h: torch.Tensor, w: torch.Tensor, noise_power: float = 1.0) -> torch.Tensor:
    """Downlink sum rate f32 [B] of H [B, K, N] under W [B, N, K]
    (`MIMOEnv.get_reward`, `env_mimo.py:49-56`)."""
    p = torch.einsum("bkn,bnj->bkj", h, w).abs().square()
    sig = torch.diagonal(p, dim1=1, dim2=2)
    interf = p.sum(dim=2) - sig
    return torch.log2(1.0 + sig / (interf + noise_power)).sum(dim=1)


def normalize_power(w: torch.Tensor, total_power: float) -> torch.Tensor:
    p = w.abs().square().sum(dim=(1, 2), keepdim=True)
    return w * torch.sqrt(total_power / torch.clamp(p, min=1e-12))


def zf_beamformer(h: torch.Tensor, spec: BeamformingSpec) -> torch.Tensor:
    """Zero forcing, W = H^H (H H^H + 1e-4 I)^-1, power-normalised."""
    hh = torch.einsum("bkn,bjn->bkj", h, h.conj()) + 1e-4 * _eye(spec.num_users, h)
    return normalize_power(torch.einsum("bkn,bkj->bnj", h.conj(), torch.linalg.inv(hh)), spec.total_power)


def mmse_beamformer(h: torch.Tensor, spec: BeamformingSpec) -> torch.Tensor:
    """MMSE (regularised ZF), W = (H^H H + K sigma^2 / P I)^-1 H^H,
    power-normalised (`baseline_mmse.py:compute_mmse_beamformer`)."""
    reg = spec.num_users * spec.noise_power / spec.total_power
    gram = torch.einsum("bkn,bkm->bnm", h.conj(), h) + reg * _eye(spec.num_antennas, h)
    return normalize_power(torch.einsum("bnm,bkm->bnk", torch.linalg.inv(gram), h.conj()), spec.total_power)


class PrecoderPolicy(nn.Module):
    """Refinement policy (H, W) -> W + a residual, power-normalised
    (`net_mimo.py:Policy_Net_MIMO` capability, MLP form); flax's names
    `Dense_0` .. `Dense_2`, initialised as flax does from a seeded CPU
    generator."""

    def __init__(self, spec: BeamformingSpec, hidden: int = 256, seed: int = 0):
        super().__init__()
        self.spec = spec
        nk = spec.num_antennas * spec.num_users
        gen = torch.Generator().manual_seed(seed)
        self.Dense_0 = Dense(4 * nk, hidden, gen)
        self.Dense_1 = Dense(hidden, hidden, gen)
        self.Dense_2 = Dense(hidden, 2 * nk, gen)

    def forward(self, h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        b = h.shape[0]
        feat = torch.cat([h.real.reshape(b, -1), h.imag.reshape(b, -1), w.real.reshape(b, -1),
                          w.imag.reshape(b, -1)], dim=1)
        x = torch.relu(self.Dense_1(torch.relu(self.Dense_0(feat))))
        nk = self.spec.num_antennas * self.spec.num_users
        out = self.Dense_2(x) * 0.1
        shape = (b, self.spec.num_antennas, self.spec.num_users)
        return normalize_power(w + torch.complex(out[:, :nk].reshape(shape), out[:, nk:].reshape(shape)),
                               self.spec.total_power)


# ------------------------------------------------------------------- relay
@dataclasses.dataclass(frozen=True)
class RelaySpec:
    """Two-hop downlink: BS (N antennas) -> relay (M antennas) -> K users
    (`env_mimo_relay.py:MIMORelayEnv` capability)."""

    num_users: int = 2
    num_bs_antennas: int = 2
    num_relay_antennas: int = 2
    total_power: float = 10.0
    relay_power: float = 10.0
    noise_power: float = 1.0


def random_relay_channels(gen: Optional[torch.Generator], spec: RelaySpec, batch: int, device=None,
                          normal: Optional[Sequence[torch.Tensor]] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(G [B, M, N] BS -> relay, H [B, K, M] relay -> users), Rayleigh; the
    four standard normal tensors (G's real and imaginary parts, then H's)
    from `gen` (on `device`, by default `cuda`) unless `normal` gives them."""
    m, n, k = spec.num_relay_antennas, spec.num_bs_antennas, spec.num_users
    if normal is None:
        dev = resolve_device(device)
        normal = [torch.randn(s, generator=gen, device=dev) for s in ((batch, m, n),) * 2 + ((batch, k, m),) * 2]
    return complex_normal(normal[0], normal[1]), complex_normal(normal[2], normal[3])


def relay_effective_channel(h: torch.Tensor, f: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """H_eff = H F G [B, K, N] (`env_mimo_relay.py:43`)."""
    return h @ f @ g


def relay_sum_rate(h: torch.Tensor, f: torch.Tensor, g: torch.Tensor, spec: RelaySpec) -> torch.Tensor:
    """Sum rate of the two-hop link, the BS's MMSE beamformer computed on
    the effective channel."""
    heff = relay_effective_channel(h, f, g)
    bs_spec = BeamformingSpec(num_users=spec.num_users, num_antennas=spec.num_bs_antennas,
                              total_power=spec.total_power, noise_power=spec.noise_power)
    return sum_rate(heff, mmse_beamformer(heff, bs_spec), spec.noise_power)


def identity_relay(spec: RelaySpec, batch: int, device=None) -> torch.Tensor:
    """The power-normalised identity amplification baseline [B, M, M] (on
    `device`, by default `cuda`)."""
    m = spec.num_relay_antennas
    f = torch.eye(m, dtype=torch.complex64, device=resolve_device(device)).expand(batch, m, m)
    return normalize_power(f, spec.relay_power)


# ---------------------------------------------------------------- training
@dataclasses.dataclass
class BeamformingTrainConfig:
    batch: int = 256
    episode_length: int = 6
    num_steps: int = 300
    lr: float = 1e-3
    curriculum_start: int = 2  # growing-subspace curriculum dimension
    seed: int = 0


class StepDraws(NamedTuple):
    """A training step's standard normals: the full channel's real and
    imaginary parts [B, K, N] and the curriculum's coordinates [B, 2 K N]."""

    re: torch.Tensor
    im: torch.Tensor
    coords: torch.Tensor


def curriculum_basis(spec: BeamformingSpec, seed: int) -> np.ndarray:
    """The static orthonormal basis of the growing-subspace curriculum
    (`generate_channel_batch`, `env_mimo.py:43-47`): Q of a host QR of a
    seeded uniform matrix, as f32."""
    full = 2 * spec.num_users * spec.num_antennas
    return np.linalg.qr(np.random.RandomState(seed).rand(full, full))[0].astype(np.float32)


def train_beamforming(spec: BeamformingSpec = BeamformingSpec(),
                      cfg: BeamformingTrainConfig = BeamformingTrainConfig(), device=None,
                      policy: Optional[PrecoderPolicy] = None, draws: Optional[Sequence[StepDraws]] = None,
                      timings: Optional[list] = None) -> Tuple[PrecoderPolicy, List[float]]:
    """Direct-gradient training of the refinement policy through the
    `episode_length`-step episode from MMSE (`train_reinforce_mimo.py`),
    loss = -mean(sum rate of the last step), Adam (lr), with the channels
    of a `subspace_dim`-dimensional subspace of the curriculum basis until
    it is full (one more dimension every num_steps // (2 K N) steps). Step
    s's draws come from `draws[s]` where given, else from a generator
    seeded with cfg.seed. Returns (policy, history of each step's mean
    rate). `timings`, where given, collects each step's seconds (ending in
    a wait for the device)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed)
    full = 2 * spec.num_users * spec.num_antennas
    kn = spec.num_users * spec.num_antennas
    basis = torch.from_numpy(curriculum_basis(spec, cfg.seed)).to(dev)
    policy = (policy if policy is not None else PrecoderPolicy(spec, seed=cfg.seed)).to(dev)
    opt = ClippedAdam(policy.parameters(), cfg.lr, max_norm=None)
    shape = (cfg.batch, spec.num_users, spec.num_antennas)
    keep = torch.arange(full, device=dev)

    def channels(d: StepDraws, dim: int) -> torch.Tensor:
        if dim >= full:
            return complex_normal(d.re, d.im)
        coords = d.coords * (keep < dim)
        vec = coords @ basis * np.float32(np.sqrt(full / max(dim, 1)))
        vec = vec / torch.linalg.vector_norm(vec, dim=1, keepdim=True) * np.float32(np.sqrt(kn))
        return torch.complex(vec[:, :kn].reshape(shape), vec[:, kn:].reshape(shape))

    history = []
    subspace_dim = cfg.curriculum_start
    for it in range(cfg.num_steps):
        t0 = time.time()
        if draws is not None:
            d = StepDraws(*(x.to(dev) for x in draws[it]))
        else:
            d = StepDraws(torch.randn(shape, generator=gen, device=dev), torch.randn(shape, generator=gen, device=dev),
                          torch.randn(cfg.batch, full, generator=gen, device=dev))
        h = channels(d, subspace_dim)
        w = mmse_beamformer(h, spec)
        for _ in range(cfg.episode_length):
            w = policy(h, w)
        mean_rate = sum_rate(h, w, spec.noise_power).mean()
        opt.zero_grad()
        (-mean_rate).backward()
        opt.step()
        history.append(float(mean_rate.detach()))  # waits for the step
        if timings is not None:
            timings.append(time.time() - t0)
        if (it + 1) % max(1, cfg.num_steps // full) == 0:
            subspace_dim = min(subspace_dim + 1, full)
    return policy, history
