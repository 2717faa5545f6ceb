"""ISCO / PISCO: gradient-informed path-auxiliary MCMC (counterpart of
`rlsolver_tpu/algos/isco.py`).

  * proposal: `path_length` flips drawn without replacement from a softmax
    over the exact per-bit energy changes (Gumbel top-k, k per chain), made
    at once;
  * accept: path-auxiliary detailed balance, the forward and backward
    ordered no-replacement log-likelihoods in the MH ratio;
  * anneal: a linear temperature decay over the chain, and a Poisson path
    length steered to a 0.574 acceptance rate.

The chain is a Python loop of exactly `chain_length` steps (JAX's
`lax.scan`, which the JAX package splits into segments for a TPU link).
The sampler takes states with leading axes: [B, N] for one instance, or
[G, B, N] for a cell of G same-size instances, whose dense energy and gains
are batched matmuls. Every draw (the start bits, the Poisson path lengths,
the Gumbel uniforms and the accept uniforms) can be injected (`ISCODraws`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from rlsolver_tpu_torch.core.graph import Graph
from rlsolver_tpu_torch.core.result import write_graph_result
from rlsolver_tpu_torch.device import resolve_device
from rlsolver_tpu_torch.ops import cut as cut_ops
from rlsolver_tpu_torch.ops import objectives as dobj


# ---------------------------------------------------- no-replacement log-liks
CUMSUM_BLOCK = 16


def blocked_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Prefix sums along the last axis in the order of XLA's CPU cumsum, in
    f32: blocks of 16 summed left to right, then the blocks' totals
    prefixed the same way (recursively past 16 blocks) and added. The
    no-replacement log-likelihoods take log(1 - (prefix)) of prefixes near
    1, where a sum in another order moves the result by far more than an
    ulp; torch's own cumsum accumulates in another order (and in float64
    on the CPU)."""
    n = x.shape[-1]
    nb = -(-n // CUMSUM_BLOCK)
    xb = torch.nn.functional.pad(x, (0, nb * CUMSUM_BLOCK - n)).reshape(*x.shape[:-1], nb, CUMSUM_BLOCK)
    within = torch.empty_like(xb)
    within[..., 0] = xb[..., 0]
    for k in range(1, CUMSUM_BLOCK):
        within[..., k] = within[..., k - 1] + xb[..., k]
    totals = within[..., -1]
    if nb > CUMSUM_BLOCK:
        prefix = blocked_cumsum(totals)
    else:
        prefix = torch.empty_like(totals)
        prefix[..., 0] = totals[..., 0]
        for k in range(1, nb):
            prefix[..., k] = prefix[..., k - 1] + totals[..., k]
    within[..., 1:, :] += prefix[..., :-1, None]
    return within.reshape(*x.shape[:-1], nb * CUMSUM_BLOCK)[..., :n]


def log1mexp(x: torch.Tensor) -> torch.Tensor:
    """log(1 - exp(-|x|)), both branches evaluated as in the JAX package."""
    x = -torch.abs(x)
    return torch.where(x > -0.693, torch.log(-torch.expm1(x)), torch.log1p(-torch.exp(x)))


def noreplacement_renormalize(ll: torch.Tensor) -> torch.Tensor:
    """Entry t becomes log P(item_t | items_0..t-1 removed) along the last
    axis. The first entry's log(cumsum - prob) is log(0) = -inf, whose
    log1mexp is 0: no NaN."""
    base = torch.max(ll, dim=-1, keepdim=True).values
    prob = torch.exp(ll - base)
    ll_delta = torch.log(blocked_cumsum(prob) - prob) + base
    return torch.clamp(ll - log1mexp(ll_delta), max=0.0)


class ProposalInfo(NamedTuple):
    mask: torch.Tensor  # [..., N] 0/1 selected flips (f32)
    perturbed_ll: torch.Tensor  # [..., N] Gumbel-perturbed logits
    ll_forward: torch.Tensor  # [...] forward ordered selection log-lik


def sample_flip_set(u: torch.Tensor, log_prob: torch.Tensor, path_length: torch.Tensor) -> ProposalInfo:
    """Gumbel top-k flip sets with k = `path_length` per chain; `u` are the
    Gumbel uniforms (the JAX function's key)."""
    n = log_prob.shape[-1]
    g = log_prob - torch.log(-torch.log(u))
    sorted_g = torch.sort(g, dim=-1).values  # ascending
    thresh = torch.gather(sorted_g, -1, (n - path_length.long())[..., None])
    mask = (g >= thresh).to(torch.float32)
    # the ordered forward log-lik: by descending Gumbel, renormalized, the selected prefix
    order = torch.argsort(-g, dim=-1, stable=True)
    idx_ll = noreplacement_renormalize(torch.gather(log_prob, -1, order))
    ll_forward = torch.sum(idx_ll * torch.gather(mask, -1, order), dim=-1)
    return ProposalInfo(mask=mask, perturbed_ll=g, ll_forward=ll_forward)


def reverse_ll(log_prob_y: torch.Tensor, info: ProposalInfo) -> torch.Tensor:
    """Log-lik of re-selecting the same flip set from y, in the reverse of
    the forward order."""
    backwd_idx = torch.argsort(info.perturbed_ll, dim=-1, stable=True)  # ascending
    masked_ll = torch.where(info.mask.bool(), log_prob_y, -1e18)
    backwd_mask = torch.gather(info.mask, -1, backwd_idx)
    ll = noreplacement_renormalize(torch.gather(masked_ll, -1, backwd_idx))
    return torch.sum(torch.where(backwd_mask.bool(), ll, 0.0), dim=-1)


# ------------------------------------------------------------------- sampler
@dataclasses.dataclass
class ISCOConfig:
    batch_size: int = 32
    chain_length: int = 200
    init_temperature: float = 1.0
    final_temperature: float = 1e-4
    target_accept: float = 0.574  # the reference's main_ISCO_maxcut.py:31
    mu_lr: float = 0.01
    mu_init: float = 10.0
    seed: int = 0


class ISCODraws(NamedTuple):
    """A chain's randomness: the start bits [..., B, N] (f32 0/1), then per
    step the path lengths [T, ..., B] (after the clip to [1, N]), the Gumbel
    uniforms [T, ..., B, N] and the accept uniforms [T, ..., B]."""

    x0: torch.Tensor
    path_length: torch.Tensor
    u_prop: torch.Tensor
    u_acc: torch.Tensor


Carry = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]  # x, mu, best_x, best_e


class ISCOSampler:
    """Path-auxiliary sampler over a quadratic pseudo-boolean energy:
    `energy_fn(x) -> [..., B]` (maximized) and `flip_delta_fn(x) -> [..., B, N]`
    (the exact energy change of each single flip), x f32 0/1 [..., B, N]."""

    def __init__(self, num_nodes: int, energy_fn: Callable[[torch.Tensor], torch.Tensor],
                 flip_delta_fn: Callable[[torch.Tensor], torch.Tensor], cfg: ISCOConfig = ISCOConfig()):
        self.num_nodes = num_nodes
        self.energy_fn = energy_fn
        self.flip_delta_fn = flip_delta_fn
        self.cfg = cfg

    def step(self, x, path_length, temperature, u_prop, u_acc):
        """One path-auxiliary MH step -> (x, its energy, acceptance prob)."""
        e_x_raw = self.energy_fn(x)
        log_prob_x = torch.log_softmax(self.flip_delta_fn(x) / (2.0 * temperature), dim=-1)
        info = sample_flip_set(u_prop, log_prob_x, path_length)
        y = x * (1 - info.mask) + info.mask * (1 - x)

        e_y_raw = self.energy_fn(y)
        log_prob_y = torch.log_softmax(self.flip_delta_fn(y) / (2.0 * temperature), dim=-1)
        ll_y2x = reverse_ll(log_prob_y, info)

        log_acc = torch.clamp((e_y_raw - e_x_raw) / temperature + ll_y2x - info.ll_forward, max=0.0)
        accept = torch.log(u_acc + 1e-24) < log_acc
        x_new = torch.where(accept[..., None], y, x)
        return x_new, torch.where(accept, e_y_raw, e_x_raw), torch.exp(log_acc)

    def temperatures(self, total: int) -> np.ndarray:
        """f32 [total]: init - t / total * (init - final), at least 1e-6."""
        cfg = self.cfg
        steps = np.arange(total, dtype=np.float32) / np.float32(total)
        temps = np.float32(cfg.init_temperature) - steps * np.float32(cfg.init_temperature - cfg.final_temperature)
        return np.maximum(temps, np.float32(1e-6))

    def init_carry(self, gen: Optional[torch.Generator], shape: Sequence[int], device,
                   x0: Optional[torch.Tensor] = None) -> Carry:
        """Uniform start bits of `shape` ([..., B, N]), mu = mu_init."""
        if x0 is None:
            x0 = (torch.rand(tuple(shape), generator=gen, device=device) < 0.5).to(torch.float32)
        x0 = torch.as_tensor(x0, device=device).to(torch.float32)
        mu0 = torch.full(x0.shape[:-1], self.cfg.mu_init, device=device)
        return x0, mu0, x0.clone(), self.energy_fn(x0)

    def run_segment(self, carry: Carry, temps: torch.Tensor, gen: Optional[torch.Generator] = None,
                    draws: Optional[ISCODraws] = None) -> Carry:
        """Steps at each of `temps`, drawing from `gen` unless `draws`."""
        cfg, n = self.cfg, self.num_nodes
        x, mu, best_x, best_e = carry
        for t in range(temps.shape[0]):
            if draws is None:
                path_length = torch.clamp(torch.poisson(mu, generator=gen), 1, n).to(torch.int32)
                u_prop = torch.rand(x.shape, generator=gen, device=x.device)
                u_acc = torch.rand(mu.shape, generator=gen, device=x.device)
            else:
                path_length, u_prop, u_acc = draws.path_length[t], draws.u_prop[t], draws.u_acc[t]
            x, energy, acc = self.step(x, path_length, temps[t], u_prop, u_acc)
            mu = torch.clamp(mu + cfg.mu_lr * (acc - cfg.target_accept), 1.0, float(n))
            better = energy > best_e
            best_e = torch.where(better, energy, best_e)
            best_x = torch.where(better[..., None], x, best_x)
        return x, mu, best_x, best_e

    def run(self, gen: Optional[torch.Generator], shape: Sequence[int], device,
            draws: Optional[ISCODraws] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """The whole annealed chain -> (best_x [..., B, N], best_energy [..., B])."""
        carry = self.init_carry(gen, shape, device, None if draws is None else draws.x0)
        temps = torch.from_numpy(self.temperatures(self.cfg.chain_length)).to(device)
        carry = self.run_segment(carry, temps, gen, draws)
        return carry[2], carry[3]


def _device_draws(draws: Optional[ISCODraws], dev) -> Optional[ISCODraws]:
    return None if draws is None else ISCODraws(*(torch.as_tensor(a, device=dev) for a in draws))


# ------------------------------------------------------------ problem fronts
def solve_maxcut_isco(graph: Graph, cfg: ISCOConfig = ISCOConfig(), mode: str = "dense",
                      instance_file: Optional[str] = None, time_budget: Optional[float] = None, record=None,
                      device=None, draws: Optional[ISCODraws] = None):
    """ISCO (mode='sparse') / PISCO (mode='dense') for maxcut -> (best bits,
    best cut). With `time_budget` (seconds) fresh chain batches (seeds
    seed + 1, seed + 2, ...) run until the budget is spent; `record(i,
    best)` is called after each batch. `draws` replace the first batch's."""
    dev = resolve_device(device)
    cg = cut_ops.CutGraph.build(graph, dev, with_dense=mode == "dense")
    sampler = ISCOSampler(graph.num_nodes, lambda x: cut_ops.cut_value(x > 0.5, cg, mode),
                          lambda x: cut_ops.flip_gains(x > 0.5, cg, mode), cfg)
    shape = (cfg.batch_size, graph.num_nodes)
    start = time.time()

    def run(seed, d=None):
        best_x, best_e = sampler.run(torch.Generator(device=dev).manual_seed(seed), shape, dev, d)
        i = int(torch.argmax(best_e))
        return (best_x[i] > 0.5).cpu().numpy(), float(best_e[i])

    bits, val = run(cfg.seed, _device_draws(draws, dev))
    if record is not None:
        record(0, val)
    restart = 0
    while time_budget is not None and time.time() - start < time_budget:
        restart += 1
        b, v = run(cfg.seed + restart)
        if v > val:
            bits, val = b, v
        if record is not None:
            record(restart, val)
    if instance_file is not None:
        write_graph_result(val, time.time() - start, graph.num_nodes, "isco", bits.astype(int), instance_file)
    return bits, val


def cell_sampler(graphs: Sequence[Graph], cfg: ISCOConfig = ISCOConfig(), device=None) -> ISCOSampler:
    """The sampler of a cell of same-size instances: states [G, B, N], the
    dense energy and gains as batched matmuls with the stacked [G, N, N]
    adjacencies."""
    dev = resolve_device(device)
    n = graphs[0].num_nodes
    if any(g.num_nodes != n for g in graphs):
        raise ValueError("cell instances must share num_nodes")
    adj = torch.stack([torch.from_numpy(g.adjacency_dense()) for g in graphs]).to(dev)  # [G, N, N]
    total_w = torch.tensor([g.total_weight for g in graphs], dtype=torch.float32, device=dev)[:, None]

    def gains(x):
        s = cut_ops.signs_from_bits(x > 0.5)
        return (s @ adj) * s

    def energy(x):
        return 0.5 * total_w - 0.25 * torch.sum(gains(x), dim=-1)

    return ISCOSampler(n, energy, gains, cfg)


def solve_maxcut_isco_cell(graphs: Sequence[Graph], cfg: ISCOConfig = ISCOConfig(), device=None,
                           draws: Optional[ISCODraws] = None) -> Tuple[np.ndarray, np.ndarray]:
    """PISCO (the dense energy) on a cell of same-size instances at once
    (`cell_sampler`). Returns (best bits [G, N], best cut [G])."""
    dev = resolve_device(device)
    n = graphs[0].num_nodes
    sampler = cell_sampler(graphs, cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    best_x, best_e = sampler.run(gen, (len(graphs), cfg.batch_size, n), dev, _device_draws(draws, dev))
    idx = torch.argmax(best_e, dim=1)
    bits = torch.gather(best_x, 1, idx[:, None, None].expand(-1, 1, n))[:, 0] > 0.5
    return bits.cpu().numpy(), torch.max(best_e, dim=1).values.cpu().numpy()


def solve_mis_isco(graph: Graph, cfg: ISCOConfig = ISCOConfig(), penalty: float = 1.01, device=None,
                   draws: Optional[ISCODraws] = None):
    """ISCO for maximum independent set: energy = |S| - penalty * violations.
    Returns (feasible bits, size) after dropping one endpoint of any
    violated edge."""
    dev = resolve_device(device)
    e = dobj.EdgeArrays.build(graph, dev)
    adj = torch.from_numpy(graph.adjacency_dense()).to(dev)

    def flip_delta(x):
        xb = (x > 0.5).to(torch.float32)
        direction = 1.0 - 2.0 * xb  # +1 when adding, -1 when removing
        return direction * (1.0 - penalty * (xb @ adj))

    sampler = ISCOSampler(graph.num_nodes,
                          lambda x: dobj.obj_maximum_independent_set(x > 0.5, e, penalty=penalty), flip_delta, cfg)
    best_x, best_e = sampler.run(torch.Generator(device=dev).manual_seed(cfg.seed), (cfg.batch_size, graph.num_nodes),
                                 dev, _device_draws(draws, dev))
    i = int(torch.argmax(best_e))
    bits = (best_x[i] > 0.5).cpu().numpy().copy()
    n0, n1, _ = graph.edge_arrays()
    for a, b in zip(n0, n1):
        if bits[a] and bits[b]:
            bits[b] = False
    return bits, float(bits.sum())
