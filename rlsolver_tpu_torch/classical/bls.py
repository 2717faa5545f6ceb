"""Breakout Local Search for maxcut, batched (counterpart of
`rlsolver_tpu/classical/bls.py`).

Every chain makes one flip a step: the best admissible move of a tabu
search (a tabu tenure, overridden when the move beats the chain's best),
or, during a perturbation burst of L flips started on stagnation, a
directed (max-gain) or uniformly random move, directed with probability
max(P0, exp(-omega / T)). Perturbation flips take a tenure in [phi_min,
phi_max], descent flips a short one (in lockstep form an untenured
downhill move would 2-cycle). The gains follow by rank-1 updates of the
flipped node's adjacency row. A round is `steps_per_round` steps; the
round loop is where `record` and `time_budget` act. The step count `t`
stays a host int.

The warm start's two greedy sweeps are `MaxcutEnv.sweep_1flip`: with
`packed_sweep=True` the packed 1-flip kernel the engine picks (K5 on
{0, +-1} graphs whose table fits shared memory, else K8a or K8b), without
it the f32 sweep kernel K10 (on the CPU, their plain versions).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from rlsolver_tpu_torch.core.graph import Graph
from rlsolver_tpu_torch.envs.maxcut import MaxcutEnv


@dataclasses.dataclass
class BLSConfig:
    num_chains: int = 256
    num_rounds: int = 40  # rounds of the host loop (time-budget aware)
    steps_per_round: int = 512  # flips per chain per round
    l0_ratio: float = 0.01  # the reference's L0_ratio (main_BLS.py:24)
    t_stag: int = 1000  # the reference's T: omega scale and stagnation trigger
    phi_min: int = 3  # perturbation tenure lower bound (main_BLS.py:26)
    phi_max_ratio: float = 0.1  # perturbation tenure upper bound = ratio * N
    p0: float = 0.8  # directed-perturbation probability floor
    desc_tenure: int = 20  # descent-flip tenure upper bound (see the module doc)
    seed: int = 0
    packed_sweep: bool = False  # for the warm start's sweeps only


class BLSRoundDraws(NamedTuple):
    """One round's randomness, [steps_per_round, B] each: the uniform of the
    directed-or-random choice, the random node, and the descent and the
    perturbation tenures (both drawn every step, as in the JAX package)."""

    u_mode: torch.Tensor
    rand_v: torch.Tensor
    ten_desc: torch.Tensor
    ten_pert: torch.Tensor


class BLSState(NamedTuple):
    xs: torch.Tensor  # bool [B, N]
    gains: torch.Tensor  # f32 [B, N]
    curr: torch.Tensor  # f32 [B]
    best_xs: torch.Tensor  # bool [B, N]
    best_vs: torch.Tensor  # f32 [B]
    tabu: torch.Tensor  # int32 [B, N]: the step until which a node is tabu
    omega: torch.Tensor  # int32 [B]: steps since the best improved
    stag: torch.Tensor  # int32 [B]
    pert_left: torch.Tensor  # int32 [B]: flips left in the burst


def solve_maxcut_bls(graph: Graph, cfg: BLSConfig = BLSConfig(), record=None, time_budget: Optional[float] = None,
                     device=None, xs0: Optional[torch.Tensor] = None,
                     draws: Optional[Sequence[BLSRoundDraws]] = None) -> Tuple[np.ndarray, float, List[float]]:
    """Returns (best bits, best cut, per-round best history).

    `record(round_idx, best_cut)` is called after every round; `time_budget`
    (seconds) stops the round loop once exceeded. `xs0` (the warm start's
    random bits) and `draws` (one per round) replace the generator's."""
    env = MaxcutEnv(graph, device, packed_sweep=cfg.packed_sweep)
    dev = env.device
    n, b = graph.num_nodes, cfg.num_chains
    adj = env.cg.adj
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    l0 = max(1, int(cfg.l0_ratio * n))
    phi_max = max(cfg.phi_min + 1, int(cfg.phi_max_ratio * n))
    phi_desc = max(cfg.phi_min + 1, min(cfg.desc_tenure, n // 10))
    t_stag = cfg.t_stag

    # warm start: random bits, then two improving sweeps to near a local optimum
    xs = env.random_xs(gen, b) if xs0 is None else torch.as_tensor(xs0, device=dev).bool()
    vs = env.obj(xs)
    xs, vs = env.sweep_1flip(xs, vs)
    xs, vs = env.sweep_1flip(xs, vs)

    rows = torch.arange(b, device=dev)
    neg_inf = torch.tensor(float("-inf"), device=dev)

    def step(st: BLSState, t: int, u_mode, rand_v, ten_desc, ten_pert) -> BLSState:
        xs, gains, curr, best_xs, best_vs, tabu, omega, stag, pert_left = st
        # the tabu move: the best admissible flip (aspiration overrides the tenure)
        adm = (tabu <= t) | ((curr[:, None] + gains) > best_vs[:, None] + 0.5)
        any_adm = adm.any(dim=1)
        tabu_v = torch.argmax(torch.where(adm, gains, neg_inf), dim=1)
        # the perturbation move (the reference's choose_perturbation schedule)
        p_dir = torch.clamp(torch.exp(-omega.to(torch.float32) / t_stag), min=cfg.p0)
        use_random = (omega >= t_stag) | (u_mode >= p_dir)
        pert_v = torch.where(use_random, rand_v, torch.argmax(gains, dim=1))
        perturbing = (pert_left > 0) | ~any_adm
        v = torch.where(perturbing, pert_v, tabu_v)
        # the flip, with a rank-1 update of the gains
        g_v = gains[rows, v]
        x_v = xs[rows, v]
        sgn = torch.where(xs == x_v[:, None], 1.0, -1.0)
        gains = gains - 2.0 * adj[v] * sgn
        gains[rows, v] = -g_v
        xs[rows, v] = ~x_v  # in place: no other tensor holds this state's bits
        curr = curr + g_v
        # the tenure: short for descent flips, the reference's for perturbations
        tabu[rows, v] = t + torch.where(perturbing, ten_pert, ten_desc)
        # bookkeeping
        improved = curr > best_vs + 0.5
        best_vs = torch.where(improved, curr, best_vs)
        best_xs = torch.where(improved[:, None], xs, best_xs)
        omega = torch.where(improved, 0, omega + 1)
        stag = torch.where(improved, 0, stag + 1)
        # an L-flip burst starts on stagnation (L grows by 1 once omega passes T)
        trigger = ~perturbing & (stag >= t_stag)
        burst = l0 + (omega > t_stag).to(torch.int32)
        pert_left = torch.where(perturbing, torch.clamp(pert_left - 1, min=0), torch.where(trigger, burst, 0))
        stag = torch.where(trigger, 0, stag)
        return BLSState(xs, gains, curr, best_xs, best_vs, tabu, omega, stag, pert_left)

    zeros_i = torch.zeros(b, dtype=torch.int32, device=dev)
    st = BLSState(xs, env.gains(xs), vs, xs.clone(), vs, torch.zeros(b, n, dtype=torch.int32, device=dev),
                  zeros_i, zeros_i, zeros_i)
    best_hist: List[float] = []
    t_start = time.time()
    t = 0
    steps = cfg.steps_per_round
    for i in range(cfg.num_rounds):
        if draws is None:
            d = BLSRoundDraws(torch.rand(steps, b, generator=gen, device=dev),
                              torch.randint(0, n, (steps, b), generator=gen, device=dev),
                              torch.randint(cfg.phi_min, phi_desc + 1, (steps, b), generator=gen, device=dev,
                                            dtype=torch.int32),
                              torch.randint(cfg.phi_min, phi_max + 1, (steps, b), generator=gen, device=dev,
                                            dtype=torch.int32))
        else:
            d = BLSRoundDraws(*(torch.as_tensor(a, device=dev) for a in draws[i]))
        rand_v = d.rand_v.long()
        ten_desc, ten_pert = d.ten_desc.to(torch.int32), d.ten_pert.to(torch.int32)
        for k in range(steps):
            st = step(st, t, d.u_mode[k], rand_v[k], ten_desc[k], ten_pert[k])
            t += 1
        best_hist.append(float(st.best_vs.max()))
        if record is not None:
            record(i, best_hist[-1])
        if time_budget is not None and time.time() - t_start > time_budget:
            break
    j = int(torch.argmax(st.best_vs))
    return st.best_xs[j].cpu().numpy(), float(st.best_vs[j]), best_hist
