"""Pattern-I vectorized node-flip MDP: S2V-DQN, ECO-DQN and PECO semantics
(counterpart of `rlsolver_tpu/envs/spin_system.py`).

B environments walk one graph in lockstep; an action flips one node per
environment. The env object holds static shapes and flags; the instance
data (`SpinSystemParams`) and the state (`SpinSystemState`) are tensors on
the params' device, and every method returns new tensors (no state is
changed in place). Per-node flip gains are kept incrementally (one
adjacency-row gather and a rank-1 update a step), and revisits are found
through two 32-bit state hashes kept in a ring per environment.

Observables (ECO set): 0 spin state (signed, or (1 - s) / 2 in the binary
basis); 1 gains / the reset state's max gain; 2 time since flip; 3 |score -
best score| / that max gain; 4 Hamming distance to the best state; 5 1 -
(count of gains <= 0) / N; 6 termination immanency. S2V uses channel 0 only.

The hashes are uint32 sums that wrap in the JAX package. Torch has few
uint32 operations on CUDA, so they are summed in int64 and masked to 32
bits, then raised to at least 1 (0 marks an empty ring slot): the values
equal JAX's bit for bit and are held in int64 tensors. The step count is a
Python int, so callers know on the host when an episode ends.

The f32 arithmetic follows the JAX package's compiled step: XLA turns a
division by a constant c into a product with f32(1 / c) and fuses a product
and the sum after it into one rounding (a fused multiply-add). So the
reward normalisation multiplies by f32(1 / N), and the observables 5 and 6
are computed in float64, where such a product and sum are exact, and
rounded to f32 once.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from rlsolver_tpu_torch.core.graph import Graph
from rlsolver_tpu_torch.device import resolve_device


class RewardSignal(enum.Enum):
    DENSE = "dense"
    BLS = "bls"
    SINGLE = "single"
    CUSTOM_BLS = "custom_bls"


class SpinBasis(enum.Enum):
    SIGNED = "signed"
    BINARY = "binary"


# The ECO/PECO observable set; S2V uses only the spin state.
NUM_OBSERVABLES_ECO = 7
NUM_OBSERVABLES_S2V = 1

_HASH_MASK = 0xFFFFFFFF


def _recip(c: int) -> float:
    """f32(1 / c), the factor XLA multiplies by in place of dividing by c."""
    return float(np.float32(1.0 / c))


@dataclasses.dataclass(frozen=True)
class SpinSystemConfig:
    num_envs: int = 256
    max_steps: int = 0  # 0 -> 2 * num_nodes
    reward_signal: RewardSignal = RewardSignal.BLS
    spin_basis: SpinBasis = SpinBasis.BINARY
    norm_rewards: bool = True
    basin_reward: Optional[float] = None  # ECO: 1 / N
    stag_punishment: Optional[float] = None
    reversible_spins: bool = True  # False = S2V-style irreversible
    num_observables: int = NUM_OBSERVABLES_ECO
    horizon_length: Optional[int] = None  # None -> max_steps
    memory_length: Optional[int] = None  # revisit memory; None = full episode


class SpinSystemParams(NamedTuple):
    """Per-instance data."""

    adj: torch.Tensor  # f32 [N, N] symmetric dense adjacency
    total_w: torch.Tensor  # f32 0-d, total edge weight
    max_local_reward: torch.Tensor  # f32 0-d, max flip gain at the all-ones state
    hash_r1: torch.Tensor  # int64 [N], random hash vector in [1, 2^32)
    hash_r2: torch.Tensor  # int64 [N]


class SpinSystemState(NamedTuple):
    spins: torch.Tensor  # f32 [B, N] signed +-1
    gains: torch.Tensor  # f32 [B, N] flip gains of the current state
    # per-episode observation scale: the max flip gain AT THE RESET STATE
    # (the JAX package's deliberate deviation from the reference's all-ones
    # scale, which crushed observations on BA graphs)
    max_local: torch.Tensor  # f32 [B]
    score: torch.Tensor  # f32 [B]
    init_score: torch.Tensor  # f32 [B]
    best_score: torch.Tensor  # f32 [B]
    best_spins: torch.Tensor  # f32 [B, N]
    time_since_flip: torch.Tensor  # f32 [B, N]
    step_count: torch.Tensor  # int64 0-d, on the device (a CUDA graph of steps serves every offset)
    hist_h1: torch.Tensor  # int64 [B, H] ring of visited-state hashes
    hist_h2: torch.Tensor  # int64 [B, H]


class SpinSystemEnv:
    """Static shapes and flags; the instance data rides in
    `SpinSystemParams`, on whatever device it was built for."""

    def __init__(self, num_nodes: int, config: SpinSystemConfig = SpinSystemConfig()):
        self.num_nodes = num_nodes
        self.config = config
        self.max_steps = config.max_steps or 2 * num_nodes
        self.horizon = config.horizon_length or self.max_steps
        # ring slots: a finite memory keeps only the last `memory_length`
        # hashes (the modular slot write overwrites the oldest)
        self.history_capacity = config.memory_length or (self.max_steps + 1)

    # ---------------------------------------------------------------- params
    def params_from_graph(self, graph: Graph, hash_seed: int = 0, device=None) -> SpinSystemParams:
        if graph.num_nodes != self.num_nodes:
            raise ValueError(f"graph has {graph.num_nodes} nodes, env expects {self.num_nodes}")
        dev = resolve_device(device)
        max_gain = float(graph.weighted_degrees().max())
        if max_gain <= 0:
            raise ValueError("graph has no positive-gain flip from the all-ones state")
        rng = np.random.default_rng(hash_seed)
        r = rng.integers(1, 2**32, (2, self.num_nodes), dtype=np.uint64).astype(np.uint32).astype(np.int64)
        f32 = dict(dtype=torch.float32, device=dev)
        return SpinSystemParams(
            adj=torch.as_tensor(graph.adjacency_dense(), **f32),
            total_w=torch.tensor(np.float32(graph.total_weight), **f32),
            max_local_reward=torch.tensor(np.float32(max_gain), **f32),
            hash_r1=torch.from_numpy(r[0]).to(dev),
            hash_r2=torch.from_numpy(r[1]).to(dev),
        )

    # ------------------------------------------------------------------ hash
    @staticmethod
    def _state_hash(params: SpinSystemParams, spins: torch.Tensor):
        bits = spins > 0
        h1 = torch.where(bits, params.hash_r1[None, :], 0).sum(dim=1) & _HASH_MASK
        h2 = torch.where(bits, params.hash_r2[None, :], 0).sum(dim=1) & _HASH_MASK
        return h1.clamp_min(1), h2.clamp_min(1)  # 0 is the empty sentinel

    @staticmethod
    def _cut(params: SpinSystemParams, spins: torch.Tensor) -> torch.Tensor:
        sa = spins @ params.adj
        return 0.5 * params.total_w - 0.25 * torch.sum(sa * spins, dim=-1)

    @staticmethod
    def _gains_full(params: SpinSystemParams, spins: torch.Tensor) -> torch.Tensor:
        return (spins @ params.adj) * spins

    # ----------------------------------------------------------------- reset
    def reset(
        self,
        params: SpinSystemParams,
        generator: Optional[torch.Generator] = None,
        spins: Optional[torch.Tensor] = None,
    ) -> Tuple[SpinSystemState, torch.Tensor]:
        """Fresh episodes: uniform +-1 spins drawn from `generator` (or the
        injected `spins` [B, N]); all +1 in the irreversible mode."""
        cfg = self.config
        b, n = cfg.num_envs, self.num_nodes
        dev = params.adj.device
        if spins is not None:
            spins = torch.as_tensor(spins if isinstance(spins, torch.Tensor) else np.array(spins),
                                    dtype=torch.float32, device=dev)
        elif not cfg.reversible_spins:
            spins = torch.ones(b, n, dtype=torch.float32, device=dev)
        elif generator is None:
            raise ValueError("reset needs a generator or injected spins")
        else:
            spins = torch.where(torch.rand(b, n, generator=generator, device=dev) < 0.5, 1.0, -1.0)
        gains = self._gains_full(params, spins)
        max_local = gains.max(dim=1).values.clamp_min(1e-3)
        score = self._cut(params, spins)
        h1, h2 = self._state_hash(params, spins)
        hist_h1 = torch.zeros(b, self.history_capacity, dtype=torch.int64, device=dev)
        hist_h2 = torch.zeros_like(hist_h1)
        hist_h1[:, 0] = h1
        hist_h2[:, 0] = h2
        state = SpinSystemState(
            spins=spins,
            gains=gains,
            max_local=max_local,
            score=score,
            init_score=score,
            best_score=score,
            best_spins=spins,
            time_since_flip=torch.zeros(b, n, dtype=torch.float32, device=dev),
            step_count=torch.zeros((), dtype=torch.int64, device=dev),
            hist_h1=hist_h1,
            hist_h2=hist_h2,
        )
        return state, self.observation(params, state)

    # ------------------------------------------------------------------ step
    def step(
        self, params: SpinSystemParams, state: SpinSystemState, actions: torch.Tensor
    ) -> Tuple[SpinSystemState, torch.Tensor, torch.Tensor, torch.Tensor]:
        """actions: int [B] node to flip per env -> (state, obs, rew, done)."""
        cfg = self.config
        b, n = cfg.num_envs, self.num_nodes
        actions = actions.long()
        rows = torch.arange(b, device=actions.device)

        delta = state.gains[rows, actions]  # gain of the chosen flip
        s_a = state.spins[rows, actions]
        adj_rows = params.adj.index_select(0, actions)  # [B, N]

        # rank-1 incremental gain update: gain_j -= 2 s_j s_a A_aj; gain_a = -delta;
        # then the flip (the JAX package's order, so the f32 values agree)
        gains = state.gains - 2.0 * (s_a[:, None] * state.spins) * adj_rows
        gains[rows, actions] = -delta
        spins = state.spins.clone()
        spins[rows, actions] = -s_a
        score = state.score + delta

        # reward w.r.t. the best score BEFORE this step
        improvement = score - state.best_score
        if cfg.reward_signal == RewardSignal.BLS:
            rew = improvement.clamp_min(0.0)
        elif cfg.reward_signal == RewardSignal.CUSTOM_BLS:
            rew = torch.where(improvement > 0, improvement / (improvement + 0.1), 0.0)
        elif cfg.reward_signal == RewardSignal.DENSE:
            rew = delta
        else:  # SINGLE: only at episode end
            rew = torch.zeros_like(delta)

        # revisit detection
        if cfg.stag_punishment is not None or cfg.basin_reward is not None:
            h1, h2 = self._state_hash(params, spins)
            seen = ((state.hist_h1 == h1[:, None]) & (state.hist_h2 == h2[:, None])).any(dim=1)
            slot = ((state.step_count + 1) % self.history_capacity).view(1)
            hist_h1 = state.hist_h1.index_copy(1, slot, h1[:, None])
            hist_h2 = state.hist_h2.index_copy(1, slot, h2[:, None])
            if cfg.stag_punishment is not None:
                rew = rew - torch.where(seen, cfg.stag_punishment, 0.0)
            if cfg.basin_reward is not None:
                local_opt = (gains <= 0.0).all(dim=1)
                rew = rew + torch.where(local_opt & ~seen, cfg.basin_reward, 0.0)
        else:
            hist_h1, hist_h2 = state.hist_h1, state.hist_h2

        # incumbent update (after the reward)
        better = score > state.best_score
        best_score = torch.where(better, score, state.best_score)
        best_spins = torch.where(better[:, None], spins, state.best_spins)

        step_count = state.step_count + 1
        done_now = step_count >= self.max_steps
        if cfg.reward_signal == RewardSignal.SINGLE:
            rew = torch.where(done_now, score - state.init_score, rew)
        if cfg.norm_rewards:
            rew = rew * _recip(n)

        tsf = state.time_since_flip + 1.0 / self.max_steps
        tsf[rows, actions] = torch.zeros_like(delta)  # a tensor: a host scalar would be copied in (no graph capture)

        new_state = SpinSystemState(
            spins=spins,
            gains=gains,
            max_local=state.max_local,
            score=score,
            init_score=state.init_score,
            best_score=best_score,
            best_spins=best_spins,
            time_since_flip=tsf,
            step_count=step_count,
            hist_h1=hist_h1,
            hist_h2=hist_h2,
        )
        done = done_now.expand(b)
        return new_state, self.observation(params, new_state), rew, done

    # ----------------------------------------------------------- observation
    def observation(self, params: SpinSystemParams, state: SpinSystemState) -> torch.Tensor:
        """[B, N, num_observables] node features (the adjacency goes to the
        network separately)."""
        cfg = self.config
        n = self.num_nodes
        if cfg.spin_basis == SpinBasis.BINARY:
            spin_obs = (1.0 - state.spins) / 2.0
        else:
            spin_obs = state.spins
        if cfg.num_observables == NUM_OBSERVABLES_S2V:
            return spin_obs[..., None]
        max_r = state.max_local
        imm = state.gains / max_r[:, None]
        dist_score = (state.score - state.best_score).abs() / max_r
        dist_state = (state.best_spins != state.spins).sum(dim=1).to(torch.float32)
        # 1 - count * f32(1/N) and (step - max_steps) * f32(1/horizon) + 1,
        # each rounded once (exact in float64 before the rounding)
        greedy_avail = (1.0 - (state.gains <= 0.0).sum(dim=1).double() * _recip(n)).to(torch.float32)
        imman = ((state.step_count - self.max_steps).double() * _recip(self.horizon) + 1.0).float().clamp_min(0.0)
        shape = spin_obs.shape
        return torch.stack(
            [
                spin_obs,
                imm,
                state.time_since_flip,
                dist_score[:, None].expand(shape),
                dist_state[:, None].expand(shape),
                greedy_avail[:, None].expand(shape),
                imman.expand(shape),
            ],
            dim=-1,
        )

    def allowed_action_mask(self, state: SpinSystemState) -> torch.Tensor:
        """bool [B, N]: flippable nodes — all if reversible, never-flipped
        (+1) spins otherwise."""
        if self.config.reversible_spins:
            return torch.ones(state.spins.shape, dtype=torch.bool, device=state.spins.device)
        return state.spins > 0
