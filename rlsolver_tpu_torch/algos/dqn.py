"""DQN for Pattern-I node-flip MDPs: S2V-DQN, ECO-DQN and PECO (counterpart
of `rlsolver_tpu/algos/dqn.py`).

Double-DQN targets, epsilon-greedy exploration over the allowed actions, a
replay ring on the device, periodic target-network syncs and greedy
evaluation over the vectorized `SpinSystemEnv`. Parameters are state
dicts of the `MPNN` (flax's names, `convert.mpnn_state_dict` carries a JAX
tree across) applied through `torch.func.functional_call`; the optimizer
is `optim.ClippedAdam(max_norm=None)`, which is `optax.adam`, its state a
dict `{"count", "mu", "nu"}`.

Nothing is compiled: `train_scan` and `train_scan_select` keep their names
and their step counts (`max(1, num_steps // scan_chunk) * scan_chunk` loop
steps; `max(1, num_steps // (num_segments * scan_chunk))` chunks a
segment), so a protocol means the same budget on both packages. Every
drawing function takes a `torch.Generator` or injected draws (`ActDraws`,
`LoopDraws`, `idx=`, `spins=`). The ring's `ptr` and `size` and the env's
step count are host ints, so deciding to train or to reset an episode
needs no device sync; an episode is reset only when it ends (the JAX loop
computes a reset every step and masks it: the same semantics).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch
from torch.func import functional_call

from rlsolver_tpu_torch.capture import CapturedCall
from rlsolver_tpu_torch.core.graph import Graph
from rlsolver_tpu_torch.device import resolve_device
from rlsolver_tpu_torch.envs.spin_system import SpinSystemEnv, SpinSystemParams, SpinSystemState
from rlsolver_tpu_torch.models.mpnn import MPNN
from rlsolver_tpu_torch.optim import ClippedAdam

Params = Dict[str, torch.Tensor]


class ReplayBuffer(NamedTuple):
    """Fixed-capacity transition ring on the device; capacity % add size == 0."""

    obs: torch.Tensor  # [cap, N, obs] f32
    action: torch.Tensor  # [cap] int64
    reward: torch.Tensor  # [cap] f32
    next_obs: torch.Tensor  # [cap, N, obs] f32
    done: torch.Tensor  # [cap] bool
    gidx: torch.Tensor  # [cap] int64: the training instance of the transition
    ptr: int  # next write slot
    size: int  # filled entries

    @staticmethod
    def create(capacity: int, num_nodes: int, num_obs: int, device=None) -> "ReplayBuffer":
        dev = resolve_device(device)
        return ReplayBuffer(
            obs=torch.zeros(capacity, num_nodes, num_obs, device=dev),
            action=torch.zeros(capacity, dtype=torch.int64, device=dev),
            reward=torch.zeros(capacity, device=dev),
            next_obs=torch.zeros(capacity, num_nodes, num_obs, device=dev),
            done=torch.zeros(capacity, dtype=torch.bool, device=dev),
            gidx=torch.zeros(capacity, dtype=torch.int64, device=dev),
            ptr=0,
            size=0,
        )

    @property
    def capacity(self) -> int:
        return self.obs.shape[0]


def buffer_add(buf: ReplayBuffer, obs, action, reward, next_obs, done, gidx=None) -> ReplayBuffer:
    """Append a batch of transitions; the ring's tensors are written in
    place and the returned buffer carries the new `ptr` and `size`."""
    b, cap = obs.shape[0], buf.capacity
    if cap % b:
        raise ValueError(f"the batch of {b} transitions does not divide the capacity {cap}")
    s = slice(buf.ptr, buf.ptr + b)
    buf.obs[s] = obs
    buf.action[s] = action
    buf.reward[s] = reward
    buf.next_obs[s] = next_obs
    buf.done[s] = done
    buf.gidx[s] = 0 if gidx is None else gidx
    return buf._replace(ptr=(buf.ptr + b) % cap, size=min(buf.size + b, cap))


def buffer_sample(buf: ReplayBuffer, batch_size: int, generator: Optional[torch.Generator] = None,
                  idx: Optional[torch.Tensor] = None):
    """Uniform draw of `batch_size` filled slots (or the injected `idx`) ->
    (obs, action, reward, next_obs, done, gidx)."""
    if idx is None:
        idx = torch.randint(0, buf.size, (batch_size,), generator=generator, device=buf.obs.device)
    idx = torch.as_tensor(idx, dtype=torch.int64, device=buf.obs.device)
    return buf.obs[idx], buf.action[idx], buf.reward[idx], buf.next_obs[idx], buf.done[idx], buf.gidx[idx]


@dataclasses.dataclass
class DQNConfig:
    features: int = 64
    n_layers: int = 3
    lr: float = 1e-4
    gamma: float = 0.95
    buffer_capacity: int = 2**13
    batch_size: int = 64
    update_frequency: int = 4  # env steps between SGD steps
    target_update_frequency: int = 1000
    eps_start: float = 1.0
    eps_end: float = 0.05
    eps_decay_steps: int = 10_000
    learning_starts: int = 512  # transitions before training
    seed: int = 0
    dtype: torch.dtype = torch.float32  # the MPNN's compute dtype


class ActDraws(NamedTuple):
    """One act's draws: the uniform random action over the allowed ones [B]
    and the uniform in [0, 1) compared with epsilon [B]."""

    random_a: torch.Tensor
    u: torch.Tensor


class LoopDraws(NamedTuple):
    """One loop step's draws: the act's, the replay sample's indices and
    the reset spins used when the episode ends."""

    act: ActDraws
    idx: torch.Tensor
    spins: torch.Tensor


class DQNLoopState(NamedTuple):
    params: Params
    target_params: Params
    opt_state: dict
    buf: ReplayBuffer
    env_state: SpinSystemState
    obs: torch.Tensor
    generator: torch.Generator
    step_idx: int
    train_steps: int
    best_cut: torch.Tensor  # f32 0-d, running best over episodes
    graph_idx: int  # current training instance


def _epsilon_f32(cfg: DQNConfig, step: int) -> float:
    """The schedule as the JAX package's compiled loop computes it from its
    int32 step: frac = min(1, step * f32(1 / decay_steps)) in f32, then
    eps_start + frac * f32(eps_end - eps_start) rounded once (a fused
    multiply-add; exact in float64 before the rounding)."""
    frac = min(1.0, float(np.float32(step) * np.float32(1.0 / cfg.eps_decay_steps)))
    return float(np.float32(cfg.eps_start + frac * float(np.float32(cfg.eps_end - cfg.eps_start))))


ROLLOUT_GRAPH_STEPS = 100  # greedy rollout steps one CUDA graph replays


class DQNAgent:
    """MPNN Q-network + double-DQN training over a SpinSystemEnv."""

    def __init__(self, env: SpinSystemEnv, cfg: DQNConfig = DQNConfig(), device=None):
        self.env = env
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = MPNN(env.config.num_observables, cfg.features, cfg.n_layers, dtype=cfg.dtype,
                          device=self.device)
        self.last_eval_state: Optional[SpinSystemState] = None
        self._rollout_call: Optional[CapturedCall] = None

    def q_values(self, params: Params, obs: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        return functional_call(self.model, params, (obs, adj))

    def init_params(self, seed: int = 0) -> Params:
        """flax's initialisation (lecun-normal kernels, zero biases) from a
        seeded CPU generator, on the agent's device."""
        model = MPNN(self.env.config.num_observables, self.cfg.features, self.cfg.n_layers, seed=seed,
                     device=self.device)
        return {k: v.detach() for k, v in model.state_dict().items()}

    def new_opt_state(self, params: Params) -> dict:
        return ClippedAdam(list(params.values()), self.cfg.lr, max_norm=None).state_dict()

    def epsilon(self, step: int) -> float:
        cfg = self.cfg
        frac = min(1.0, step / cfg.eps_decay_steps)
        return cfg.eps_start + frac * (cfg.eps_end - cfg.eps_start)

    # ------------------------------------------------------------ act / learn
    @torch.no_grad()
    def act(self, params: Params, obs, adj, mask, generator: Optional[torch.Generator] = None, eps: float = 0.0,
            draws: Optional[ActDraws] = None) -> torch.Tensor:
        """epsilon-greedy actions [B] with allowed-action masking: greedy on
        the masked Q values, else uniform over the allowed actions."""
        q = self.q_values(params, obs, adj).masked_fill(~mask, -torch.inf)
        greedy = q.argmax(dim=-1)
        if draws is None:
            if eps <= 0.0:  # a uniform draw in [0, 1) is never below eps
                return greedy
            r = torch.rand(mask.shape, generator=generator, device=mask.device)
            draws = ActDraws(torch.where(mask, r, -1.0).argmax(dim=-1), torch.rand(mask.shape[0],
                             generator=generator, device=mask.device))
        random_a = torch.as_tensor(draws.random_a, dtype=torch.int64, device=mask.device)
        u = torch.as_tensor(draws.u, dtype=torch.float32, device=mask.device)
        return torch.where(u < eps, random_a, greedy)

    def train_step(self, params: Params, target_params: Params, opt_state: dict, batch, adj):
        """One double-DQN step: online argmax, target evaluation, squared TD
        error, Adam. `adj` is [N, N] shared or [batch, N, N] per sample.
        -> (params, opt_state, loss); the inputs are left unchanged."""
        cfg = self.cfg
        obs, action, reward, next_obs, done = batch[:5]
        p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
        q = self.q_values(p, obs, adj)
        q_a = q.gather(1, action.long()[:, None])[:, 0]
        with torch.no_grad():
            next_a = self.q_values(params, next_obs, adj).argmax(dim=-1)
            next_v = self.q_values(target_params, next_obs, adj).gather(1, next_a[:, None])[:, 0]
            y = reward + cfg.gamma * (1.0 - done.to(torch.float32)) * next_v
        loss = torch.mean((q_a - y) ** 2)
        grads = torch.autograd.grad(loss, list(p.values()))
        opt = ClippedAdam(list(p.values()), cfg.lr, max_norm=None)
        opt.load_state_dict(opt_state)
        for t, g in zip(p.values(), grads):
            t.grad = g
        opt.step()
        return {k: t.detach() for k, t in p.items()}, {"count": opt.count, "mu": opt.mu, "nu": opt.nu}, loss.detach()

    # ------------------------------------------------------------- training
    def train(
        self,
        graph_sampler: Callable[[int], Graph],
        num_steps: int,
        eval_every: int = 0,
        eval_graphs: Optional[list] = None,
        select_best: bool = False,
        verbose: bool = False,
    ):
        """graph_sampler(i) -> Graph for episode i (distribution training).
        Returns (params, history dict). With `select_best` (and periodic
        eval configured) the returned params are those with the highest
        mean validation cut."""
        cfg, env, dev = self.cfg, self.env, self.device
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)
        episode = 0
        params_env = env.params_from_graph(graph_sampler(episode), device=dev)
        params = self.init_params(cfg.seed)
        target_params = params
        opt_state = self.new_opt_state(params)
        buf = ReplayBuffer.create(cfg.buffer_capacity, env.num_nodes, env.config.num_observables, dev)
        state, obs = env.reset(params_env, generator=gen)
        history = {"loss": [], "best_cut": [], "eval": []}
        best_eval, best_params = -np.inf, params
        train_steps = 0
        for step in range(num_steps):
            mask = env.allowed_action_mask(state)
            actions = self.act(params, obs, params_env.adj, mask, gen, self.epsilon(step))
            state, next_obs, rew, done = env.step(params_env, state, actions)
            buf = buffer_add(buf, obs, actions, rew, next_obs, done)
            obs = next_obs

            if buf.size >= cfg.learning_starts and step % cfg.update_frequency == 0:
                batch = buffer_sample(buf, cfg.batch_size, gen)
                params, opt_state, loss = self.train_step(params, target_params, opt_state, batch, params_env.adj)
                train_steps += 1
                if train_steps % max(1, cfg.target_update_frequency // cfg.update_frequency) == 0:
                    target_params = params
                history["loss"].append(float(loss))

            if (step + 1) % env.max_steps == 0:  # every episode runs max_steps steps from its reset
                history["best_cut"].append(float(state.best_score.max()))
                episode += 1
                params_env = env.params_from_graph(graph_sampler(episode), device=dev)
                state, obs = env.reset(params_env, generator=gen)
                if verbose:
                    print(f"episode {episode:4d} step {step:6d} best_cut {history['best_cut'][-1]:9.1f} "
                          f"eps {self.epsilon(step):.3f}")

            if eval_every and eval_graphs and (step + 1) % eval_every == 0:
                score = np.mean([self.evaluate(params, g) for g in eval_graphs])
                history["eval"].append((step + 1, float(score)))
                if score > best_eval:
                    best_eval, best_params = float(score), params
                if verbose:
                    print(f"eval @ {step + 1}: avg best cut {score:.2f}")

        if select_best and history["eval"]:
            score = np.mean([self.evaluate(params, g) for g in eval_graphs])
            if score > best_eval:
                best_eval, best_params = float(score), params
            return best_params, history
        return params, history

    # -------------------------------------------------- unified-runtime path
    def _build_loop_step(self, graph):
        """The act/step/replay/train/target-sync/episode-reset cycle as one
        `step_fn(state, draws=None) -> (state, metrics)` over a resumable
        `DQNLoopState`, and its initial state. `graph` is one Graph or a
        list of same-size Graphs, a pool the loop rotates through at each
        episode boundary; a sampled transition is then evaluated against
        its own instance's adjacency."""
        cfg, env, dev = self.cfg, self.env, self.device
        graphs = list(graph) if isinstance(graph, (list, tuple)) else [graph]
        num_graphs = len(graphs)
        pes: List[SpinSystemParams] = [env.params_from_graph(g, hash_seed=i, device=dev)
                                       for i, g in enumerate(graphs)]
        stacked_adj = torch.stack([pe.adj for pe in pes]) if num_graphs > 1 else None
        target_sync = max(1, cfg.target_update_frequency // cfg.update_frequency)

        def step_fn(state: DQNLoopState, draws: Optional[LoopDraws] = None):
            pe = pes[state.graph_idx]
            gen = state.generator
            eps = _epsilon_f32(cfg, state.step_idx)
            mask = env.allowed_action_mask(state.env_state)
            actions = self.act(state.params, state.obs, pe.adj, mask, gen, eps,
                               draws=None if draws is None else draws.act)
            env_state, next_obs, rew, done = env.step(pe, state.env_state, actions)
            buf = buffer_add(state.buf, state.obs, actions, rew, next_obs, done, gidx=state.graph_idx)

            params, target_params, opt_state = state.params, state.target_params, state.opt_state
            train_steps, loss = state.train_steps, torch.zeros((), device=dev)
            if buf.size >= cfg.learning_starts and state.step_idx % cfg.update_frequency == 0:
                batch = buffer_sample(buf, cfg.batch_size, gen, idx=None if draws is None else draws.idx)
                adj_b = stacked_adj[batch[5]] if num_graphs > 1 else pe.adj
                params, opt_state, loss = self.train_step(params, target_params, opt_state, batch[:5], adj_b)
                train_steps += 1
                if train_steps % target_sync == 0:
                    target_params = params

            best_cut = torch.maximum(state.best_cut, env_state.best_score.max())
            graph_idx, obs = state.graph_idx, next_obs
            if (state.step_idx + 1) % env.max_steps == 0:  # episode boundary (each runs max_steps steps): the next instance
                graph_idx = (graph_idx + 1) % num_graphs
                env_state, obs = env.reset(pes[graph_idx], generator=gen,
                                           spins=None if draws is None else draws.spins)
            metrics = {"loss": loss, "best_cut": best_cut, "eps": eps}
            return DQNLoopState(params, target_params, opt_state, buf, env_state, obs, gen, state.step_idx + 1,
                                train_steps, best_cut, graph_idx), metrics

        gen = torch.Generator(device=dev).manual_seed(cfg.seed)
        params = self.init_params(cfg.seed)
        env_state, obs = env.reset(pes[0], generator=gen)
        state = DQNLoopState(
            params=params,
            target_params=params,
            opt_state=self.new_opt_state(params),
            buf=ReplayBuffer.create(cfg.buffer_capacity, env.num_nodes, env.config.num_observables, dev),
            env_state=env_state,
            obs=obs,
            generator=gen,
            step_idx=0,
            train_steps=0,
            best_cut=torch.tensor(-torch.inf, device=dev),
            graph_idx=0,
        )
        return step_fn, state

    def train_runner(
        self,
        graph: Graph,
        num_steps: int,
        run_dir: str = "runs/dqn",
        checkpoint_every: int = 0,
        resume: bool = False,
        log_every: int = 50,
    ):
        """Single-graph DQN through `train.runner.TrainLoop`: checkpoints and
        resume, metrics.jsonl and the stop sentinel. Returns (params,
        final_state)."""
        from rlsolver_tpu_torch.train.runner import LoopConfig, TrainLoop

        step_fn, state = self._build_loop_step(graph)
        loop = TrainLoop(
            LoopConfig(
                run_dir=run_dir,
                total_steps=num_steps,
                log_every=log_every,
                checkpoint_every=checkpoint_every,
                resume=resume,
                samples_per_step=self.env.config.num_envs,
            ),
            step_fn,
        )
        state = loop.run(state)
        return state.params, state

    def train_scan(self, graph: Graph, num_steps: int, scan_chunk: int = 256):
        """`max(1, num_steps // scan_chunk) * scan_chunk` loop steps on one
        graph (`train_runner` without the runtime edges). Returns (params,
        best_cut, final_state)."""
        step_fn, state = self._build_loop_step(graph)
        metrics = None
        for _ in range(max(1, num_steps // scan_chunk) * scan_chunk):
            state, metrics = step_fn(state)
        return state.params, float(metrics["best_cut"]), state

    def train_scan_select(
        self,
        graphs,
        num_steps: int,
        val_graphs: list,
        num_segments: int = 16,
        scan_chunk: int = 256,
        verbose: bool = False,
    ):
        """Distribution training with validation-selected params: `graphs`
        is the rotating training pool; after each of `num_segments`
        segments (`max(1, num_steps // (num_segments * scan_chunk))` chunks
        of `scan_chunk` steps) the params are scored by greedy rollouts on
        `val_graphs`, and the best-scoring ones are returned. Returns
        (best_params, history) with history = [(cumulative_steps,
        mean_val_cut)]."""
        step_fn, state = self._build_loop_step(graphs)
        seg_chunks = max(1, num_steps // (num_segments * scan_chunk))
        best_score, best_params = -np.inf, state.params
        history = []
        for seg in range(num_segments):
            for _ in range(seg_chunks * scan_chunk):
                state, _ = step_fn(state)
            score = float(np.mean([self.evaluate_scan(state.params, g) for g in val_graphs]))
            steps_done = (seg + 1) * seg_chunks * scan_chunk
            history.append((steps_done, score))
            if score > best_score:
                best_score, best_params = score, state.params
            if verbose:
                print(f"  segment {seg + 1}/{num_segments} ({steps_done} loop steps): val cut {score:.1f}"
                      + (" *" if score == best_score else ""), flush=True)
        return best_params, history

    # ------------------------------------------------------------- inference
    def _greedy_steps(self, params: Params, pe: SpinSystemParams, state: SpinSystemState, obs: torch.Tensor,
                      steps: int):
        env = self.env
        for _ in range(steps):
            actions = self.act(params, obs, pe.adj, env.allowed_action_mask(state))
            state, obs, _, _ = env.step(pe, state, actions)
        return state, obs

    def _rollout_block(self, params: Params) -> CapturedCall:
        """ROLLOUT_GRAPH_STEPS greedy steps over the flat inputs (*state,
        obs, *pe, *params) -> (*state, obs). The step count rides in the
        state on the device, so one graph serves every offset of a rollout."""
        if self._rollout_call is None:
            names, ns, npe = list(params), len(SpinSystemState._fields), len(SpinSystemParams._fields)

            def block(*flat):
                state, obs = self._greedy_steps(dict(zip(names, flat[ns + 1 + npe:])),
                                                SpinSystemParams(*flat[ns + 1:ns + 1 + npe]),
                                                SpinSystemState(*flat[:ns]), flat[ns], ROLLOUT_GRAPH_STEPS)
                return (*state, obs)
            self._rollout_call = CapturedCall(block)
        return self._rollout_call

    def _greedy_rollout(self, params: Params, pe: SpinSystemParams, generator, spins=None,
                        cuda_graph: bool = True) -> SpinSystemState:
        env = self.env
        params = {k: v.to(self.cfg.dtype) for k, v in params.items()}  # cast once, not at every step
        state, obs = env.reset(pe, generator=generator, spins=spins)
        steps = env.max_steps
        if cuda_graph and obs.is_cuda and steps >= ROLLOUT_GRAPH_STEPS:
            block = self._rollout_block(params)
            for _ in range(steps // ROLLOUT_GRAPH_STEPS):
                *state, obs = block(*state, obs, *pe, *params.values())
            # the graph's outputs are overwritten by its next replay
            state, obs = SpinSystemState(*(x.clone() for x in state)), obs.clone()
            steps %= ROLLOUT_GRAPH_STEPS
        return self._greedy_steps(params, pe, state, obs, steps)[0]

    def evaluate(self, params: Params, graph: Graph, generator: Optional[torch.Generator] = None,
                 num_envs: Optional[int] = None) -> float:
        """Greedy rollouts on one graph; the best cut found. With `num_envs`
        above the env's batch, ceil(num_envs / batch) rollouts run one after
        another."""
        env = self.env
        pe = env.params_from_graph(graph, device=self.device)
        gen = generator if generator is not None else torch.Generator(device=self.device).manual_seed(0)
        chunks = max(1, -(-(num_envs or env.config.num_envs) // env.config.num_envs))
        return max(float(self._greedy_rollout(params, pe, gen).best_score.max()) for _ in range(chunks))

    def evaluate_scan(self, params: Params, graph: Graph, generator: Optional[torch.Generator] = None,
                      num_restarts: int = 1, spins=None, cuda_graph: bool = True) -> float:
        """Greedy rollouts over `max_steps` from `num_restarts` resets drawn
        from `generator` (or the injected reset spins, [R, B, N]); the best
        cut found. The final env state of the best restart stays in
        `self.last_eval_state`. On the card the rollout replays CUDA graphs
        of ROLLOUT_GRAPH_STEPS steps unless `cuda_graph=False`."""
        pe = self.env.params_from_graph(graph, device=self.device)
        gen = generator if generator is not None else torch.Generator(device=self.device).manual_seed(0)
        restarts = [None] * num_restarts if spins is None else list(spins)
        best, best_state = -np.inf, None
        for s in restarts:
            state = self._greedy_rollout(params, pe, gen, spins=s, cuda_graph=cuda_graph)
            v = float(state.best_score.max())
            if v > best:
                best, best_state = v, state
        self.last_eval_state = best_state
        return best
