"""dREINFORCE / L2A, instance-wise (counterpart of `rlsolver_tpu/algos/l2a.py`;
RLSolver's `L2A/demo_instance.py:25-278`).

  stage 1: pretrain a graph-embedding transformer by reconstructing the
           instance's adjacency from copies with 10% of the edges dropped,
           and freeze its per-node features `seq_graph`;
  stage 2: PPO-style improvement. Each rollout step maps the incumbents to
           per-node probabilities, redraws the `top_k` least certain bits
           into `num_repeats` candidates per incumbent (the last group
           redraws `top_k` random bits at p = 0.5), refines every candidate
           with the env's local search (or, with `fused_ls`, with
           `fused_sweeps` noisy packed sweeps), and keeps the best of each
           group where it improves the incumbent. The rewards (improvements)
           and log-probabilities then feed `update_times` PPO minibatches:
           GAE with gamma = 1, the clipped surrogate, an entropy term in
           log2 and a Huber critic.

On the card the local search ends in the 1-flip sweep K10 (f32 gains), or
with `packed_sweep` (the CLI's `--fast`) in K5/K8a/K8b on integer weights;
`fused_ls` runs K4, K6 or K7 through `FusedSweepEngine`. The transformer is
plain tensor code, as XLA code in the JAX package.

`solve_maxcut_l2a` and `solve_maxcut_l2a_runner` share their setup
(`_l2a_setup`); the runner takes one iteration (`seq_len` rollout steps and
the PPO update) as a step of `train.runner.TrainLoop`, with checkpoint and
resume, `metrics.jsonl` and the stop sentinel.

The data-parallel form (`_build_l2a_steps(..., group=)`,
`data_parallel_iteration`; S2V_PPO's DDP pattern) shards the sims over the
ranks of a `parallel` mesh: each rank runs its own rollout steps and
minibatches from a generator of its own (`__graft_entry__.py` folds the
shard index into the whole step's key), the advantage normalisation stays
per rank, and each minibatch's gradients are `pmean`'d (one flat all-reduce)
before the clip and Adam. The local search on each rank ends in K10.

The distribution-wise variant is `algos/l2a_distribution.py`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from rlsolver_tpu_torch.algos.mcpg import _kernel_seed
from rlsolver_tpu_torch.core.graph import Graph
from rlsolver_tpu_torch.core.result import write_graph_result
from rlsolver_tpu_torch.device import resolve_device
from rlsolver_tpu_torch.envs.maxcut import MaxcutEnv
from rlsolver_tpu_torch.eval.evaluator import Evaluator
from rlsolver_tpu_torch.models.transformer import GraphEncoder, PolicyTrsWithValue, solution_to_prob_channels
from rlsolver_tpu_torch.ops.kernels.engine import FusedSweepEngine
from rlsolver_tpu_torch.ops.reductions import pick_xs_by_vs, update_xs_by_vs
from rlsolver_tpu_torch.ops.sampling import sub_set_sampling
from rlsolver_tpu_torch.optim import ClippedAdam
from rlsolver_tpu_torch.parallel import mesh as mesh_lib


@dataclasses.dataclass
class L2AConfig:
    num_sims: int = 256
    num_repeats: int = 8
    top_k: int = 16  # uncertain bits resampled per step
    num_searchers: int = 2  # local-search rounds per candidate batch
    seq_len: int = 16  # rollout length per iteration
    num_iters: int = 8
    embed_dim: int = 64
    num_heads: int = 4
    pretrain_steps: int = 200
    pretrain_lr: float = 1e-3
    lr: float = 1e-4
    gae_lambda: float = 0.98
    ratio_clip: float = 0.25
    lambda_entropy: float = 0.02
    update_times: int = 16  # PPO minibatches per iteration
    prob_noise: float = 0.02  # exploration noise on policy probs
    ls_iters: int = 4
    ls_num_spin: int = 8
    seed: int = 0
    packed_sweep: bool = False  # packed 1-flip kernels (K5, K8a, K8b) on integer weights
    # fused_ls: replace the local search of the rollout step by
    # `fused_sweeps` noisy degree-ordered packed sweeps over all candidates
    # (K4, K6 or K7 through FusedSweepEngine)
    fused_ls: bool = False
    fused_sweeps: int = 8


# ---------------------------------------------------------------- pretraining
def pretrain_step(enc: GraphEncoder, opt: ClippedAdam, adj: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """One Adam step on the reconstruction loss of adj [N, N] from
    adj * keep * keep^T (keep bool [N, N]). Returns the loss."""
    recon, _ = enc((adj * keep * keep.T)[None])
    loss = F.binary_cross_entropy_with_logits(recon[0], (adj > 0).to(torch.float32))
    opt.zero_grad()
    loss.backward()
    opt.step()
    return loss.detach()


def pretrain_graph_encoder(graph: Graph, cfg: L2AConfig, gen: torch.Generator, device=None):
    """Pretrains a fresh encoder for `cfg.pretrain_steps` steps (plain Adam,
    no clipping, as the JAX package). Returns (encoder, frozen seq_graph
    [N, D])."""
    dev = resolve_device(device)
    n = graph.num_nodes
    enc = GraphEncoder(n, cfg.embed_dim, cfg.num_heads, seed=_kernel_seed(gen), device=dev)
    adj = torch.from_numpy(graph.adjacency_dense()).to(dev)
    opt = ClippedAdam(enc.parameters(), cfg.pretrain_lr, max_norm=None)
    for _ in range(cfg.pretrain_steps):
        pretrain_step(enc, opt, adj, torch.rand(n, n, generator=gen, device=dev) < 0.9)
    with torch.no_grad():
        seq_graph = enc.embed(adj[None])[0]
    return enc, seq_graph


# -------------------------------------------------------------------- trainer
class RolloutBatch(NamedTuple):
    states: torch.Tensor  # bool [T+1, B, N]
    rewards: torch.Tensor  # f32 [T, B]
    logprobs: torch.Tensor  # f32 [T, B]


class RolloutDraws(NamedTuple):
    """A rollout step's draws in place of the generator's: the policy noise
    f32 [B, N] (standard normals), `sub_set_sampling`'s uniforms f32
    [R * B, top_k], the exploration group's positions int [B, k] and bits
    bool [B, k], and each searcher's local-search normals f32
    [num_searchers, ls_iters + 1, R * B, N]."""

    noise: torch.Tensor
    u: torch.Tensor
    rand_ids: torch.Tensor
    explore: torch.Tensor
    ls: torch.Tensor


class L2ASteps(NamedTuple):
    rollout_step: Callable
    ppo_update: Callable


def gae_advantages(rewards: torch.Tensor, values: torch.Tensor, lam: float) -> torch.Tensor:
    """GAE with gamma = 1 over [T, B] (RLSolver's `get_advantages`): from the
    last step back, adv_t = r_t + v_{t+1} - v_t + lam adv_{t+1}, with
    v_T = adv_T = 0."""
    adv = torch.zeros_like(rewards[0])
    next_value = torch.zeros_like(rewards[0])
    out = torch.empty_like(rewards)
    for t in range(rewards.shape[0] - 1, -1, -1):
        adv = rewards[t] + next_value - values[t] + lam * adv
        next_value = values[t]
        out[t] = adv
    return out


def _build_l2a_steps(env: MaxcutEnv, net: PolicyTrsWithValue, seq_graph: torch.Tensor, cfg: L2AConfig,
                     optimizer: ClippedAdam, engine: Optional[FusedSweepEngine] = None, group=None) -> L2ASteps:
    """The two steps of the dREINFORCE loop: one policy-guided improvement
    step and the PPO update. `group` (a `parallel` mesh or process group)
    `pmean`s each minibatch's gradients over its ranks, each of which holds
    its own sims."""
    dev = env.device

    @torch.no_grad()
    def rollout_step(gen: Optional[torch.Generator], best_xs: torch.Tensor, best_vs: torch.Tensor,
                     draws: Optional[RolloutDraws] = None):
        """-> (new_xs, new_vs, reward [B], logprob [B]). The draws come from
        `gen` unless `draws` gives them (not with `fused_ls`)."""
        logits, _ = net(solution_to_prob_channels(best_xs), seq_graph)
        probs = torch.softmax(logits, dim=-1)[..., 0]
        z = torch.randn(probs.shape, generator=gen, device=dev) if draws is None else draws.noise.to(dev)
        probs = torch.clamp(probs + z * cfg.prob_noise, 0.0, 1.0)
        full_xs = sub_set_sampling(gen, probs, best_xs, cfg.num_repeats, cfg.top_k,
                                   u=None if draws is None else draws.u.to(dev))
        if cfg.num_repeats > 1:
            # exploration group: the last repeat redraws k random bits at
            # p = 0.5, so a confident but wrong policy cannot stall on its
            # own least certain bits
            s, n_bits = best_xs.shape
            k_e = min(cfg.top_k, n_bits)
            if draws is None:
                rand_ids = torch.randint(0, n_bits, (s, k_e), generator=gen, device=dev)
                bits = torch.rand(s, k_e, generator=gen, device=dev) < 0.5
            else:
                rand_ids, bits = draws.rand_ids.to(dev).long(), draws.explore.to(dev)
            explore = best_xs.clone()
            explore[torch.arange(s, device=dev)[:, None], rand_ids] = bits
            full_xs[(cfg.num_repeats - 1) * s :] = explore
        if engine is not None:
            full_xs = engine.sweep(_kernel_seed(gen), full_xs, cfg.fused_sweeps)
            full_vs = env.obj(full_xs)
        else:
            full_vs = env.obj(full_xs)
            for i in range(cfg.num_searchers):
                full_xs, full_vs = env.local_search(gen, full_xs, full_vs, num_iters=cfg.ls_iters,
                                                    num_spin=cfg.ls_num_spin,
                                                    noise=None if draws is None else draws.ls[i])
        good_xs, good_vs = pick_xs_by_vs(full_xs, full_vs, cfg.num_repeats)
        new_xs, new_vs = update_xs_by_vs(best_xs, best_vs, good_xs, good_vs)
        p_taken = torch.clamp(torch.where(new_xs, probs, 1 - probs), 0.005, 0.995)
        return new_xs, new_vs, new_vs - best_vs, torch.sum(torch.log(p_taken), dim=1)

    def ppo_update(gen: Optional[torch.Generator], batch: RolloutBatch,
                   ids: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """`cfg.update_times` minibatches of num_sims transitions drawn with
        replacement from the T * num_sims of `batch` (flat index i is step
        i % T of sim i // T), from `gen` or as `ids` gives them. Returns the
        losses [update_times]."""
        states, rewards, logprobs = batch
        seq_len, num_sims = rewards.shape
        with torch.no_grad():
            values = torch.stack([net(solution_to_prob_channels(x), seq_graph)[1] for x in states[:-1]])
            advantages = gae_advantages(rewards, values, cfg.gae_lambda)
            reward_sums = advantages + values
            advantages = (advantages - advantages.mean()) / (advantages.std(correction=0) + 1e-5)
        losses = []
        for u in range(cfg.update_times):
            idx = ids[u] if ids is not None else torch.randint(0, seq_len * num_sims, (num_sims,), generator=gen,
                                                               device=dev)
            t_ids, b_ids = idx % seq_len, idx // seq_len
            logits, value = net(solution_to_prob_channels(states[t_ids, b_ids]), seq_graph)
            logp2 = torch.log_softmax(logits, dim=-1)  # [b, N, 2]
            new_logprob = torch.sum(torch.where(states[t_ids + 1, b_ids], logp2[..., 0], logp2[..., 1]), dim=-1)
            p2 = torch.softmax(logits, dim=-1)
            entropy = torch.mean(torch.sum(p2 * torch.log2(torch.clamp(p2, 1e-9, 1.0)), dim=-1), dim=-1)
            obj_critic = F.huber_loss(value, reward_sums[t_ids, b_ids], delta=1.0)
            ratio = torch.exp(torch.clamp(new_logprob - logprobs[t_ids, b_ids], -12.0, 12.0))
            advantage = advantages[t_ids, b_ids]
            surr = torch.minimum(advantage * ratio,
                                 advantage * torch.clamp(ratio, 1 - cfg.ratio_clip, 1 + cfg.ratio_clip))
            obj_policy = surr.mean() + entropy.mean() * cfg.lambda_entropy
            loss = obj_critic - obj_policy  # maximise the surrogate
            optimizer.zero_grad()
            loss.backward()
            mesh_lib.pmean_grads(optimizer.params, group)
            optimizer.step()
            losses.append(loss.detach())
        return torch.stack(losses)

    return L2ASteps(rollout_step, ppo_update)


class _Timings:
    """Seconds of named sections into a dict, the device synchronised at
    each boundary; does nothing without a dict."""

    def __init__(self, dev: torch.device, out: Optional[Dict[str, List[float]]]):
        self.dev, self.out = dev, out

    def tick(self) -> float:
        if self.out is None:
            return 0.0
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        return time.time()

    def lap(self, key: str, t0: float) -> None:
        if self.out is not None:
            self.out.setdefault(key, []).append(self.tick() - t0)


class L2ASetup(NamedTuple):
    env: MaxcutEnv
    gen: torch.Generator
    net: PolicyTrsWithValue
    optimizer: ClippedAdam
    steps: L2ASteps


def _l2a_setup(graph: Graph, cfg: L2AConfig, dev: torch.device, timings: Optional[_Timings] = None,
               group=None) -> L2ASetup:
    """What the solve and the runner share: the env (and with `fused_ls`
    the sweep engine), the generator seeded `cfg.seed`, the pretrained
    encoder's features, the policy net, its optimizer and the two steps.
    The generator is drawn from by the pretraining, then for the net's
    seed. With `group` every rank takes rank 0's features and net (a
    broadcast) and the steps `pmean` the gradients."""
    timings = timings or _Timings(dev, None)
    env = MaxcutEnv(graph, dev, packed_sweep=cfg.packed_sweep)
    engine = FusedSweepEngine.build(graph, dev) if cfg.fused_ls else None
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed)
    t0 = timings.tick()
    _, seq_graph = pretrain_graph_encoder(graph, cfg, gen, dev)
    timings.lap("pretrain", t0)
    net = PolicyTrsWithValue(cfg.embed_dim, cfg.num_heads, seed=_kernel_seed(gen), device=dev)
    mesh_lib.replicated([seq_graph, net], group)
    optimizer = ClippedAdam(net.parameters(), cfg.lr)
    return L2ASetup(env, gen, net, optimizer, _build_l2a_steps(env, net, seq_graph, cfg, optimizer, engine, group))


def _rollout(steps: L2ASteps, gen: torch.Generator, best_xs: torch.Tensor, best_vs: torch.Tensor, seq_len: int,
             timings: _Timings):
    """`seq_len` rollout steps from the incumbents -> (new xs, new vs, the
    steps' RolloutBatch)."""
    states, rewards, logprobs = [best_xs], [], []
    for _ in range(seq_len):
        t0 = timings.tick()
        best_xs, best_vs, reward, logprob = steps.rollout_step(gen, best_xs, best_vs)
        timings.lap("rollout", t0)
        states.append(best_xs)
        rewards.append(reward)
        logprobs.append(logprob)
    return best_xs, best_vs, RolloutBatch(torch.stack(states), torch.stack(rewards), torch.stack(logprobs))


def data_parallel_iteration(steps: L2ASteps, gen: Optional[torch.Generator], best_xs: torch.Tensor,
                            best_vs: torch.Tensor, seq_len: int, draws: Optional[Sequence[RolloutDraws]] = None,
                            ids: Optional[Sequence[torch.Tensor]] = None):
    """One iteration of data-parallel dREINFORCE on this rank's sims
    (`__graft_entry__.py`'s sharded `l2a_step`): `seq_len` rollout steps,
    then the PPO update of `steps` (built with the group), from this rank's
    generator unless `draws` (one a step) and `ids` (one a minibatch) give
    the draws. Returns (new xs, new vs, the update's losses)."""
    states, rewards, logprobs = [best_xs], [], []
    for t in range(seq_len):
        best_xs, best_vs, reward, logprob = steps.rollout_step(gen, best_xs, best_vs,
                                                               draws=None if draws is None else draws[t])
        states.append(best_xs)
        rewards.append(reward)
        logprobs.append(logprob)
    batch = RolloutBatch(torch.stack(states), torch.stack(rewards), torch.stack(logprobs))
    return best_xs, best_vs, steps.ppo_update(gen, batch, ids=ids)


def solve_maxcut_l2a(
    graph: Graph,
    cfg: L2AConfig = L2AConfig(),
    instance_file: Optional[str] = None,
    save_dir: Optional[str] = None,
    verbose: bool = False,
    time_budget: Optional[float] = None,
    device=None,
    timings: Optional[Dict[str, List[float]]] = None,
):
    """Instance-wise dREINFORCE. Returns (best_x np.bool_[n], best_v float,
    evaluator). Runs on `cuda` unless `device="cpu"`. `time_budget` (seconds
    after pretraining) stops the iteration loop early. A `timings` dict is
    filled with the seconds of pretraining ("pretrain") and of each rollout
    step ("rollout") and PPO update ("ppo"), the device synchronised at each
    boundary."""
    dev = resolve_device(device)
    clock = _Timings(dev, timings)
    env, gen, _, _, steps = _l2a_setup(graph, cfg, dev, clock)
    n = graph.num_nodes

    best_xs = env.random_xs(gen, cfg.num_sims)
    best_vs = env.obj(best_xs)
    evaluator = Evaluator(save_dir, n, best_xs[0].cpu().numpy(), float(best_vs[0]), True)
    start = time.time()
    for iter_i in range(cfg.num_iters):
        best_xs, best_vs, batch = _rollout(steps, gen, best_xs, best_vs, cfg.seq_len, clock)
        t0 = clock.tick()
        losses = steps.ppo_update(gen, batch)
        clock.lap("ppo", t0)
        evaluator.record(iter_i + 1, best_vs.cpu().numpy(), best_xs.cpu().numpy())
        if verbose:
            print(evaluator.log_line(iter_i + 1, f"ppo_loss {float(losses.mean()):.4f}"))
        if time_budget is not None and time.time() - start > time_budget:
            break

    evaluator.save()
    if instance_file is not None:
        write_graph_result(evaluator.best_v, time.time() - start, n, "dreinforce_l2a",
                           evaluator.best_x.astype(int), instance_file)
    return evaluator.best_x, evaluator.best_v, evaluator


class L2ALoopState(NamedTuple):
    """The whole resumable state of the TrainLoop-driven dREINFORCE run."""

    params: Dict[str, torch.Tensor]  # the policy net's state dict
    opt_state: dict  # ClippedAdam.state_dict()
    generator: torch.Generator
    best_xs: torch.Tensor  # bool [num_sims, N]
    best_vs: torch.Tensor  # f32 [num_sims]


def solve_maxcut_l2a_runner(
    graph: Graph,
    cfg: L2AConfig = L2AConfig(),
    run_dir: str = "runs/l2a",
    checkpoint_every: int = 0,
    resume: bool = False,
    log_every: int = 1,
    device=None,
    timings: Optional[Dict[str, List[float]]] = None,
):
    """Instance-wise dREINFORCE through `train.runner.TrainLoop`: a step is
    one iteration (`seq_len` rollout steps, then the PPO update) over
    `cfg.num_iters` steps, with checkpoint and resume of the full state, the
    `metrics.jsonl` stream (`best_cut`, `mean_cut`, `ppo_loss`) and the stop
    sentinel. The generator is drawn from as in `solve_maxcut_l2a`, whose
    incumbents it reaches over the same iterations. `timings` as in the
    solve. Runs on `cuda` unless `device="cpu"`. Returns (best_x
    np.bool_[n], best_v, final state)."""
    from rlsolver_tpu_torch.train.runner import LoopConfig, TrainLoop

    dev = resolve_device(device)
    clock = _Timings(dev, timings)
    env, gen, net, optimizer, steps = _l2a_setup(graph, cfg, dev, clock)

    def step_fn(state: L2ALoopState):
        net.load_state_dict(state.params)
        optimizer.load_state_dict(state.opt_state)
        best_xs, best_vs, batch = _rollout(steps, state.generator, state.best_xs, state.best_vs, cfg.seq_len, clock)
        t0 = clock.tick()
        losses = steps.ppo_update(state.generator, batch)
        clock.lap("ppo", t0)
        metrics = {"best_cut": best_vs.max(), "mean_cut": best_vs.mean(), "ppo_loss": losses.mean()}
        params = {k: v.detach().clone() for k, v in net.state_dict().items()}
        return L2ALoopState(params, optimizer.state_dict(), state.generator, best_xs, best_vs), metrics

    best_xs = env.random_xs(gen, cfg.num_sims)
    params = {k: v.detach().clone() for k, v in net.state_dict().items()}
    state = L2ALoopState(params, optimizer.state_dict(), gen, best_xs, env.obj(best_xs))
    loop = TrainLoop(LoopConfig(run_dir=run_dir, total_steps=cfg.num_iters, log_every=log_every,
                                checkpoint_every=checkpoint_every, resume=resume,
                                samples_per_step=cfg.seq_len * cfg.num_sims * cfg.num_repeats), step_fn)
    state = loop.run(state)
    top = int(torch.argmax(state.best_vs))
    return state.best_xs[top].cpu().numpy(), float(state.best_vs[top]), state
