"""MCPG: Monte Carlo Policy Gradient for maxcut (counterpart of
`rlsolver_tpu/algos/mcpg.py`; RLSolver `MCPG.py:322-457`).

One round:
  1. sample: Metropolis bit-flip chains from the Bernoulli policy over
     repeat_times * total_mcmc_num chains, then `num_ls` degree-ordered
     local-search sweeps, then the cut of every chain;
  2. reduce: best of repeats per chain, per-chain elitist update, the worst
     chain replaced by the global best;
  3. update: REINFORCE on the pre-sweep samples with the swept cuts as the
     value, `sample_epoch_num` steps of clipped Adam.

Chains are laid out [repeat_times * total_mcmc_num, N], repeat r of chain c
at row r * C + c. With `sampler="fused"` and `sweep_mode="packed"` (the CLI's
`--fast`) the sampler runs the packed CUDA kernel K3 and the sweeps the one
`FusedSweepEngine` picks: K4 on {0, +-1}-weight graphs, K6 or K7 on other
integer weights. Whenever `sweep_mode="packed"` the warm start's local search
ends in K5, K8a or K8b. On non-integer weights `sweep_mode="packed"` raises
ValueError, as in the JAX package. `sweep_mode="colored"` updates one color
class of `Graph.greedy_coloring` at a time from one f32 GEMM (`colored_sweep`).

`solve_maxcut_mcpg_runner` runs the same rounds through `train.runner.TrainLoop`:
checkpoint and resume of the whole state (policy, Adam state, generator,
incumbents, restart rows), `metrics.jsonl` and the stop sentinel.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from rlsolver_tpu_torch.core.graph import Graph
from rlsolver_tpu_torch.core.result import write_graph_result
from rlsolver_tpu_torch.device import resolve_device, synchronize
from rlsolver_tpu_torch.envs.maxcut import MaxcutEnv
from rlsolver_tpu_torch.eval.evaluator import Evaluator
from rlsolver_tpu_torch.models.policy import BernoulliPolicy
from rlsolver_tpu_torch.ops.kernels.engine import FusedSweepEngine
from rlsolver_tpu_torch.ops.kernels.mh_sampler import mh_sample_fused
from rlsolver_tpu_torch.ops.reductions import pick_xs_by_vs, update_xs_by_vs
from rlsolver_tpu_torch.ops.sampling import metropolis_bitflip_chain
from rlsolver_tpu_torch.ops.sweeps import SweepData, colored_sweep, degree_ordered_sweep, mcpg_init_values
from rlsolver_tpu_torch.optim import ClippedAdam


@dataclasses.dataclass
class MCPGConfig:
    total_mcmc_num: int = 256  # parallel chains C
    repeat_times: int = 32  # repeats R per chain
    num_ls: int = 8  # local-search sweeps per sample round
    max_epoch_num: int = 3
    reset_epoch_num: int = 64  # sample rounds per epoch ~ reset/sample
    sample_epoch_num: int = 8  # SGD steps per sample round
    lr: float = 8e-2
    change_times: Optional[int] = None  # MH accept budget per chain; default N/10
    warmup_ls_rounds: int = 4  # incumbent warm start via parallel local search
    seed: int = 0
    # "sequential" (gathers) | "colored" (a class at a time, one GEMM each) | "packed" (kernels K4, K6, K7)
    sweep_mode: str = "sequential"
    # "budgeted" (reference accept budget) | "fused" (kernel K3, 2 * change_times rounds)
    sampler: str = "budgeted"


# Per-instance presets, as in the JAX package (`mcpg.py:67-91`). The JAX
# package cut `repeat_times` to fit a 16 GB TPU; GSET_PRESETS_40G holds the
# reference's own counts for a 40 GB card, which an 80 GB H100 holds.
GSET_PRESETS = {
    "gset_14": MCPGConfig(total_mcmc_num=512, repeat_times=128, num_ls=8,
                          reset_epoch_num=128, max_epoch_num=30),
    "gset_22": MCPGConfig(total_mcmc_num=2048, repeat_times=224, num_ls=8,
                          reset_epoch_num=256, max_epoch_num=30),
    "gset_55": MCPGConfig(total_mcmc_num=1024, repeat_times=192, num_ls=8,
                          reset_epoch_num=192, max_epoch_num=30),
    "gset_70": MCPGConfig(total_mcmc_num=768, repeat_times=96, num_ls=8,
                          reset_epoch_num=320, max_epoch_num=30),
}

GSET_PRESETS_40G = {
    "gset_14": GSET_PRESETS["gset_14"],
    "gset_22": dataclasses.replace(GSET_PRESETS["gset_22"], repeat_times=512),
    "gset_55": dataclasses.replace(GSET_PRESETS["gset_55"], repeat_times=448),
    "gset_70": dataclasses.replace(GSET_PRESETS["gset_70"], repeat_times=288),
}


def preset_for(instance_name: str) -> MCPGConfig:
    """Tuned config for a gset instance; default config otherwise."""
    for key, cfg in GSET_PRESETS.items():
        if key in instance_name:
            return cfg
    return MCPGConfig()


class Steps(NamedTuple):
    sample_step: Callable
    reduce_step: Callable
    update_step: Callable


def _kernel_seed(gen: torch.Generator) -> int:
    return int(torch.randint(0, 2**31 - 1, (1,), generator=gen, device=gen.device))


def _value_statistics(values: torch.Tensor, bits: torch.Tensor, chunk: int = 1 << 16):
    """(A, V): A[n] = sum_b values[b] * bits[b, n] and V = sum_b values[b],
    in f32, a chunk of rows at a time."""
    a = torch.zeros(bits.shape[1], dtype=torch.float32, device=bits.device)
    for i in range(0, bits.shape[0], chunk):
        a += values[i : i + chunk] @ bits[i : i + chunk].to(torch.float32)
    return a, values.sum()


def _build_steps(env: MaxcutEnv, data: Optional[SweepData], cfg: MCPGConfig) -> Steps:
    num_nodes = env.num_nodes
    R = cfg.repeat_times
    change_times = cfg.change_times or max(1, num_nodes // 10)
    rounds = max(cfg.num_ls, 2 * change_times)
    if cfg.sampler not in ("budgeted", "fused"):
        raise ValueError(f"unknown sampler {cfg.sampler!r}")
    if cfg.sweep_mode == "packed":
        engine = FusedSweepEngine.build(env.graph, env.device)
    elif cfg.sweep_mode not in ("sequential", "colored"):
        raise ValueError(f"unknown sweep_mode {cfg.sweep_mode!r}")

    def sample_step(gen, probs, start_bits):
        """start_bits bool [R*C, N] -> (mh_samples, ls_bits, cuts [R*C])."""
        if cfg.sampler == "fused":
            mh = mh_sample_fused(_kernel_seed(gen), probs, start_bits, rounds)
        else:
            mh = metropolis_bitflip_chain(gen, probs, start_bits, change_times).samples
        if cfg.sweep_mode == "packed":
            ls_bits = engine.sweep(_kernel_seed(gen), mh, cfg.num_ls)
        elif cfg.sweep_mode == "sequential":
            xt = degree_ordered_sweep(gen, mcpg_init_values(mh), data, num_sweeps=cfg.num_ls)
            ls_bits = xt[:, :num_nodes] > 0.5
        else:
            xs = colored_sweep(gen, mh.to(torch.float32), env.cg.adj, env.cg.deg_w, data.color_masks,
                               num_sweeps=cfg.num_ls)
            ls_bits = xs > 0.5
        return mh, ls_bits, env.obj(ls_bits)

    def reduce_step(ls_bits, cuts, best_xs, best_vs):
        """Best-of-repeats per chain + per-chain elitist + worst <- best.
        Returns (best_xs, best_vs, restart bits [R*C, N])."""
        chain_xs, chain_vs = pick_xs_by_vs(ls_bits, cuts, R)
        best_xs, best_vs = update_xs_by_vs(best_xs, best_vs, chain_xs, chain_vs)
        top, worst = torch.argmax(best_vs), torch.argmin(best_vs)
        best_xs[worst] = best_xs[top]
        best_vs[worst] = best_vs[top]
        return best_xs, best_vs, chain_xs.repeat(R, 1)

    def update_step(policy: BernoulliPolicy, optimizer: ClippedAdam, mh_samples, cuts):
        """`sample_epoch_num` Adam steps on the loss mean_b(logp_b * value_b),
        value = centered energy total_w - 2 cut. The loss is linear in the
        samples, so it is formed from A = value @ bits and V = sum(value):
        sum_n A_n log p_n + (V - A_n) log(1 - p_n), over B, which equals the
        mean over the [B, N] log-probabilities up to f32 rounding."""
        energy = env.cg.total_w - 2.0 * cuts
        value = energy - torch.mean(energy)
        a, v = _value_statistics(value, mh_samples)
        for _ in range(cfg.sample_epoch_num):
            probs = policy()
            loss = torch.sum(a * torch.log(probs) + (v - a) * torch.log(1.0 - probs)) / mh_samples.shape[0]
            optimizer.zero_grad()
            loss.backward()
            optimizer.step()

    return Steps(sample_step, reduce_step, update_step)


def new_policy(num_nodes: int, cfg: MCPGConfig, device):
    """A fresh policy (logits 0) and its optimizer (zero state)."""
    policy = BernoulliPolicy(num_nodes, device=device)
    return policy, ClippedAdam(policy.parameters(), cfg.lr)


def _warm_start(env: MaxcutEnv, gen: torch.Generator, cfg: MCPGConfig):
    """The incumbents' warm start: parallel local search on C chains
    (MCPG.py:342-348). Returns (xs bool [C, N], vs f32 [C])."""
    xs = env.random_xs(gen, cfg.total_mcmc_num)
    vs = env.obj(xs)
    for _ in range(cfg.warmup_ls_rounds):
        xs, vs = env.local_search(gen, xs, vs)
    return xs, vs


def _round(steps: Steps, gen: torch.Generator, policy: BernoulliPolicy, optimizer: ClippedAdam, start_bits,
           best_xs, best_vs, sps_log: Optional[list] = None):
    """One MCPG round, the body that the solve and the runner share so that
    they draw alike: sample from the policy at the restart rows, reduce into
    the incumbents, then the policy's Adam steps. With `sps_log`, appends
    the samples per second of the sample and reduce steps. Returns (cuts,
    best_xs, best_vs, restart bits [R*C, N])."""
    t0 = time.time()
    with torch.no_grad():
        probs = policy()
    mh, ls_bits, cuts = steps.sample_step(gen, probs, start_bits)
    best_xs, best_vs, restart = steps.reduce_step(ls_bits, cuts, best_xs, best_vs)
    if sps_log is not None:
        synchronize()
        sps_log.append(start_bits.shape[0] / (time.time() - t0))
    steps.update_step(policy, optimizer, mh, cuts)
    return cuts, best_xs, best_vs, restart


def solve_maxcut_mcpg(
    graph: Graph,
    cfg: MCPGConfig = MCPGConfig(),
    instance_file: Optional[str] = None,
    save_dir: Optional[str] = None,
    verbose: bool = False,
    time_budget: Optional[float] = None,
    device=None,
):
    """Returns (best_x np.bool_[n], best_v float, evaluator). Runs on `cuda`
    unless `device="cpu"`. `time_budget` (seconds of wall clock after the
    warm start) stops the epoch loop early."""
    dev = resolve_device(device)
    # packed sweep_mode also runs the warm start's 1-flip sweep on K5 or K8
    env = MaxcutEnv(graph, dev, packed_sweep=cfg.sweep_mode == "packed")
    data = SweepData.build(graph, dev) if cfg.sweep_mode != "packed" else None
    R = cfg.repeat_times
    steps = _build_steps(env, data, cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed)

    best_xs, best_vs = _warm_start(env, gen, cfg)

    evaluator = Evaluator(save_dir, graph.num_nodes, best_xs[0].cpu().numpy(), float(best_vs[0]), True)
    start = time.time()
    start_bits = best_xs.repeat(R, 1)
    rounds_per_epoch = max(1, cfg.reset_epoch_num // cfg.sample_epoch_num)
    sps_log = []
    stop = False
    for epoch in range(cfg.max_epoch_num):
        policy, optimizer = new_policy(graph.num_nodes, cfg, dev)  # per-epoch reset
        for j in range(rounds_per_epoch):
            _, best_xs, best_vs, start_bits = _round(steps, gen, policy, optimizer, start_bits, best_xs, best_vs,
                                                     sps_log)
            top = int(torch.argmax(best_vs))
            evaluator.record(epoch * rounds_per_epoch + j + 1, float(best_vs[top]), best_xs[top].cpu().numpy())
            if verbose and j % 8 == 0:
                print(evaluator.log_line(j, f"samples/s {sps_log[-1]:.0f}"))
            stop = time_budget is not None and time.time() - start > time_budget
            if stop:
                break
        if stop:
            break
    evaluator.save()

    if instance_file is not None:
        write_graph_result(
            evaluator.best_v,
            time.time() - start,
            graph.num_nodes,
            "mcpg",
            evaluator.best_x.astype(int),
            instance_file,
            info={"samples_per_second": float(np.mean(sps_log[1:]) if len(sps_log) > 1 else 0)},
        )
    return evaluator.best_x, evaluator.best_v, evaluator


class MCPGLoopState(NamedTuple):
    """The whole resumable state of the TrainLoop-driven MCPG run. The
    restart rows of a round are R copies of the chains' best-of-repeats
    (`reduce_step`), so the state keeps the [C, N] rows and the step repeats
    them: a checkpoint holds 2 C N bits of chains, not (R + 1) C N."""

    logits: torch.Tensor  # f32 [N], the policy
    opt_state: dict  # ClippedAdam.state_dict()
    generator: torch.Generator
    best_xs: torch.Tensor  # bool [C, N], per-chain incumbents
    best_vs: torch.Tensor  # f32 [C]
    start_xs: torch.Tensor  # bool [C, N], the next round's restart rows
    round_idx: int


def solve_maxcut_mcpg_runner(
    graph: Graph,
    cfg: MCPGConfig = MCPGConfig(),
    run_dir: str = "runs/mcpg",
    total_rounds: Optional[int] = None,
    checkpoint_every: int = 0,
    resume: bool = False,
    log_every: int = 1,
    device=None,
):
    """MCPG through `train.runner.TrainLoop`: checkpoint and resume of the
    full state, the `metrics.jsonl` stream (`best_cut`, `mean_cut`,
    samples/s) and the stop sentinel. The generator is drawn from in the
    order of `solve_maxcut_mcpg`, so over `max_epoch_num * rounds_per_epoch`
    rounds (the default `total_rounds`) the two reach the same incumbents;
    a resumed run continues the uninterrupted one draw for draw. The
    per-epoch policy reset (MCPG.py:366-367) happens at every round with
    `round_idx % rounds_per_epoch == 0`. Runs on `cuda` unless
    `device="cpu"`. Returns (best_x np.bool_[n], best_v, final state)."""
    from rlsolver_tpu_torch.train.runner import LoopConfig, TrainLoop

    dev = resolve_device(device)
    env = MaxcutEnv(graph, dev, packed_sweep=cfg.sweep_mode == "packed")
    data = SweepData.build(graph, dev) if cfg.sweep_mode != "packed" else None
    C, R = cfg.total_mcmc_num, cfg.repeat_times
    steps = _build_steps(env, data, cfg)
    rounds_per_epoch = max(1, cfg.reset_epoch_num // cfg.sample_epoch_num)
    if total_rounds is None:
        total_rounds = cfg.max_epoch_num * rounds_per_epoch

    def step_fn(state: MCPGLoopState):
        policy, optimizer = new_policy(graph.num_nodes, cfg, dev)  # the epoch's reset
        if state.round_idx % rounds_per_epoch:
            with torch.no_grad():
                policy.logits.copy_(state.logits)
            optimizer.load_state_dict(state.opt_state)
        cuts, best_xs, best_vs, restart = _round(steps, state.generator, policy, optimizer, state.start_xs.repeat(R, 1),
                                                 state.best_xs, state.best_vs)
        metrics = {"best_cut": best_vs.max(), "mean_cut": cuts.mean()}
        return MCPGLoopState(policy.logits.detach().clone(), optimizer.state_dict(), state.generator, best_xs,
                             best_vs, restart[:C].clone(), state.round_idx + 1), metrics

    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed)
    best_xs, best_vs = _warm_start(env, gen, cfg)
    policy, optimizer = new_policy(graph.num_nodes, cfg, dev)
    state = MCPGLoopState(policy.logits.detach().clone(), optimizer.state_dict(), gen, best_xs, best_vs,
                          best_xs.clone(), 0)
    loop = TrainLoop(LoopConfig(run_dir=run_dir, total_steps=total_rounds, log_every=log_every,
                                checkpoint_every=checkpoint_every, resume=resume, samples_per_step=R * C), step_fn)
    state = loop.run(state)
    top = int(torch.argmax(state.best_vs))
    return state.best_xs[top].cpu().numpy(), float(state.best_vs[top]), state
