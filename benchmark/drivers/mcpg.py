"""Driver of `rlsolver_tpu_torch.algos.mcpg.solve_maxcut_mcpg`: one call, its
`time_budget` the window's seconds, is the window.

Set-up builds the configuration's instance, loads the kernels' libraries
and makes one warm call at the cell's chain counts (one round). The window
is the whole call, the solver's own table build, warm start and rounds
included; its samples are the rounds it recorded times the chains.

A traced run traces rounds TRACE_FROM to TRACE_TO of the window: a fixed
stretch, so that the profiler's cost does not grow with the window.

The check follows the program step by step from the chains it starts a
round from and the policy it samples from, since the solver keeps them
inside the call:
  * every round: `sampled_rows` chains drawn from the seed, their MH
    samples from the round's start rows, probabilities and seed, their
    swept bits from the program's samples and the sweep's seed, their cuts;
  * the first round whole, from the reference's own start of an epoch (the
    policy's logits 0, Adam's state 0; its probabilities are the ones the
    sampled rows' MH samples are checked with): every chain's cut, the
    reduce and the policy's Adam steps;
  * the warm start's greedy 1-flip sweeps, every chain;
  * the best cut the call returns, re-scored on the host.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from benchmark.compare import diff_gap, first_gradient, norm_gap, rows_differ
from benchmark.faults import adam_noop, patched
from benchmark.harness import Check
from benchmark.reference import graphs as ref_graphs
from benchmark.reference import maxcut as ref


def _program_graph(edges: np.ndarray, n: int, name: str):
    from rlsolver_tpu_torch.core.graph import Graph

    return Graph(n, edges.astype(np.int32), np.ones(edges.shape[0], np.float32), name)


def solver_config(ctx):
    """The traffic's MCPGConfig: a preset with the traffic's overrides and
    the run's seed."""
    from rlsolver_tpu_torch.algos import mcpg

    t = ctx.traffic
    base = getattr(mcpg, t["preset_table"])[t["preset"]]
    return dataclasses.replace(base, seed=ctx.seed, **t.get("overrides", {}))


def setup(ctx) -> dict:
    from rlsolver_tpu_torch.algos import mcpg
    from rlsolver_tpu_torch.ops.kernels import build

    g = ctx.config["graph"]
    edges = ref_graphs.make_edges(g)
    graph = _program_graph(edges, g["num_nodes"], ctx.config["name"])
    cfg = solver_config(ctx)
    if ctx.device == "cuda":
        build.build_all()
    warm = dataclasses.replace(cfg, max_epoch_num=1, reset_epoch_num=cfg.sample_epoch_num)
    mcpg.solve_maxcut_mcpg(graph, warm, device=ctx.device)
    return {"graph": graph, "cfg": cfg, "edges": edges}


class _Capture:
    """What the check reads of the window's call, taken by wrapping the
    solver's round and seed draws (the kernels run as they do unwrapped)."""

    def __init__(self, rows: torch.Tensor):
        self.rows = rows
        self.rounds = []
        self.seeds = []
        self.full = None
        self.flips = []


TRACE_FROM, TRACE_TO = 1, 9  # the traced rounds
FULL_ROUND = 0  # the round checked whole: an epoch's first, whose policy and Adam state start at 0


def _install(cap: _Capture, timed: dict, tracer):
    """Wraps mcpg._round, mcpg._kernel_seed and MaxcutEnv.sweep_1flip for the
    window, and opens and closes the traced rounds; with `timed`, also wraps
    mh_sample_fused and FusedSweepEngine.sweep, each call timed by CUDA
    events. Returns the undo function."""
    from rlsolver_tpu_torch.algos import mcpg
    from rlsolver_tpu_torch.envs.maxcut import MaxcutEnv
    from rlsolver_tpu_torch.ops.kernels.engine import FusedSweepEngine

    saved = [(mcpg, "_round", mcpg._round), (mcpg, "_kernel_seed", mcpg._kernel_seed),
             (MaxcutEnv, "sweep_1flip", MaxcutEnv.sweep_1flip)]
    orig_round, orig_seed, orig_flip = mcpg._round, mcpg._kernel_seed, MaxcutEnv.sweep_1flip
    idx = cap.rows

    def kernel_seed(gen):
        s = orig_seed(gen)
        cap.seeds.append(s)
        return s

    def sweep_1flip(self, xs, vs):
        out = orig_flip(self, xs, vs)
        cap.flips.append((xs.clone(), out[0].clone()))
        return out

    def round_(steps, gen, policy, optimizer, start_bits, best_xs, best_vs, sps_log=None):
        k = len(cap.rounds)
        if k == TRACE_FROM:
            tracer.begin("bench.rounds")
        elif k == TRACE_TO:
            tracer.end()
        full = k == FULL_ROUND
        rec = {"seed_at": len(cap.seeds), "start": start_bits[idx].clone()}
        if full:
            rec.update(best_xs0=best_xs.clone(), best_vs0=best_vs.clone())

        def sample_step(g, probs, sb):
            mh, ls, cuts = steps.sample_step(g, probs, sb)
            rec.update(probs=probs.clone(), mh=mh[idx].clone(), ls=ls[idx].clone(), cuts=cuts[idx].clone())
            if full:
                rec.update(mh_all=mh, ls_all=ls, cuts_all=cuts)
            return mh, ls, cuts

        if full:
            def first_step(corr=None, step=optimizer.step):
                step(corr)
                rec.setdefault("mu1", optimizer.mu[0].clone())
            optimizer.step = first_step
        out = orig_round(steps._replace(sample_step=sample_step), gen, policy, optimizer, start_bits, best_xs,
                         best_vs, sps_log)
        rec["restart"] = out[3][idx].clone()
        if full:
            del optimizer.step
            rec.update(best_xs1=out[1].clone(), best_vs1=out[2].clone(), logits1=policy.logits.detach().clone())
            cap.full = rec
        cap.rounds.append(rec)
        return out

    mcpg._round, mcpg._kernel_seed, MaxcutEnv.sweep_1flip = round_, kernel_seed, sweep_1flip
    if timed is not None:
        saved += [(mcpg, "mh_sample_fused", mcpg.mh_sample_fused), (FusedSweepEngine, "sweep", FusedSweepEngine.sweep)]
        orig_mh, orig_sweep = mcpg.mh_sample_fused, FusedSweepEngine.sweep

        def events(key, fn, shape_of):
            def call(*args):
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                out = fn(*args)
                b.record()
                timed.setdefault(key, []).append((a, b, shape_of(*args)))
                return out
            return call

        mcpg.mh_sample_fused = events("sampler", orig_mh, lambda seed, probs, bits, rounds: (*bits.shape, rounds))
        FusedSweepEngine.sweep = events("sweep", orig_sweep,
                                        lambda self, seed, bits, sweeps, *rest: (*bits.shape, sweeps))

    def undo():
        for obj, name, fn in saved:
            setattr(obj, name, fn)

    return undo


def window(state: dict, ctx, tracer) -> dict:
    from rlsolver_tpu_torch.algos import mcpg

    cfg, graph = state["cfg"], state["graph"]
    chains = cfg.total_mcmc_num * cfg.repeat_times
    rng = np.random.default_rng(ctx.seed)
    w = ctx.checks
    rows = torch.from_numpy(np.sort(rng.choice(chains, size=min(w["sampled_rows"], chains), replace=False)))
    cap = _Capture(rows.to(ctx.device))
    timed = {} if ctx.trace and ctx.device == "cuda" else None
    undo = _install(cap, timed, tracer)
    try:
        t0 = time.perf_counter()
        best_x, best_v, ev = mcpg.solve_maxcut_mcpg(graph, cfg, time_budget=ctx.seconds, device=ctx.device)
        if ctx.device == "cuda":
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    finally:
        undo()
    rounds = len(ev.records) - 1
    readings = {"window_s": window_s, "samples": rounds * chains, "attempted": rounds, "rounds": rounds}
    if timed is not None:
        for key, calls in timed.items():
            readings[f"{key}_calls"] = [(a.elapsed_time(b) / 1e3, shape) for a, b, shape in calls]
        readings["edges"] = int(graph.num_edges)
    return {"readings": readings, "cap": cap, "best_x": best_x, "best_v": best_v, "cfg": cfg,
            "edges": state["edges"], "n": graph.num_nodes}


def outputs(win: dict, g: ref.Graph, device, dtype=torch.float32, program: bool = True) -> dict:
    """The candidate outputs of the checked stages, from their inputs: the
    program's captured outputs, or (program=False) the reference at `dtype`
    put in the program's place."""
    cap, cfg = win["cap"], win["cfg"]
    c, r = cfg.total_mcmc_num, cfg.repeat_times
    if program:
        out = {"mh": torch.cat([x["mh"] for x in cap.rounds]), "ls": torch.cat([x["ls"] for x in cap.rounds]),
               "cuts": torch.cat([x["cuts"] for x in cap.rounds]).double(),
               "flips": [o for _, o in cap.flips[: cfg.warmup_ls_rounds]]}
        if cap.full is not None:
            f = cap.full
            out.update(cuts_all=f["cuts_all"].double(), best_xs=f["best_xs1"], best_vs=f["best_vs1"].double(),
                       restart=f["restart"], logits=f["logits1"],
                       grad=first_gradient(f["mu1"], torch.zeros_like(f["mu1"])))
        return out
    inputs = stage_inputs(win, device)
    out = {"mh": ref.mh_fused(inputs["start"], ref.thresholds(inputs["probs"], dtype), inputs["mh_seeds"],
                              inputs["chains"], inputs["mh_rounds"], dtype),
           "ls": ref.noisy_sweep(inputs["mh"], g, inputs["sweep_seeds"], inputs["chains"], cfg.num_ls, dtype),
           "flips": [ref.flip_sweep(x.to(device), g, dtype) for x, _ in cap.flips[: cfg.warmup_ls_rounds]]}
    out["cuts"] = ref.cuts(inputs["ls"], g, dtype)
    if cap.full is not None:
        f = cap.full
        out["cuts_all"] = ref.cuts(f["ls_all"], g, dtype)
        xs, vs, chain = ref.reduce(f["ls_all"], out["cuts_all"], f["best_xs0"], f["best_vs0"].double(), r)
        out.update(best_xs=xs, best_vs=vs, restart=chain[cap.rows % c])
        a, v = ref.value_statistics(f["mh_all"], out["cuts_all"], g.total, dtype)
        out["logits"], out["grad"] = ref.adam_update(ref_logits0(win, device), ref_adam0(win, device), a, v, r * c,
                                                     cfg.sample_epoch_num, cfg.lr, dtype)
    return out


def ref_logits0(win: dict, device) -> torch.Tensor:
    """The policy's logits at an epoch's start, as the reference has them: 0."""
    return torch.zeros(win["n"], device=device)


def ref_adam0(win: dict, device) -> dict:
    """Adam's state at an epoch's start, as the reference has it: 0."""
    z = torch.zeros(win["n"], device=device)
    return {"count": 0, "mu": z, "nu": z}


def stage_inputs(win: dict, device) -> dict:
    """The inputs of the sampled rows' stages, all rounds stacked; the
    program's probabilities, but in the round checked whole the
    reference's own from its logits at the epoch's start."""
    cap, cfg = win["cap"], win["cfg"]
    n = win["n"]
    k = cap.rows.shape[0]
    rounds = cap.rounds
    per_row = lambda vals: torch.tensor(vals, dtype=torch.int64, device=device).repeat_interleave(k)  # noqa: E731
    change_times = cfg.change_times or max(1, n // 10)
    probs = [x["probs"] for x in rounds]
    if len(probs) > FULL_ROUND:
        probs[FULL_ROUND] = ref.policy_probs(ref_logits0(win, device))
    probs = torch.stack(probs).repeat_interleave(k, dim=0)
    return {"start": torch.cat([x["start"] for x in rounds]), "probs": probs,
            "mh": torch.cat([x["mh"] for x in rounds]), "ls": torch.cat([x["ls"] for x in rounds]),
            "mh_seeds": per_row([cap.seeds[x["seed_at"]] for x in rounds]),
            "sweep_seeds": per_row([cap.seeds[x["seed_at"] + 1] for x in rounds]),
            "chains": cap.rows.to(device).repeat(len(rounds)),
            "mh_rounds": max(cfg.num_ls, 2 * change_times)}


def compare(cand: dict, exp: dict, cap: _Capture, limits: dict) -> list:
    """The numbers the check compares, candidate against the reference."""
    checks = [Check("mh_rows_differ", rows_differ(cand["mh"], exp["mh"]), 0),
              Check("sweep_rows_differ", rows_differ(cand["ls"], exp["ls"]), 0),
              Check("warm_rows_differ", sum(rows_differ(a, b) for a, b in zip(cand["flips"], exp["flips"]))
                    + abs(len(cand["flips"]) - len(exp["flips"])), 0)]
    gap = float((cand["cuts"].cpu() - exp["cuts"].cpu()).abs().max())
    if "cuts_all" in exp:
        gap = max(gap, float((cand["cuts_all"].cpu() - exp["cuts_all"].cpu()).abs().max()))
        reduce_differ = (rows_differ(cand["best_xs"], exp["best_xs"])
                         + int((cand["best_vs"].cpu() != exp["best_vs"].cpu()).sum())
                         + rows_differ(cand["restart"], exp["restart"]))
        l0 = torch.zeros(cand["logits"].shape, dtype=torch.float64)
        change_gap = norm_gap(cand["logits"].cpu().double() - l0, exp["logits"].cpu().double() - l0)
        checks += [Check("reduce_differ", reduce_differ, 0),
                   Check("grad_gap", diff_gap(cand["grad"], exp["grad"]), limits["grad_gap"]),
                   Check("adam_change_gap", change_gap, limits["adam_change_gap"])]
    else:
        checks.append(Check("full_round_missing", 1, 0))
    checks.insert(2, Check("cut_gap", gap, 0))
    return checks


def check(win: dict, ctx, control_dtype=None) -> list:
    """The check: the program's outputs (or, with `control_dtype`, the
    reference at that precision in their place) against the reference."""
    g = ref.Graph(win["edges"], win["n"], ctx.device)
    exp = outputs(win, g, ctx.device, torch.float32, program=False)
    cand = (outputs(win, g, ctx.device) if control_dtype is None
            else outputs(win, g, ctx.device, control_dtype, program=False))
    checks = compare(cand, exp, win["cap"], ctx.checks)
    rescore = float(ref_graphs.cut_of(np.asarray(win["best_x"]), win["edges"]))
    checks.append(Check("best_rescore_gap", abs(rescore - float(win["best_v"])), 0))
    return checks


def _half_batch():
    from rlsolver_tpu_torch.algos import mcpg

    def make(orig):
        def stats(values, bits, chunk=1 << 16):
            h = bits.shape[0] // 2
            a, v = orig(values[:h] - values[:h].mean(), bits[:h], chunk)
            return a * 2.0, v * 2.0
        return stats
    return patched(mcpg, "_value_statistics", make)


def _cut_altered():
    from rlsolver_tpu_torch.envs.maxcut import MaxcutEnv

    def make(orig):
        def obj(self, xs):
            out = orig(self, xs)
            out[0] += 1.0
            return out
        return obj
    return patched(MaxcutEnv, "obj", make)


def _adam():
    from rlsolver_tpu_torch.optim import ClippedAdam

    return patched(ClippedAdam, "step", adam_noop)


def _sweep_skipped():
    from rlsolver_tpu_torch.ops.kernels.engine import FusedSweepEngine

    return patched(FusedSweepEngine, "sweep", lambda orig: lambda self, seed, bits, *a, **k: bits.clone())


FAULTS = {"unchanged_state": _adam, "half_batch": _half_batch, "answer_altered": _cut_altered,
          "sweep_skipped": _sweep_skipped}
