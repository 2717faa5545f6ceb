"""Driver of `rlsolver_tpu_torch.algos.mcpg_batch.solve_maxcut_mcpg_batched`:
whole solves back to back, each of the configuration's `instances` (its
fixed set, so that every seed does the same work) in an order drawn from
the seed, with a solver seed drawn from it. New solves start until the
window's seconds have passed; the window ends with the last solve, so it
holds whole solves only, each with its own table build, warm start and
CUDA-graph capture.
A traced run traces the first solve, a fixed stretch: every solve does the
same work, and a solve's replayed graphs launch some 1.8 million kernels,
whose trace takes the profiler about 100 s to process.

Set-up makes the instances and one warm call of one round on them.

The check, after the window, takes one round of each solve: the first of
an epoch drawn from the seed, where the logits and Adam's state start
again at 0, as the reference has them. It follows that round from the
reference's own logits and Adam state and from the program's restart rows,
incumbents and generator state at the round's start: every chain's MH
samples, its swept bits from the program's samples, every cut, the reduce
and the logits' Adam steps; and each solve's best cut, re-scored on the
host.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from benchmark.compare import diff_gap, first_gradient, norm_gap, rows_differ
from benchmark.faults import adam_noop, patched
from benchmark.harness import Check
from benchmark.reference import batch as ref
from benchmark.reference import graphs as ref_graphs


def solver_config(ctx):
    from rlsolver_tpu_torch.eval import quality

    return quality.mcpg_config(seed=ctx.seed, **ctx.traffic.get("overrides", {}))


class _Instances:
    """The configuration's instances (edges from the benchmark's generator,
    the program's Graph) and each solve's order of them and solver seed,
    drawn from the run's seed."""

    def __init__(self, ctx):
        from rlsolver_tpu_torch.core.graph import Graph

        spec, n = ctx.config["graph"], ctx.config["graph"]["num_nodes"]
        self.ids = list(ctx.config["instances"])
        self.count = len(self.ids)
        self.edges = [ref_graphs.make_edges(spec, i) for i in self.ids]
        self.graphs = [Graph(n, e.astype(np.int32), np.ones(e.shape[0], np.float32), f"BA_{n}_ID{i}")
                       for e, i in zip(self.edges, self.ids)]
        self.rng = np.random.default_rng(ctx.seed)
        self.solves = []

    def solve(self, k: int):
        """(order, edges, graphs, solver seed) of solve k."""
        while len(self.solves) <= k:
            order = self.rng.permutation(self.count)
            self.solves.append((order, [self.edges[i] for i in order], [self.graphs[i] for i in order],
                                int(self.rng.integers(1 << 62))))
        return self.solves[k]


def setup(ctx) -> dict:
    from rlsolver_tpu_torch.algos import mcpg_batch
    from rlsolver_tpu_torch.ops.kernels import build

    cfg = solver_config(ctx)
    inst = _Instances(ctx)
    if ctx.device == "cuda":
        build.build_all()
    warm = dataclasses.replace(cfg, max_epoch_num=1, reset_epoch_num=cfg.sample_epoch_num)
    mcpg_batch.solve_maxcut_mcpg_batched(inst.solve(0)[2], warm, device=ctx.device)
    return {"cfg": cfg, "inst": inst}


class _Capture:
    def __init__(self, checked):
        self.checked = checked  # per solve, the round index to follow
        self.solve = 0
        self.round = 0
        self.rounds = []


def _install(cap: _Capture):
    """Wraps the solver's sample, reduce and update steps; on a checked
    round keeps their inputs and outputs. Returns the undo function."""
    from rlsolver_tpu_torch.algos import mcpg_batch as mb

    saved = [(name, getattr(mb, name)) for name in ("sample_round", "reduce_round", "update_round")]
    orig = dict(saved)
    state = {}

    def checked():
        return cap.solve < len(cap.checked) and cap.round == cap.checked[cap.solve]

    def sample_round(gen, logits, start_bits, sg, cfg, draws=None, graphs=None):
        if checked():
            state.clear()
            state.update(gen_state=gen.get_state().clone(), start=start_bits)
        kw = {} if graphs is None else {"graphs": graphs}
        mh, ls, cuts = orig["sample_round"](gen, logits, start_bits, sg, cfg, draws, **kw)
        if checked():
            state.update(mh=mh, ls=ls, cuts=cuts)
        return mh, ls, cuts

    def reduce_round(ls_bits, cuts, best_xs, best_vs, repeat_times):
        if checked():
            state.update(best_xs0=best_xs.clone(), best_vs0=best_vs.clone())
        out = orig["reduce_round"](ls_bits, cuts, best_xs, best_vs, repeat_times)
        if checked():
            state.update(best_xs1=out[0].clone(), best_vs1=out[1].clone(), restart=out[2])
        return out

    def update_round(logits, optimizer, mh, cuts, sg, steps):
        if checked():
            def first_step(corr=None, step=optimizer.step):
                step(corr)
                state.setdefault("mu1", optimizer.mu[0].clone())
            optimizer.step = first_step
        orig["update_round"](logits, optimizer, mh, cuts, sg, steps)
        if checked():
            del optimizer.step
            state["logits1"] = logits.detach().clone()
            cap.rounds.append(dict(state, solve=cap.solve, round=cap.round))
        cap.round += 1

    mb.sample_round, mb.reduce_round, mb.update_round = sample_round, reduce_round, update_round

    def undo():
        for name, fn in saved:
            setattr(mb, name, fn)

    return undo


def window(state: dict, ctx, tracer) -> dict:
    from rlsolver_tpu_torch.algos import mcpg_batch

    cfg, inst = state["cfg"], state["inst"]
    rounds = cfg.max_epoch_num * max(1, cfg.reset_epoch_num // cfg.sample_epoch_num)
    chains = inst.count * cfg.total_mcmc_num * cfg.repeat_times
    rng = np.random.default_rng([ctx.seed, 1])
    per_epoch = rounds // cfg.max_epoch_num
    cap = _Capture([])
    results = []
    undo = _install(cap)
    try:
        t0 = time.perf_counter()
        while True:
            _, edges, graphs, seed = inst.solve(cap.solve)
            cap.checked.append(int(rng.integers(cfg.max_epoch_num)) * per_epoch)
            if cap.solve == 0:
                tracer.begin("bench.first_solve")
            best_x, best_v, _ = mcpg_batch.solve_maxcut_mcpg_batched(graphs, dataclasses.replace(cfg, seed=seed),
                                                                     device=ctx.device)
            tracer.end()  # a solve's millions of replayed kernels: the trace holds the first
            results.append((best_x, best_v, edges))
            cap.solve += 1
            cap.round = 0
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        if ctx.device == "cuda":
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    finally:
        undo()
    solves = len(results)
    readings = {"window_s": window_s, "samples": solves * rounds * chains, "attempted": solves, "solves": solves}
    return {"readings": readings, "cap": cap, "results": results, "cfg": cfg, "inst": inst}


def _round_outputs(rec: dict, gs: ref.Graphs, cfg, device, dtype, program: bool) -> dict:
    """A checked round's candidate outputs: the program's, or the reference
    at `dtype` put in their place."""
    if program:
        return {"mh": rec["mh"], "ls": rec["ls"], "cuts": rec["cuts"].double(), "best_xs": rec["best_xs1"],
                "best_vs": rec["best_vs1"].double(), "restart": rec["restart"][:, : cfg.total_mcmc_num],
                "logits": rec["logits1"], "grad": first_gradient(rec["mu1"], torch.zeros_like(rec["mu1"]))}
    g, b, n = rec["start"].shape
    zero = torch.zeros(g, n, device=device)  # the logits and Adam's moments at an epoch's start
    change_times = cfg.change_times or max(1, n // 10)
    nodes, u, su = ref.draws(rec["gen_state"], (g, b, n), 5 * change_times, cfg.num_ls, device)
    out = {"mh": ref.mh(rec["start"], ref.probs_of(zero, dtype), nodes, u, change_times, dtype)}
    del nodes, u
    out["ls"] = ref.sweeps(rec["mh"], gs, su, dtype)
    out["cuts"] = ref.cuts(rec["ls"], gs) if dtype == torch.float32 else ref.cuts_at(rec["ls"], gs, dtype)
    xs, vs, chain = ref.reduce(rec["ls"], out["cuts"], rec["best_xs0"], rec["best_vs0"].double(), cfg.repeat_times)
    out.update(best_xs=xs, best_vs=vs, restart=chain)
    out["logits"], out["grad"] = ref.adam_update(zero, zero, zero, 0, rec["mh"], out["cuts"], gs.total,
                                                 cfg.sample_epoch_num, cfg.lr, dtype)
    return out


def check(win: dict, ctx, control_dtype=None) -> list:
    cfg, inst, cap = win["cfg"], win["inst"], win["cap"]
    totals = {"mh_rows_differ": 0, "sweep_rows_differ": 0, "cut_gap": 0.0, "reduce_differ": 0, "grad_gap": 0.0,
              "adam_change_gap": 0.0}
    for rec in cap.rounds:
        edges = inst.solve(rec["solve"])[1]
        gs = ref.Graphs(edges, ctx.config["graph"]["num_nodes"], ctx.device)
        exp = _round_outputs(rec, gs, cfg, ctx.device, torch.float32, program=False)
        cand = (_round_outputs(rec, gs, cfg, ctx.device, None, program=True) if control_dtype is None
                else _round_outputs(rec, gs, cfg, ctx.device, control_dtype, program=False))
        totals["mh_rows_differ"] += rows_differ(cand["mh"], exp["mh"])
        totals["sweep_rows_differ"] += rows_differ(cand["ls"], exp["ls"])
        totals["cut_gap"] = max(totals["cut_gap"], float((cand["cuts"].cpu() - exp["cuts"].cpu()).abs().max()))
        totals["reduce_differ"] += (rows_differ(cand["best_xs"], exp["best_xs"])
                                    + rows_differ(cand["restart"], exp["restart"])
                                    + int((cand["best_vs"].cpu() != exp["best_vs"].cpu()).sum()))
        totals["grad_gap"] = max(totals["grad_gap"], diff_gap(cand["grad"], exp["grad"]))
        l0 = torch.zeros(cand["logits"].shape, dtype=torch.float64)
        totals["adam_change_gap"] = max([totals["adam_change_gap"]] + [  # the worst graph
            norm_gap(c.double().cpu() - b, e.double().cpu() - b) for c, e, b in zip(cand["logits"], exp["logits"], l0)])
    limits = {k: ctx.checks[k] for k in ("grad_gap", "adam_change_gap")}
    checks = [Check(k, v, limits.get(k, 0)) for k, v in totals.items()]
    checks.append(Check("rounds_checked_missing", max(0, len(win["results"]) - len(cap.rounds)), 0))
    gap = 0.0
    for best_x, best_v, edges in win["results"]:
        for x, v, e in zip(best_x, best_v, edges):
            gap = max(gap, abs(float(ref_graphs.cut_of(x, e)) - float(v)))
    checks.append(Check("best_rescore_gap", gap, 0))
    return checks


def _half_batch():
    from rlsolver_tpu_torch.algos import mcpg_batch

    def make(orig):
        def update(logits, optimizer, mh, cuts, sg, steps):
            h = mh.shape[1] // 2
            orig(logits, optimizer, mh[:, :h], cuts[:, :h], sg, steps)
        return update
    return patched(mcpg_batch, "update_round", make)


def _cut_altered():
    from rlsolver_tpu_torch.algos import mcpg_batch

    def make(orig):
        def cuts(xs, sg):
            out = orig(xs, sg)
            out[0, 0] += 1.0
            return out
        return cuts
    return patched(mcpg_batch, "cut_values_stacked", make)


def _adam():
    from rlsolver_tpu_torch.optim import ClippedAdam

    return patched(ClippedAdam, "step", adam_noop)


def _sweep_skipped():
    from rlsolver_tpu_torch.algos import mcpg_batch

    return patched(mcpg_batch, "_sweep_stacked", lambda orig: lambda gen, mh, *a, **k: mh.clone())


FAULTS = {"unchanged_state": _adam, "half_batch": _half_batch, "answer_altered": _cut_altered,
          "sweep_skipped": _sweep_skipped}
