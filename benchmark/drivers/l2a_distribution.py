"""Driver of `rlsolver_tpu_torch.algos.l2a_distribution.train_l2a_distribution`:
one call, whose iterations fill the window's seconds at the iteration time
that set-up measures. The call pretrains the encoder first; the window runs
on the benchmark's clock from the policy's construction, after pretraining,
to the call's return (a wait for the device at both ends), and so holds the
iterations. A traced run traces iterations TRACE_FROM to TRACE_TO, a fixed
stretch, so that the profiler's cost does not grow with the window; its
`train_mfu` is read over the untraced iterations after it.

The program samples its graphs itself, on the timed path as it always
does: BA_1000 with the seed PRE_BASE + step for pretraining and ITER_BASE +
iteration for each fresh graph. The driver records them, and the check
makes each again with the benchmark's own generator and compares them edge
for edge. The benchmark makes the weights: the encoder's and the policy's
initial weights come from the run's seed (`reference/l2a.py make_params`)
and are loaded into the program's modules by name as they are built.

The reference pretrains its own encoder from those weights over all the
pretraining steps, embeds each graph with it, and trains its own policy
from the initial weights; it follows the program's first three iterations
from the incumbents each step starts from and the generator's state. It
compares:
  * pretraining: every step's loss, each leaf's first gradient as Adam got
    it (its first moment after one step over 1 - b1), each leaf's change
    after three steps and after the last;
  * the embedding of each followed iteration's graph;
  * each unrolled step: the policy's probabilities, the subset sampling
    (the program's candidates against its own probabilities and the
    generator's draws), the 1-flip sweeps, the incumbents' update;
  * each followed iteration's loss, the first gradient and the change after
    three, by leaf as above;
  * every graph the program sampled.
Leaves whose reference gradient is under a thousandth of the median leaf's
(the value head's, which the loss does not reach) are left out of the
gradient and change comparisons.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import counts
from benchmark.compare import rows_differ
from benchmark.faults import adam_noop, patched
from benchmark.harness import Check
from benchmark.reference import graphs as ref_graphs
from benchmark.reference import l2a as ref

FOLLOWED = 3  # pretraining steps and iterations the reference follows
PRE_BASE, ITER_BASE = 10_000, 50_000  # the trainer's graph seeds: PRE_BASE + step, ITER_BASE + iteration
TRACE_FROM, TRACE_TO = FOLLOWED, FOLLOWED + 5  # the traced iterations


def solver_config(ctx):
    """The protocol's L2ADistConfig with the traffic's overrides and the run's seed."""
    from rlsolver_tpu_torch.eval import quality

    t = ctx.traffic
    return quality.l2a_config(t["distribution"], ctx.config["graph"]["num_nodes"], seed=ctx.seed,
                              **t.get("overrides", {}))


def _weight_seeds(seed: int):
    rng = np.random.default_rng([seed, 2])
    return [int(s) for s in rng.integers(1 << 62, size=2)]


def setup(ctx) -> dict:
    from rlsolver_tpu_torch.algos import l2a_distribution as l2d
    from rlsolver_tpu_torch.ops.kernels import build

    if ctx.device == "cuda":
        build.build_all()
    cfg = solver_config(ctx)
    warm = dataclasses.replace(cfg, pretrain_steps=2, num_iters=2)
    timings: Dict[str, List[float]] = {}
    l2d.train_l2a_distribution(warm, device=ctx.device, timings=timings)
    iters = max(TRACE_TO + 1 if ctx.trace else FOLLOWED, round(ctx.seconds / timings["iteration"][-1]))
    n, d, h = cfg.num_nodes, cfg.embed_dim, cfg.num_heads
    enc_seed, pol_seed = _weight_seeds(ctx.seed)
    return {"cfg": dataclasses.replace(cfg, num_iters=iters),
            "enc0": ref.make_params(ref.encoder_shapes(n, d, h), enc_seed, ctx.device),
            "pol0": ref.make_params(ref.policy_shapes(d, h), pol_seed, ctx.device)}


class _Capture:
    def __init__(self):
        self.graphs = {}  # trainer seed -> (edges, weights) of the program's graph
        self.optims = []  # per optimizer: {"mu1": [...], "params3": [...]}
        self.pre_losses = None
        self.enc_after = None
        self.seqs = []
        self.iters = []  # per followed iteration: gen state, xs0, vs0, steps
        self.iteration = -1
        self.t_start = None
        self.t_untraced = None  # the host clock where the traced iterations end


def _install(cap: _Capture, state: dict, tracer):
    """Records the trainer's graphs, loads the benchmark's weights into its
    modules as they are built, and wraps its optimizer, embedding, subset
    sampling, sweeps and update step for the window. Returns the undo
    function."""
    from rlsolver_tpu_torch.algos import l2a_distribution as l2d

    names = ("_sample_adj", "GraphEncoder", "PolicyTrsWithValue", "ClippedAdam", "_embed", "sub_set_sampling",
             "sweep_1flip_adj", "_build_dist_steps", "pretrain_encoder_distribution")
    saved = {k: getattr(l2d, k) for k in names}

    def sample_adj(cfg, seed, device):
        if seed == ITER_BASE + TRACE_FROM:
            tracer.begin("bench.iterations")
        elif seed == ITER_BASE + TRACE_TO and tracer.name is not None:
            tracer.end()
            cap.t_untraced = time.perf_counter()
        g, adj = saved["_sample_adj"](cfg, seed, device)
        cap.graphs[seed] = (g.edges, g.weights)
        return g, adj

    def loaded(cls, params):
        def make(*args, **kw):
            m = cls(*args, **kw)
            m.load_state_dict(params)
            return m
        return make

    def policy(*args, **kw):
        """The window opens here, pretraining done."""
        if state["device"] == "cuda":
            torch.cuda.synchronize()
        cap.t_start = time.perf_counter()
        return loaded(saved["PolicyTrsWithValue"], state["pol0"])(*args, **kw)

    class RecordingAdam(saved["ClippedAdam"]):
        def __init__(self, params, *args, **kw):
            super().__init__(params, *args, **kw)
            self.rec = {}
            cap.optims.append(self.rec)

        def step(self, corr=None):
            super().step(corr)
            if self.count == 1:
                self.rec["mu1"] = [m.clone() for m in self.mu]
            if self.count == FOLLOWED:
                self.rec["params3"] = [p.detach().clone() for p in self.params]

    def pretrain(cfg, device=None, enc=None):
        enc, losses = saved["pretrain_encoder_distribution"](cfg, device, enc)
        cap.pre_losses = list(losses)
        cap.enc_after = {k: v.detach().clone() for k, v in enc.state_dict().items()}
        return enc, losses

    def embed(enc, adj):
        seq = saved["_embed"](enc, adj)
        if len(cap.seqs) < FOLLOWED:
            cap.seqs.append(seq.clone())
        return seq

    def following():
        return 0 <= cap.iteration < FOLLOWED

    def subset(gen, probs, start_xs, num_repeats, top_k, u=None):
        out = saved["sub_set_sampling"](gen, probs, start_xs, num_repeats, top_k, u)
        if following():
            cap.iters[cap.iteration]["steps"].append(
                {"probs": probs.detach().clone(), "xs": start_xs.clone(), "pre": out.clone()})
        return out

    def sweep(xs, adj, num_sweeps=1, sweep_=None):
        out = saved["sweep_1flip_adj"](xs, adj, num_sweeps, sweep_)
        if following():
            cap.iters[cap.iteration]["steps"][-1]["post"] = out.clone()
        return out

    def build_steps(net, cfg, optimizer=None):
        steps = saved["_build_dist_steps"](net, cfg, optimizer)

        def update(gen, adj, seq_graph, xs, vs, sweep_=None, us=None):
            cap.iteration += 1
            if following():
                cap.iters.append({"gen": gen.get_state().clone(), "xs0": xs.clone(), "vs0": vs.clone(), "steps": []})
            return steps.update(gen, adj, seq_graph, xs, vs, sweep_, us)

        return steps._replace(update=update)

    for k, fn in (("_sample_adj", sample_adj), ("GraphEncoder", loaded(saved["GraphEncoder"], state["enc0"])),
                  ("PolicyTrsWithValue", policy), ("ClippedAdam", RecordingAdam), ("_embed", embed),
                  ("sub_set_sampling", subset), ("sweep_1flip_adj", sweep), ("_build_dist_steps", build_steps),
                  ("pretrain_encoder_distribution", pretrain)):
        setattr(l2d, k, fn)

    def undo():
        for k, fn in saved.items():
            setattr(l2d, k, fn)

    return undo


def window(state: dict, ctx, tracer) -> dict:
    from rlsolver_tpu_torch.algos import l2a_distribution as l2d

    cfg = state["cfg"]
    cap = _Capture()
    undo = _install(cap, dict(state, device=ctx.device), tracer)
    try:
        t0 = time.perf_counter()
        bundle = l2d.train_l2a_distribution(cfg, device=ctx.device)
        if ctx.device == "cuda":
            torch.cuda.synchronize()
        t1 = time.perf_counter()
    finally:
        undo()
    iters = len(bundle["history"])
    readings = {"window_s": t1 - cap.t_start, "iterations": iters, "attempted": iters,
                "pretrain_s": cap.t_start - t0,
                "iteration_flops": counts.l2a_iteration_flops(cfg.num_sims, cfg.num_nodes, cfg.embed_dim,
                                                              cfg.seq_len)}
    if cap.t_untraced is not None and iters > TRACE_TO:
        readings.update(untraced_iterations=iters - TRACE_TO, untraced_s=t1 - cap.t_untraced)
    losses = [h["loss"] for h in bundle["history"][:FOLLOWED]]
    return {"readings": readings, "cap": cap, "cfg": cfg, "iterations": iters, "losses": losses, "enc0": state["enc0"],
            "pol0": state["pol0"], "policy_keys": list(bundle["params"].keys()),
            "encoder_keys": list(bundle["encoder_params"].keys())}


def _leaf_gap(prog: Dict[str, torch.Tensor], exp: Dict[str, torch.Tensor], keep) -> float:
    """The worst leaf's | ||prog|| - ||exp|| | over the larger of ||exp|| and
    the median leaf's ||exp||, over the leaves `keep`."""
    norms = {k: float(torch.linalg.vector_norm(exp[k].double())) for k in keep}
    med = float(np.median(list(norms.values())))
    return max(abs(float(torch.linalg.vector_norm(prog[k].double())) - norms[k]) / max(norms[k], med, 1e-30)
               for k in keep)


def _kept(grads: Dict[str, torch.Tensor]) -> List[str]:
    """Leaves whose gradient norm is at least a thousandth of the median leaf's."""
    norms = {k: float(torch.linalg.vector_norm(g.double())) for k, g in grads.items()}
    med = float(np.median(list(norms.values())))
    return [k for k, v in norms.items() if v >= 1e-3 * med]


def _sample(probs, xs, u, top_k):
    """The subset sampling a candidate must match: the top_k least certain
    bits of each sim (smallest |p - 0.5|, in that order) redrawn as u < p."""
    k = min(top_k, probs.shape[1])
    _, ids = torch.topk(-(probs - 0.5).abs(), k, dim=1)
    return xs.scatter(1, ids, u < torch.gather(probs, 1, ids))


def _program(win: dict) -> dict:
    cap = win["cap"]
    opt_pre, opt_pol = cap.optims[0], cap.optims[1]
    ek, pk = win["encoder_keys"], win["policy_keys"]
    return {"pre_losses": cap.pre_losses,
            "pre_grad": {k: m / 0.1 for k, m in zip(ek, opt_pre["mu1"])},
            "pre_params3": dict(zip(ek, opt_pre["params3"])), "enc": cap.enc_after,
            "seqs": cap.seqs, "probs": [[s["probs"] for s in it["steps"]] for it in cap.iters],
            "pre": [[s["pre"] for s in it["steps"]] for it in cap.iters],
            "losses": win["losses"], "grad": {k: m / 0.1 for k, m in zip(pk, opt_pol["mu1"])},
            "params3": dict(zip(pk, opt_pol["params3"]))}


def _ref_edges(win: dict, ctx) -> Dict[int, np.ndarray]:
    """The benchmark's own graph of every seed the protocol samples: each
    pretraining step's and each iteration's."""
    if "ref_edges" not in win:
        cfg = win["cfg"]
        seeds = [PRE_BASE + i for i in range(cfg.pretrain_steps)]
        seeds += [ITER_BASE + i for i in range(win["iterations"])]
        win["ref_edges"] = {s: ref_graphs.make_edges(ctx.config["graph"], s) for s in seeds}
    return win["ref_edges"]


def _graphs_differ(win: dict, ctx) -> int:
    """Graphs the program sampled that are not the benchmark's own of their
    seed (edge for edge, unit weights), and seeds sampled on one side only."""
    exp, got = _ref_edges(win, ctx), win["cap"].graphs
    differ = len(set(exp) ^ set(got))
    for s in set(exp) & set(got):
        edges, weights = got[s]
        differ += int(edges.shape != exp[s].shape or not np.array_equal(edges, exp[s]) or not np.all(weights == 1))
    return differ


def _reference(win: dict, ctx, dtype) -> dict:
    """The reference at `dtype`: its own encoder pretrained from the initial
    weights on its own graphs, its own policy, following the program's
    incumbents and generator states."""
    cap, cfg = win["cap"], win["cfg"]
    n, dev = cfg.num_nodes, ctx.device
    edges_of = _ref_edges(win, ctx)
    adj = lambda s: torch.from_numpy(ref_graphs.adjacency(edges_of[s], n)).to(dev, dtype)  # noqa: E731
    out = {"pre_losses": []}
    p = ref.to_dtype(win["enc0"], dtype)
    adam = ref.Adam(p, cfg.pretrain_lr)
    for i in range(cfg.pretrain_steps):
        loss, g = ref.pretrain_step(p, adj(PRE_BASE + i))
        out["pre_losses"].append(loss)
        p = adam.step(p, g)
        if i == 0:
            out["pre_grad"] = g
        if i == FOLLOWED - 1:
            out["pre_params3"] = p
    out["enc"] = p
    out["seqs"] = [ref.embed(p, adj(ITER_BASE + it)) for it in range(FOLLOWED)]
    q = ref.to_dtype(win["pol0"], dtype)
    adam = ref.Adam(q, cfg.lr, max_norm=1.0)
    out.update(probs=[], pre=[], losses=[], loss_scales=[])
    for it, rec in enumerate(cap.iters):
        gen = torch.Generator(device=dev)
        gen.set_state(rec["gen"])
        edges = torch.from_numpy(edges_of[ITER_BASE + it]).to(dev)
        probs, pre, xs_steps, posts, advs = [], [], [], [], []
        for s in rec["steps"]:
            with torch.no_grad():
                pr = ref.policy_probs(q, s["xs"], out["seqs"][it])
            u = torch.rand(s["xs"].shape[0], min(cfg.top_k, n), generator=gen, device=dev)
            probs.append(pr)
            pre.append(_sample(pr, s["xs"], u.to(pr.dtype), cfg.top_k))
        vs = ref.cut(rec["xs0"], edges)
        for s in rec["steps"]:
            new_vs = ref.cut(s["post"], edges)
            better = new_vs > vs
            reward = torch.where(better, new_vs, vs) - vs
            xs_steps.append(s["xs"])
            posts.append(s["post"])
            advs.append(reward - reward.mean())
            vs = torch.where(better, new_vs, vs)
        loss, g, scale = ref.reinforce_step(q, out["seqs"][it], xs_steps, posts, advs)
        out["probs"].append(probs)
        out["pre"].append(pre)
        out["losses"].append(loss)
        out["loss_scales"].append(scale)
        if it == 0:
            norm = torch.sqrt(sum(torch.sum(x * x) for x in g.values()))
            out["grad"] = {k: x / norm if float(norm) >= 1.0 else x for k, x in g.items()}
        q = adam.step(q, g)
    out["params3"] = q
    return out


def _structure(win: dict, ctx) -> dict:
    """Exact checks of the program's own steps: its candidates against its
    probabilities and draws, its sweeps, its incumbents from step to step."""
    cap, cfg = win["cap"], win["cfg"]
    n, dev = cfg.num_nodes, ctx.device
    edges_of = _ref_edges(win, ctx)
    cand = sweep = state = 0
    for it, rec in enumerate(cap.iters):
        gen = torch.Generator(device=dev)
        gen.set_state(rec["gen"])
        a = torch.from_numpy(ref_graphs.adjacency(edges_of[ITER_BASE + it], n)).to(dev)
        edges = torch.from_numpy(edges_of[ITER_BASE + it]).to(dev)
        xs, vs = rec["xs0"], ref.cut(rec["xs0"], edges)
        for s in rec["steps"]:
            u = torch.rand(s["xs"].shape[0], min(cfg.top_k, n), generator=gen, device=dev)
            cand += rows_differ(s["pre"], _sample(s["probs"], s["xs"], u, cfg.top_k))
            post = s["pre"]
            for _ in range(cfg.ls_sweeps):
                post = ref.flip_sweep(post, a)
            sweep += rows_differ(s["post"], post)
            state += rows_differ(s["xs"], xs)
            new_vs = ref.cut(s["post"], edges)
            better = new_vs > vs
            xs = torch.where(better[:, None], s["post"], xs)
            vs = torch.where(better, new_vs, vs)
    return {"cand_rows_differ": cand, "sweep_rows_differ": sweep, "state_rows_differ": state}


def check(win: dict, ctx, control_dtype=None) -> list:
    cap, cfg = win["cap"], win["cfg"]
    lim = ctx.checks
    exp = _reference(win, ctx, torch.float32)
    cand = _program(win) if control_dtype is None else _reference(win, ctx, control_dtype)
    followed = (len(cap.iters) == FOLLOWED and len(cap.pre_losses or []) == cfg.pretrain_steps
                and len(cap.optims) == 2 and "params3" in cap.optims[1])
    checks = [Check("steps_missing", 0 if followed else 1, 0)]
    if not followed:
        return checks
    if control_dtype is None:
        checks.append(Check("graphs_differ", _graphs_differ(win, ctx), 0))
        checks += [Check(k, v, 0) for k, v in _structure(win, ctx).items()]
    else:
        cand_rows = sum(rows_differ(p, q) for it in range(len(cap.iters))
                        for p, q in zip(cand["pre"][it], exp["pre"][it]))
        checks.append(Check("cand_rows_differ", cand_rows, 0))
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)  # noqa: E731
    pre_keep, keep = _kept(exp["pre_grad"]), _kept(exp["grad"])
    enc0, pol0 = win["enc0"], win["pol0"]
    change = lambda params, ks, p0: {k: params[k].double() - p0[k].double() for k in ks}  # noqa: E731
    probs_gap = max(float((p.double() - q.double()).abs().max()) for it in range(len(cap.iters))
                    for p, q in zip(cand["probs"][it], exp["probs"][it]))
    seq_gap = max(float((a.double() - b.double()).abs().max() / b.double().abs().max())
                  for a, b in zip(cand["seqs"], exp["seqs"]))
    numbers = {
        "pre_loss_gap": max(rel(a, b) for a, b in zip(cand["pre_losses"], exp["pre_losses"])),
        "pre_grad_gap": _leaf_gap(cand["pre_grad"], exp["pre_grad"], pre_keep),
        "pre_change_gap": _leaf_gap(change(cand["pre_params3"], pre_keep, enc0),
                                    change(exp["pre_params3"], pre_keep, enc0), pre_keep),
        "enc_change_gap": _leaf_gap(change(cand["enc"], pre_keep, enc0), change(exp["enc"], pre_keep, enc0),
                                    pre_keep),
        "seq_gap": seq_gap,
        "probs_gap": probs_gap,
        "loss_gap": max(abs(a - b) / max(abs(b), s) for a, b, s in zip(cand["losses"], exp["losses"],
                                                                     exp["loss_scales"])),
        "grad_gap": _leaf_gap(cand["grad"], exp["grad"], keep),
        "change_gap": _leaf_gap(change(cand["params3"], keep, pol0), change(exp["params3"], keep, pol0), keep),
    }
    checks += [Check(k, v, lim[k]) for k, v in numbers.items()]
    return checks


def _half_batch():
    from rlsolver_tpu_torch.algos import l2a_distribution

    def make(orig):
        def logp(cand, probs):
            out = orig(cand, probs)
            keep = (torch.arange(out.shape[0], device=out.device) < out.shape[0] // 2).to(out.dtype)
            return out * keep * 2.0
        return logp
    return patched(l2a_distribution, "_logp", make)


def _candidate_altered():
    from rlsolver_tpu_torch.algos import l2a_distribution

    def make(orig):
        def subset(*args, **kw):
            out = orig(*args, **kw)
            out[0, 0] = ~out[0, 0]
            return out
        return subset
    return patched(l2a_distribution, "sub_set_sampling", make)


def _adam():
    from rlsolver_tpu_torch.optim import ClippedAdam

    return patched(ClippedAdam, "step", adam_noop)


FAULTS = {"unchanged_state": _adam, "half_batch": _half_batch, "answer_altered": _candidate_altered}
