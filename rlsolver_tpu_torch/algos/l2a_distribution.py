"""Distribution-wise dREINFORCE/L2A: one policy across a graph family
(counterpart of `rlsolver_tpu/algos/l2a_distribution.py`; RLSolver's
`L2A/demo_distribution.py:25-500`).

The instance-wise loop (`algos/l2a.py`), except that every reset samples a
FRESH graph from the BA/ER/PL distribution, the graph transformer embeds
each new adjacency, and progress is tracked as the mean best cut over fixed
seeded validation instances (`demo_distribution.py:60,110-125`). This is
the protocol behind RLSolver's distribution-wise benchmark tables
(`Benchmark.rst:17-76`) and the L2A column of
`results_quality/DIST_TABLE.md`.

Every function takes the dense adjacency as an argument, as the JAX
package's do. On the card:
  * `sweep_1flip_adj`, the greedy 1-flip sweep of training and of the
    1-flip evaluators, launches the packed kernel that `FlipSweepEngine`
    picks for the graph (K5 on BA/ER/PL's unit weights, K8a or K8b on
    other integer weights), or K10 (`sweep_1flip_f32`) where no packed
    table takes the weights. Its `AdjSweep` is built once per graph; the
    plain f32 loop runs only on the CPU;
  * `evaluate_l2a_packed` runs the noisy degree-ordered sweeps K4, K6 or K7
    through `FusedSweepEngine`, built once per instance;
  * the encoder and the policy are plain tensor code, XLA in the JAX
    package (their attention keeps its scores within `ChunkedMHA`'s budget
    and recomputes them under autograd).

All randomness comes from explicit `torch.Generator`s, so seeds do not
carry across from JAX (Threefry is not Philox). Every function that draws
takes its draws injected as an option (`u`, `us`, `GuidedDraws`, `noise`),
so that the tests can feed JAX's. The TPU's one-dispatch `lax.scan` of
`_guided_block` and the vmap over instances of `evaluate_l2a_distribution`
are Python loops here.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from rlsolver_tpu_torch.algos.mcpg import _kernel_seed
from rlsolver_tpu_torch.config import GraphType
from rlsolver_tpu_torch.convert import flax_state_dict
from rlsolver_tpu_torch.core.generate import generate_graph
from rlsolver_tpu_torch.core.graph import Graph
from rlsolver_tpu_torch.device import resolve_device
from rlsolver_tpu_torch.models.transformer import GraphEncoder, PolicyTrsWithValue, solution_to_prob_channels
from rlsolver_tpu_torch.ops.cut import signs_from_bits
from rlsolver_tpu_torch.ops.kernels.engine import FlipSweepEngine, FusedSweepEngine
from rlsolver_tpu_torch.ops.kernels.sweep_kernel import F32AdjLists, sweep_1flip_f32
from rlsolver_tpu_torch.ops.kernels.weighted_sweep import weight_fault
from rlsolver_tpu_torch.ops.reductions import pick_xs_by_vs, update_xs_by_vs
from rlsolver_tpu_torch.ops.sampling import sub_set_sampling
from rlsolver_tpu_torch.optim import ClippedAdam


# --------------------------------------------------- adjacency-arg primitives
def _cut_value_adj(xs: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
    """Cut from a dense adjacency argument, f32 [B]:
    cut = (W - s A s / 2) / 2 with s in {-1, +1}, W = total weight."""
    s = signs_from_bits(xs)
    quad = torch.sum((s @ adj) * s, dim=-1)
    w_total = adj.sum() / 2.0
    return (w_total - quad / 2.0) / 2.0


def flip_gains_adj(xs: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
    """Per-node cut gain of flipping, f32 [B, N]."""
    s = signs_from_bits(xs)
    return s * (s @ adj)


@dataclasses.dataclass
class L2ADistConfig:
    graph_type: GraphType = GraphType.BA
    num_nodes: int = 64
    num_sims: int = 128
    num_repeats: int = 4
    top_k: int = 8
    seq_len: int = 8
    num_iters: int = 20
    embed_dim: int = 32
    num_heads: int = 4
    pretrain_steps: int = 100
    pretrain_lr: float = 1e-3
    lr: float = 2e-4
    ls_sweeps: int = 1
    num_validation: int = 30  # fixed seeded instances (`num_instances=30`)
    seed: int = 0


def _sample_adj(cfg: L2ADistConfig, seed: int, device) -> Tuple[Graph, torch.Tensor]:
    """The family's graph of `seed` and its dense adjacency f32 [N, N] on
    `device` (the graph too: the sweeps on the card build their tables from
    it)."""
    g = generate_graph(cfg.graph_type, cfg.num_nodes, seed=seed)
    return g, torch.from_numpy(g.adjacency_dense()).to(device)


def graph_from_adjacency(adj: np.ndarray, name: str = "") -> Graph:
    """The graph of a symmetric dense adjacency (its upper triangle)."""
    i, j = np.nonzero(np.triu(adj, 1))
    return Graph(adj.shape[0], np.stack([i, j], 1).astype(np.int32), adj[i, j].astype(np.float32), name)


class AdjSweep(NamedTuple):
    """How `sweep_1flip_adj` sweeps one graph on the card: the packed 1-flip
    kernel `FlipSweepEngine` picks, or, where no packed kernel takes the
    weights (non-integers, |w| >= 2^15), K10 over the adjacency's lists."""

    engine: Optional[FlipSweepEngine]
    lists: Optional[F32AdjLists]

    @staticmethod
    def build(graph: Graph, adj: torch.Tensor) -> "AdjSweep":
        if weight_fault(graph.weights) is None:  # the weights `plan_1flip` takes
            return AdjSweep(FlipSweepEngine.build(graph, adj.device), None)
        return AdjSweep(None, F32AdjLists.build(adj))


def _adj_sweep(adj: torch.Tensor, graph: Optional[Graph] = None) -> Optional[AdjSweep]:
    """The graph's `AdjSweep` on the card; None on the CPU (the plain loop)."""
    if not adj.is_cuda:
        return None
    return AdjSweep.build(graph if graph is not None else graph_from_adjacency(adj.cpu().numpy()), adj)


def sweep_1flip_adj(xs: torch.Tensor, adj: torch.Tensor, num_sweeps: int = 1,
                    sweep: Optional[AdjSweep] = None) -> torch.Tensor:
    """Greedy sequential 1-flip sweeps (ascending nodes, strict improvements
    only) with the adjacency as an argument: `sweep.engine`'s packed kernel
    where it has one, else the f32 sweep with rank-1 gain updates (K10 on
    the card, which needs `sweep.lists`; its plain loop on the CPU). On
    integer weights the two are bit-identical."""
    if sweep is not None and sweep.engine is not None:
        for _ in range(num_sweeps):
            xs = sweep.engine.sweep(xs)
        return xs
    s = signs_from_bits(xs)
    gains = s * (s @ adj)
    vs = torch.zeros(xs.shape[0], device=xs.device)
    lists = sweep.lists if sweep is not None else None
    for _ in range(num_sweeps):
        s, gains, vs = sweep_1flip_f32(adj, s, gains, vs, lists)
    return s > 0.0


def _embed(enc: GraphEncoder, adj: torch.Tensor) -> torch.Tensor:
    with torch.no_grad():
        return enc.embed(adj[None])[0]


def _logp(cand: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """log P(cand | probs) summed over nodes, each term clipped at 1e-8."""
    s = cand.to(torch.float32)
    return torch.log(torch.clamp(s * probs + (1 - s) * (1 - probs), min=1e-8)).sum(dim=1)


def pretrain_encoder_distribution(cfg: L2ADistConfig, device=None, enc: Optional[GraphEncoder] = None):
    """Adjacency auto-encoding over FRESH sampled graphs
    (`train_graph_net_in_graph_distribution`,
    `L2A/graph_embedding_pretrain.py:191`): plain Adam on the mean squared
    error of the reconstruction. `enc` may bring the initial weights (else a
    new encoder seeded by `cfg.seed`). Returns (encoder, losses)."""
    dev = resolve_device(device)
    if enc is None:
        enc = GraphEncoder(cfg.num_nodes, cfg.embed_dim, cfg.num_heads, seed=cfg.seed, device=dev)
    opt = ClippedAdam(enc.parameters(), cfg.pretrain_lr, max_norm=None)
    losses = []
    for i in range(cfg.pretrain_steps):
        _, adj = _sample_adj(cfg, 10_000 + i, dev)
        recon, _ = enc(adj[None])
        loss = torch.mean((recon - adj[None]) ** 2)
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    return enc, losses


# -------------------------------------------------------------------- trainer
class DistSteps(NamedTuple):
    improve_round: Callable
    update: Callable


def _build_dist_steps(net: PolicyTrsWithValue, cfg: L2ADistConfig,
                      optimizer: Optional[ClippedAdam] = None) -> DistSteps:
    """The two steps of the training loop: one policy-guided improvement
    round (validation) and the unrolled REINFORCE update (training)."""

    @torch.no_grad()
    def improve_round(gen: Optional[torch.Generator], adj, seq_graph, xs, vs, sweep: Optional[AdjSweep] = None,
                      u: Optional[torch.Tensor] = None):
        """probs -> top-k resample -> sweep -> best of repeats -> elitist
        accept. `u` [num_repeats * S, top_k] may replace the draws of
        `sub_set_sampling`. Returns (xs, vs, logp, reward)."""
        logits, _ = net(solution_to_prob_channels(xs), seq_graph)
        probs = torch.softmax(logits, dim=-1)[..., 0]
        cand = sub_set_sampling(gen, probs, xs, cfg.num_repeats, cfg.top_k, u=u)
        cand = sweep_1flip_adj(cand, adj, cfg.ls_sweeps, sweep)
        new_xs, new_vs = pick_xs_by_vs(cand, _cut_value_adj(cand, adj), cfg.num_repeats)
        xs2, vs2 = update_xs_by_vs(xs, vs, new_xs, new_vs)
        return xs2, vs2, _logp(new_xs, probs), vs2 - vs  # row b of new_xs came from sim b

    def update(gen: Optional[torch.Generator], adj, seq_graph, xs, vs, sweep: Optional[AdjSweep] = None,
               us: Optional[Sequence[torch.Tensor]] = None):
        """One optimizer step on the REINFORCE loss of `cfg.seq_len` unrolled
        improvement steps (one candidate per sim). Gradients flow only
        through the policy's probs; the candidates, sweeps and rewards are
        computed without them. `us[t]` [S, top_k] may replace step t's draws
        of `sub_set_sampling`. Returns (xs, vs, loss)."""
        total = torch.zeros((), device=xs.device)
        for t in range(cfg.seq_len):
            logits, _ = net(solution_to_prob_channels(xs), seq_graph)
            probs = torch.softmax(logits, dim=-1)[..., 0]
            with torch.no_grad():
                cand = sub_set_sampling(gen, probs, xs, 1, cfg.top_k, u=None if us is None else us[t])
                cand = sweep_1flip_adj(cand, adj, cfg.ls_sweeps, sweep)
                xs_new, vs_new = update_xs_by_vs(xs, vs, cand, _cut_value_adj(cand, adj))
                reward = vs_new - vs
                adv = reward - reward.mean()
            total = total - torch.mean(_logp(cand, probs) * adv)
            xs, vs = xs_new, vs_new
        loss = total / cfg.seq_len
        optimizer.zero_grad()
        loss.backward()
        optimizer.step()
        return xs, vs, loss.detach()

    return DistSteps(improve_round, update)


def _bundle(net: PolicyTrsWithValue, enc: GraphEncoder, cfg: L2ADistConfig, history: List[dict]) -> dict:
    """The trained state as the JAX package returns it, the port's modules in
    place of flax's, and `validate()`: the mean best cut over the fixed
    seeded validation instances, 4 improvement rounds each."""
    steps = _build_dist_steps(net, cfg)
    dev = next(net.parameters()).device

    def validate() -> float:
        total = 0.0
        for v in range(cfg.num_validation):
            graph, adj = _sample_adj(cfg, 77_000 + v, dev)
            sweep, seq = _adj_sweep(adj, graph), _embed(enc, adj)
            gen = torch.Generator(device=dev)
            gen.manual_seed(1000 + v)
            xs = torch.rand(cfg.num_sims, cfg.num_nodes, generator=gen, device=dev) < 0.5
            vs = _cut_value_adj(xs, adj)
            for _ in range(4):
                xs, vs, _, _ = steps.improve_round(gen, adj, seq, xs, vs, sweep)
            total += float(vs.max())
        return total / cfg.num_validation

    return {"net": net, "params": net.state_dict(), "encoder": enc, "encoder_params": enc.state_dict(),
            "validate": validate, "history": history, "config": cfg}


def _clock(dev: torch.device, timings: Optional[Dict[str, List[float]]]) -> Callable[[], float]:
    """Host clock for `timings`, read after the device's queued work."""

    def tick() -> float:
        if timings is None:
            return 0.0
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.time()

    return tick


def train_l2a_distribution(cfg: L2ADistConfig = L2ADistConfig(), device=None,
                           timings: Optional[Dict[str, List[float]]] = None) -> dict:
    """Pretrains the encoder, then runs `cfg.num_iters` updates, each on a
    fresh graph with fresh random incumbents. Runs on `cuda` unless
    `device="cpu"`. A `timings` dict is filled with the seconds of
    pretraining ("pretrain") and of each iteration ("iteration"). Returns the
    bundle of `_bundle`, its "history" one {"loss", "train_best"} an
    iteration."""
    dev = resolve_device(device)
    tick = _clock(dev, timings)
    t0 = tick()
    enc, _ = pretrain_encoder_distribution(cfg, dev)
    if timings is not None:
        timings.setdefault("pretrain", []).append(tick() - t0)
    net = PolicyTrsWithValue(cfg.embed_dim, cfg.num_heads, seed=cfg.seed + 1, device=dev)
    steps = _build_dist_steps(net, cfg, ClippedAdam(net.parameters(), cfg.lr))
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed + 1)
    history = []
    for it in range(cfg.num_iters):
        t0 = tick()
        graph, adj = _sample_adj(cfg, 50_000 + it, dev)  # FRESH graph every iteration
        sweep, seq = _adj_sweep(adj, graph), _embed(enc, adj)
        xs = torch.rand(cfg.num_sims, cfg.num_nodes, generator=gen, device=dev) < 0.5
        xs, vs, loss = steps.update(gen, adj, seq, xs, _cut_value_adj(xs, adj), sweep)
        history.append({"loss": float(loss), "train_best": float(vs.max())})
        if timings is not None:
            timings.setdefault("iteration", []).append(tick() - t0)
    return _bundle(net, enc, cfg, history)


def bundle_from_jax(bundle: dict, device=None) -> dict:
    """A bundle of the JAX package's `train_l2a_distribution` -> the port's,
    on the same weights: its encoder and policy params (flax trees of jax or
    numpy arrays, read as numpy) go through `flax_state_dict`."""
    jcfg = bundle["config"]
    cfg = L2ADistConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(L2ADistConfig)})
    cfg.graph_type = GraphType(jcfg.graph_type.value)
    dev = resolve_device(device)
    net = PolicyTrsWithValue(cfg.embed_dim, cfg.num_heads, device=dev)
    net.load_state_dict(flax_state_dict(bundle["params"]))
    enc = GraphEncoder(cfg.num_nodes, cfg.embed_dim, cfg.num_heads, device=dev)
    enc.load_state_dict(flax_state_dict(bundle["encoder_params"]))
    return _bundle(net, enc, cfg, list(bundle["history"]))


# ----------------------------------------------------------------- evaluators
class GuidedDraws(NamedTuple):
    """The draws of one `_guided_round`, given in place of the generator's."""

    u: torch.Tensor  # f32 [num_repeats * S, k]: sub_set_sampling's uniforms
    explore_ids: Optional[torch.Tensor]  # int [S, k_e]: positions the exploration group redraws
    explore_bits: Optional[torch.Tensor]  # bool [S, k_e]: their new values
    seed: int  # the packed sweep's noise seed


@torch.no_grad()
def _guided_round(net: PolicyTrsWithValue, seq_graph, gen: Optional[torch.Generator],
                  engine: Optional[FusedSweepEngine], adj, xs, vs, *, num_repeats: int, top_k: int,
                  num_sweeps: int, flip: Optional[AdjSweep] = None, draws: Optional[GuidedDraws] = None):
    """One policy-guided packed-search improvement round (the reference's
    rollout-step protocol, `demo_instance.py:141-168`, with the
    degree-ordered MCPG sweep engine as the parallel local search).

    The policy's top-k uncertain bits are redrawn into `num_repeats` groups
    of candidates, except the last group (when there are several), which
    redraws k random positions of its incumbents at p = 0.5: resampling only
    the uncertain bits stalls once the policy is confident but wrong, and
    this is the basin escape MCPG gets from its temperature-driven sampler
    (`MCPG.py:88-118`). `engine` sweeps every candidate with `num_sweeps`
    noisy packed sweeps; without one, `sweep_1flip_adj` sweeps them (`flip`
    on the card). Then best of repeats, the elitist update, and the worst
    sim takes a copy of the best (`MCPG.py:376-394`)."""
    dev = xs.device
    logits, _ = net(solution_to_prob_channels(xs), seq_graph)
    probs = torch.softmax(logits, dim=-1)[..., 0]
    cand = sub_set_sampling(gen, probs, xs, num_repeats, top_k, u=None if draws is None else draws.u)
    if num_repeats > 1:
        s, n = xs.shape
        k_e = min(top_k, n)
        if draws is None:
            ids = torch.randint(0, n, (s, k_e), generator=gen, device=dev)
            new_bits = torch.rand(s, k_e, generator=gen, device=dev) < 0.5
        else:
            ids, new_bits = draws.explore_ids.long(), draws.explore_bits
        explore = xs.clone()
        explore[torch.arange(s, device=dev)[:, None], ids] = new_bits
        cand[(num_repeats - 1) * s :] = explore
    if engine is not None:
        bits = engine.sweep(_kernel_seed(gen) if draws is None else draws.seed, cand, num_sweeps)
    else:
        bits = sweep_1flip_adj(cand, adj, num_sweeps, flip)
    new_xs, new_vs = update_xs_by_vs(xs, vs, *pick_xs_by_vs(bits, _cut_value_adj(bits, adj), num_repeats))
    top, worst = torch.argmax(new_vs), torch.argmin(new_vs)
    new_xs[worst] = new_xs[top]
    new_vs[worst] = new_vs[top]
    return new_xs, new_vs


def _guided_block(net: PolicyTrsWithValue, seq_graph, gen: Optional[torch.Generator],
                  engine: Optional[FusedSweepEngine], adj, xs, vs, *, num_repeats: int, top_k: int,
                  num_sweeps: int, block_len: int, flip: Optional[AdjSweep] = None,
                  draws: Optional[Sequence[GuidedDraws]] = None):
    """`block_len` guided rounds (`draws[r]` for round r where given)."""
    for r in range(block_len):
        xs, vs = _guided_round(net, seq_graph, gen, engine, adj, xs, vs, num_repeats=num_repeats, top_k=top_k,
                               num_sweeps=num_sweeps, flip=flip, draws=None if draws is None else draws[r])
    return xs, vs


def evaluate_l2a_packed(
    bundle: dict,
    graphs: List[Graph],
    num_rounds: int = 96,
    num_sims: int = 512,
    num_repeats: int = 16,
    num_sweeps: int = 8,
    seed: int = 0,
    use_packed: Optional[bool] = None,
    return_xs: bool = False,
    timings: Optional[Dict[str, List[float]]] = None,
):
    """Policy-guided inference with the packed sweep engine.

    Per round the policy conditions on the incumbent population,
    `sub_set_sampling` resamples the top-k most uncertain bits into
    `num_repeats` candidates, the packed degree-ordered sweep refines all
    candidates (K4, K6 or K7, as `FusedSweepEngine` picks for the graph,
    built once per instance), and best-of-repeats elitist-updates the
    population (`demo_instance.py:141-168` at MCPG-class search budgets).
    `num_rounds` runs as blocks of 8 rounds (rounded down, at least one).
    `use_packed=None` means packed exactly when the bundle's networks are on
    the card; with `use_packed=False` the candidates take `num_sweeps`
    greedy 1-flip sweeps instead. The JAX package's `block_chains`, a TPU
    tile, is not carried over: the engine picks its own tiles. Returns the
    best cut per instance, and with `return_xs` also each instance's best
    solution (bool numpy [N]). A `timings` dict gets the seconds of each
    block ("block")."""
    cfg: L2ADistConfig = bundle["config"]
    net, enc = bundle["net"], bundle["encoder"]
    dev = next(net.parameters()).device
    if use_packed is None:
        use_packed = dev.type == "cuda"
    tick = _clock(dev, timings)
    block_len = 8
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    out, best_xs = np.zeros(len(graphs)), []
    for gi, g in enumerate(graphs):
        adj = torch.from_numpy(g.adjacency_dense()).to(dev)
        engine = FusedSweepEngine.build(g, dev) if use_packed else None
        flip = None if use_packed else _adj_sweep(adj, g)
        seq = _embed(enc, adj)
        xs = torch.rand(num_sims, g.num_nodes, generator=gen, device=dev) < 0.5
        vs = _cut_value_adj(xs, adj)
        for _ in range(max(1, num_rounds // block_len)):
            t0 = tick()
            xs, vs = _guided_block(net, seq, gen, engine, adj, xs, vs, num_repeats=num_repeats, top_k=cfg.top_k,
                                   num_sweeps=num_sweeps, block_len=block_len, flip=flip)
            if timings is not None:
                timings.setdefault("block", []).append(tick() - t0)
        b = int(torch.argmax(vs))
        out[gi] = float(vs[b])
        best_xs.append(xs[b].cpu().numpy())
    return (out, best_xs) if return_xs else out


@torch.no_grad()
def _perturb_round(net: PolicyTrsWithValue, seq_graph, gen: Optional[torch.Generator], adj, xs, vs,
                   cfg: L2ADistConfig, flip: Optional[AdjSweep] = None, u: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None):
    """One round of `evaluate_l2a_distribution`: the guided improvement
    (top-k resample, `cfg.ls_sweeps` 1-flip sweeps, best of repeats,
    elitist accept), then the perturb-and-sweep move of `env_L2A.py:92-107`
    (local-search phase 1): flip the max(2, top_k // 2) highest noisy-gain
    bits, re-sweep, accept if better. `u` may replace the draws of
    `sub_set_sampling`, `noise` [S, N] the unit normals on the gains."""
    logits, _ = net(solution_to_prob_channels(xs), seq_graph)
    probs = torch.softmax(logits, dim=-1)[..., 0]
    cand = sub_set_sampling(gen, probs, xs, cfg.num_repeats, cfg.top_k, u=u)
    cand = sweep_1flip_adj(cand, adj, cfg.ls_sweeps, flip)
    xs, vs = update_xs_by_vs(xs, vs, *pick_xs_by_vs(cand, _cut_value_adj(cand, adj), cfg.num_repeats))
    gains = flip_gains_adj(xs, adj)
    if noise is None:
        noise = torch.randn(gains.shape, generator=gen, device=gains.device)
    noisy = gains + noise * (0.25 * torch.std(gains, dim=1, keepdim=True, correction=0) + 1e-3)
    k_spin = max(2, cfg.top_k // 2)
    thresh = torch.sort(noisy, dim=1).values[:, -k_spin][:, None]
    pert = sweep_1flip_adj(torch.logical_xor(xs, noisy >= thresh), adj, cfg.ls_sweeps, flip)
    return update_xs_by_vs(xs, vs, pert, _cut_value_adj(pert, adj))


def evaluate_l2a_distribution(
    bundle: dict,
    adjs: List[np.ndarray],
    num_rounds: int = 48,
    num_sims: Optional[int] = None,
    seed: int = 0,
) -> np.ndarray:
    """Policy-guided inference on specific instances (dense adjacencies):
    `num_rounds` rounds of `_perturb_round` (blocks of 8, rounded down, at
    least one), then a polish of 4 greedy 1-flip sweeps — the reference's
    table protocol of evaluating the distribution-wise net on its seeded
    benchmark instances (`demo_distribution.py:110-125`). Returns the best
    cut per instance.

    The sim axis is cut into chunks of independent restarts of the same
    search, the result the max over them: as many chunks as keep
    sims x heads x N^2 f32 scores under 3e9 bytes. The JAX package set that
    budget for a 16 GB TPU; it is kept because the chunks are part of the
    protocol (each restarts from random incumbents), so the port's results
    stay comparable with the JAX evaluator's. The port's memory does not
    need it: `ChunkedMHA` bounds each call's scores itself."""
    cfg: L2ADistConfig = bundle["config"]
    net, enc = bundle["net"], bundle["encoder"]
    dev = next(net.parameters()).device
    sims = num_sims or cfg.num_sims
    n = adjs[0].shape[0]
    bytes_per_sim = 4 * cfg.num_heads * n * n
    sims_chunk = int(max(8, min(sims, 3e9 // max(1, bytes_per_sim))))
    num_chunks = -(-sims // sims_chunk)
    sims_chunk = -(-sims // num_chunks)  # equal chunks
    block_len = 8
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    out = np.zeros(len(adjs))
    for gi, a in enumerate(adjs):
        adj = torch.from_numpy(np.asarray(a, np.float32)).to(dev)
        flip, seq = _adj_sweep(adj), _embed(enc, adj)
        best = -np.inf
        for _ in range(num_chunks):
            xs = torch.rand(sims_chunk, n, generator=gen, device=dev) < 0.5
            vs = _cut_value_adj(xs, adj)
            for _ in range(max(1, num_rounds // block_len) * block_len):
                xs, vs = _perturb_round(net, seq, gen, adj, xs, vs, cfg, flip)
            polished = _cut_value_adj(sweep_1flip_adj(xs, adj, 4, flip), adj)
            best = max(best, float(torch.max(torch.maximum(vs, polished))))
        out[gi] = best
    return out
