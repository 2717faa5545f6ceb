"""MCPG on G same-size graphs at once (counterpart of
`rlsolver_tpu/algos/mcpg_batch.py`). RLSolver solves one instance a process
(`MCPG.py:459`); here every tensor carries a leading graph axis and each
step runs for all G graphs in one launch.

Each graph follows `algos/mcpg.py` with the reference's sampler:
  * MH proposals toward the graph's Bernoulli(probs), with the accept budget
    num_chains * change_times per graph (`MCPG.py:88-118`), as a fixed
    5 * change_times rounds whose accepts stop once the budget is spent;
  * `num_ls` degree-ordered sequential sweeps (`MCPG.py:120-141`), each
    graph walking its own degree order: one batched gather a step over the
    padded neighbour tables [G, N, D];
  * best of repeats per chain, elitist incumbents, the worst chain replaced
    by the best (`MCPG.py:376-394`);
  * REINFORCE on the pre-sweep samples with the centered energy as the
    value (`MCPG.py:292-302`): clip by global norm 1.0, then Adam, for
    `sample_epoch_num` steps a round; the policy is reset every epoch.
Chains are laid out [G, R * C, N], repeat r of chain c at row r * C + c.

On the card the MH rounds and each sweep's N steps (a few launches a round
or a step, 40,000-odd a BA_1000 round) replay as CUDA graphs, one per
shape, captured at their first call of a solve (`capture.Graphs`). `sample_round`
and `_sweep_stacked` run the eager loops unless given `graphs=`; the graphs
follow them bit for bit.
"""

from __future__ import annotations

import time
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from rlsolver_tpu_torch.algos.mcpg import MCPGConfig
from rlsolver_tpu_torch.capture import EAGER, Graphs
from rlsolver_tpu_torch.core.graph import Graph
from rlsolver_tpu_torch.device import resolve_device
from rlsolver_tpu_torch.optim import ClippedAdam

NOISE_SCALE = 0.25  # the sweeps' noise, as `ops.sweeps.degree_ordered_sweep`'s default


class StackedGraphs(NamedTuple):
    """Static per-graph tensors stacked on a leading graph axis, and the
    sweep's padded neighbour tables [G, N, D] in each graph's own
    descending-degree order, cut per step k to the step's longest list D_k
    and laid out flat for `torch.index_select` on the node-major state
    [G * (N + 1), B] (row g * (N + 1) + j holds graph g's node j; row
    g * (N + 1) + N is its sentinel, always 0)."""

    adj: torch.Tensor  # [G, N, N] f32 dense adjacency
    total_w: torch.Tensor  # [G] f32
    order: torch.Tensor  # [G, N] int64 node ids in sweep order
    order_rows: torch.Tensor  # [N, G] int64: step k's node of each graph, as a state row
    gather_rows: torch.Tensor  # [sum_k G * D_k] int64: step k's neighbour rows, [G, D_k] each
    gather_w: torch.Tensor  # [sum_k G * D_k] f32: their weights (0 on padding)
    offsets: List[int]  # step k's entries are gather_rows[offsets[k]:offsets[k + 1]]
    thr: torch.Tensor  # [N, G, 1] f32 (wdeg + NOISE_SCALE) / 2 in sweep order
    num_graphs: int
    num_nodes: int

    @staticmethod
    def build(graphs: Sequence[Graph], device=None) -> "StackedGraphs":
        dev = resolve_device(device)
        n, num_graphs = graphs[0].num_nodes, len(graphs)
        if any(g.num_nodes != n for g in graphs):
            raise ValueError("all graphs must share num_nodes")
        order = np.stack([g.degree_sorted_nodes(descending=True) for g in graphs]).astype(np.int64)  # [G, N]
        tables = [g.padded_neighbors() for g in graphs]
        base = (np.arange(num_graphs) * (n + 1))[:, None]
        rows, weights, offsets = [], [], [0]
        for k in range(n):
            d = max(1, max(int(t[2][order[i, k]]) for i, t in enumerate(tables)))
            step_rows = np.full((num_graphs, d), n, np.int64)
            step_w = np.zeros((num_graphs, d), np.float32)
            for i, (nbrs, nbr_w, deg) in enumerate(tables):
                node = order[i, k]
                step_rows[i, : deg[node]] = nbrs[node, : deg[node]]
                step_w[i, : deg[node]] = nbr_w[node, : deg[node]]
            rows.append((step_rows + base).ravel())
            weights.append(step_w.ravel())
            offsets.append(offsets[-1] + num_graphs * d)
        wdeg = np.stack([g.weighted_degrees()[o] for g, o in zip(graphs, order)])  # [G, N]
        return StackedGraphs(
            adj=torch.from_numpy(np.stack([g.adjacency_dense() for g in graphs])).to(dev),
            total_w=torch.tensor([g.total_weight for g in graphs], dtype=torch.float32, device=dev),
            order=torch.from_numpy(order).to(dev),
            order_rows=torch.from_numpy((order + base).T.copy()).to(dev),
            gather_rows=torch.from_numpy(np.concatenate(rows)).to(dev),
            gather_w=torch.from_numpy(np.concatenate(weights)).to(dev),
            offsets=offsets,
            thr=(torch.from_numpy(wdeg.T.copy()).to(dev)[:, :, None] + NOISE_SCALE) / 2.0,
            num_graphs=num_graphs,
            num_nodes=n,
        )

    def step_tables(self, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Step k's neighbour rows [G * D_k] and weights [G, 1, D_k]."""
        a, b = self.offsets[k], self.offsets[k + 1]
        return self.gather_rows[a:b], self.gather_w[a:b].view(self.num_graphs, 1, -1)


def cut_values_stacked(xs: torch.Tensor, sg: StackedGraphs) -> torch.Tensor:
    """Cut values of bits bool [G, B, N] by one batched f32 product (TF32
    off): f32 [G, B]."""
    s = xs.to(torch.float32) * 2.0 - 1.0
    quad = torch.sum(torch.bmm(s, sg.adj) * s, dim=-1)
    return (sg.total_w[:, None] - quad / 2.0) / 2.0


def _mh_rounds(bits: torch.Tensor, probs: torch.Tensor, nodes: torch.Tensor, u: torch.Tensor,
               budget: torch.Tensor) -> torch.Tensor:
    """The MH rounds on bits bool [G, B, N] (written in place) toward probs
    [G, N], a graph's accepts stopped once it has accepted `budget` (int64
    0-d) flips, the budget checked before each round."""
    cnt = torch.zeros(bits.shape[0], dtype=torch.int64, device=bits.device)
    for t in range(nodes.shape[0]):
        node = nodes[t].long()
        p = torch.gather(probs, 1, node)
        cur = torch.gather(bits, 2, node[:, :, None])[:, :, 0]
        q = torch.where(cur, p, 1.0 - p)
        accept = (u[t] < (1.0 - q) / q) & (cnt < budget)[:, None]
        bits.scatter_(2, node[:, :, None], (cur ^ accept)[:, :, None])
        cnt += accept.sum(dim=1)
    return bits


def _mh_stacked(
    gen: Optional[torch.Generator],
    probs: torch.Tensor,
    bits: torch.Tensor,
    change_times: int,
    round_cap_factor: int = 5,
    nodes: Optional[torch.Tensor] = None,
    u: Optional[torch.Tensor] = None,
    graphs: Graphs = EAGER,
) -> torch.Tensor:
    """round_cap_factor * change_times MH rounds on bits bool [G, B, N]
    toward probs [G, N]; a graph's accepts stop once it has accepted
    B * change_times flips (the budget is checked before each round). The
    draws (nodes [T, G, B], uniforms [T, G, B]) come from `gen` unless
    given."""
    num_graphs, num_chains, num_nodes = bits.shape
    dev = bits.device
    rounds = round_cap_factor * change_times
    if nodes is None:
        nodes = torch.randint(0, num_nodes, (rounds, num_graphs, num_chains), generator=gen, device=dev)
        u = torch.rand(rounds, num_graphs, num_chains, generator=gen, device=dev)
    budget = torch.tensor(num_chains * change_times, dtype=torch.int64, device=dev)
    return graphs("mh", _mh_rounds, bits.clone(), probs, nodes.to(dev), u.to(dev), budget).clone()


def _sweep_steps(xn: torch.Tensor, u: torch.Tensor, sg: StackedGraphs) -> torch.Tensor:
    """One sweep's N steps on the node-major state xn [G * (N + 1), B],
    written in place, with its uniforms u [N, G, B]."""
    num_graphs, b = sg.num_graphs, xn.shape[1]
    for k in range(sg.num_nodes):
        rows, w = sg.step_tables(k)
        vals = torch.index_select(xn, 0, rows).view(num_graphs, -1, b)  # [G, D_k, B]
        nbr_sum = torch.bmm(w, vals)[:, 0]
        new_bit = torch.add(nbr_sum, u[k], alpha=NOISE_SCALE) < sg.thr[k]  # nbr_sum + u * NOISE_SCALE, one rounding
        xn.index_copy_(0, sg.order_rows[k], new_bit.to(torch.float32))
    return xn


def _sweep_stacked(gen: Optional[torch.Generator], mh: torch.Tensor, sg: StackedGraphs, num_sweeps: int,
                   noise: Optional[torch.Tensor] = None, graphs: Graphs = EAGER) -> torch.Tensor:
    """`degree_ordered_sweep` on every graph at once: bits bool [G, B, N] ->
    bool [G, B, N]. Step k sets node order[g, k] of every graph g from one
    gather of the step's neighbour rows [G, D_k, B] and one batched product
    with their weights. The uniforms [num_sweeps, N, G, B] come from `gen`
    (a sweep's at once) unless `noise` gives them."""
    num_graphs, b, n = mh.shape
    # node-major, the mixed start domain 2x - 0.5, the sentinel row N at 0
    xn = torch.cat([mh.transpose(1, 2).to(torch.float32) * 2.0 - 0.5,
                    torch.zeros(num_graphs, 1, b, device=mh.device)], dim=1).reshape(num_graphs * (n + 1), b)
    for s in range(num_sweeps):
        u = noise[s].to(mh.device) if noise is not None else torch.rand(n, num_graphs, b, generator=gen,
                                                                          device=mh.device)
        xn = graphs("sweep", lambda x, uu: _sweep_steps(x, uu, sg), xn, u)
    return xn.view(num_graphs, n + 1, b)[:, :n].transpose(1, 2) > 0.5


class BatchDraws(NamedTuple):
    """A round's draws, injected in place of the generator's: the MH
    proposals (nodes, uniforms [T, G, R*C]) and the sweeps' uniforms
    [num_ls, N, G, R*C]."""

    nodes: torch.Tensor
    u: torch.Tensor
    sweep: torch.Tensor


def _probs(logits: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(logits) * 0.6 + 0.2  # BernoulliPolicy's squash


def sample_round(gen: Optional[torch.Generator], logits: torch.Tensor, start_bits: torch.Tensor, sg: StackedGraphs,
                 cfg: MCPGConfig, draws: Optional[BatchDraws] = None,
                 graphs: Graphs = EAGER) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """MH samples, their swept bits (bool [G, R*C, N]) and cuts [G, R*C]."""
    change_times = cfg.change_times or max(1, sg.num_nodes // 10)
    with torch.no_grad():
        probs = _probs(logits)
    if draws is None:
        mh = _mh_stacked(gen, probs, start_bits, change_times, graphs=graphs)
        ls_bits = _sweep_stacked(gen, mh, sg, cfg.num_ls, graphs=graphs)
    else:
        mh = _mh_stacked(None, probs, start_bits, change_times, nodes=draws.nodes, u=draws.u, graphs=graphs)
        ls_bits = _sweep_stacked(None, mh, sg, cfg.num_ls, noise=draws.sweep, graphs=graphs)
    return mh, ls_bits, cut_values_stacked(ls_bits, sg)


def reduce_round(ls_bits: torch.Tensor, cuts: torch.Tensor, best_xs: torch.Tensor, best_vs: torch.Tensor,
                 repeat_times: int):
    """Per graph: best of repeats per chain, the elitist update, the worst
    chain replaced by the best. Returns (best_xs [G, C, N], best_vs [G, C],
    restart bits [G, R*C, N])."""
    num_graphs, _, n = ls_bits.shape
    c = best_xs.shape[1]
    g_ax = torch.arange(num_graphs, device=ls_bits.device)
    best_r = torch.argmax(cuts.reshape(num_graphs, repeat_times, c), dim=1)  # [G, C], ties: the first repeat
    rows = best_r * c + torch.arange(c, device=ls_bits.device)
    chain_xs, chain_vs = ls_bits[g_ax[:, None], rows], cuts[g_ax[:, None], rows]
    better = chain_vs > best_vs
    best_xs = torch.where(better[:, :, None], chain_xs, best_xs)
    best_vs = torch.where(better, chain_vs, best_vs)
    top, worst = torch.argmax(best_vs, dim=1), torch.argmin(best_vs, dim=1)
    best_xs[g_ax, worst] = best_xs[g_ax, top]
    best_vs[g_ax, worst] = best_vs[g_ax, top]
    return best_xs, best_vs, chain_xs.repeat(1, repeat_times, 1)


def update_round(logits: torch.nn.Parameter, optimizer: ClippedAdam, mh: torch.Tensor, cuts: torch.Tensor,
                 sg: StackedGraphs, steps: int) -> None:
    """`steps` steps of clipped Adam on sum_g mean_b(logp_gb * value_gb),
    value the centered energy total_w - 2 cut. The loss is linear in the
    samples, so it is formed from A = value @ bits [G, N] and V = sum(value)
    [G]: sum_n A log p + (V - A) log(1 - p), over B (the JAX package's clip
    of p at 1e-8 never binds: p lies in [0.2, 0.8])."""
    energy = sg.total_w[:, None] - 2.0 * cuts
    value = energy - energy.mean(dim=1, keepdim=True)
    a = torch.bmm(value[:, None, :], mh.to(torch.float32))[:, 0]  # [G, N]
    v = value.sum(dim=1, keepdim=True)
    for _ in range(steps):
        probs = _probs(logits)
        loss = torch.sum(a * torch.log(probs) + (v - a) * torch.log(1.0 - probs)) / mh.shape[1]
        optimizer.zero_grad()
        loss.backward()
        optimizer.step()


def new_logits(num_graphs: int, num_nodes: int, cfg: MCPGConfig, device):
    """Zero logits [G, N] and their optimizer (clip 1.0, then Adam)."""
    logits = torch.nn.Parameter(torch.zeros(num_graphs, num_nodes, device=device))
    return logits, ClippedAdam([logits], cfg.lr)


def solve_maxcut_mcpg_batched(
    graphs: Sequence[Graph],
    cfg: MCPGConfig = MCPGConfig(),
    verbose: bool = False,
    device=None,
    timings: Optional[list] = None,
) -> Tuple[np.ndarray, np.ndarray, List[dict]]:
    """Solve `graphs` (one node count) together on `cuda` unless
    `device="cpu"`. Returns (best_x bool [G, N], best_v f32 [G], one history
    entry an epoch). `timings`, where given, collects each round's seconds
    (ending in a wait for the device). The loops replay as CUDA graphs on
    the card (see the module doc)."""
    dev = resolve_device(device)
    loops = Graphs()
    sg = StackedGraphs.build(graphs, dev)
    num_graphs, n = sg.num_graphs, sg.num_nodes
    C, R = cfg.total_mcmc_num, cfg.repeat_times
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed)
    start_xs = torch.rand(num_graphs, C, n, generator=gen, device=dev) < 0.5
    start_xs[:, :, 0] = False
    # warm start: sweeps of the initial chains (MCPG.py:342-348 analogue)
    best_xs = _sweep_stacked(gen, start_xs, sg, cfg.warmup_ls_rounds, graphs=loops)
    best_vs = cut_values_stacked(best_xs, sg)
    start_bits = best_xs.repeat(1, R, 1)

    history = []
    rounds_per_epoch = max(1, cfg.reset_epoch_num // cfg.sample_epoch_num)
    t0 = time.time()
    for epoch in range(cfg.max_epoch_num):
        logits, optimizer = new_logits(num_graphs, n, cfg, dev)  # per-epoch reset
        for _ in range(rounds_per_epoch):
            t_round = time.time()
            mh, ls_bits, cuts = sample_round(gen, logits, start_bits, sg, cfg, graphs=loops)
            best_xs, best_vs, start_bits = reduce_round(ls_bits, cuts, best_xs, best_vs, R)
            update_round(logits, optimizer, mh, cuts, sg, cfg.sample_epoch_num)
            if timings is not None:
                best_vs.max().item()  # waits for the round
                timings.append(time.time() - t_round)
        per_graph_best = best_vs.max(dim=1).values.cpu().numpy()
        history.append({"epoch": epoch, "best": per_graph_best, "t": time.time() - t0})
        if verbose:
            print(f"epoch {epoch}: mean best {per_graph_best.mean():.1f} ({time.time() - t0:.1f}s)", flush=True)
    top = torch.argmax(best_vs, dim=1)
    g_ax = torch.arange(num_graphs, device=dev)
    return best_xs[g_ax, top].cpu().numpy(), best_vs[g_ax, top].cpu().numpy(), history
