"""Classical TSP zoo: construction heuristics and batched local search
(counterpart of `rlsolver_tpu/classical/tsp.py`; RLSolver's
`methods_problem_specific/TSP/`: christofides, nearest neighbour, the three
insertions, 2-opt, 3-opt, tabu search, GA, greedy Karp-Steele patching).

The constructions are host numpy/scipy (sequential and small) and feed the
device improvers: best-improvement 2-opt over the whole [N, N] move-delta
matrix of each tour, sampled or-opt relocations and 2-opt tabu search, all
batched over tours [B, N] on the card. 3-opt and the GA's selection and
crossover stay on the host, as in the JAX package.

Christofides builds its multigraph and Eulerian circuit as networkx does
(which the card's machine lacks): Kruskal's tree with edges in order of
weight, a minimum-weight perfect matching on the odd vertices
(`classical/matching.py`), then Hierholzer's walk from city 0 over the
adjacency in networkx's insertion order, so that the tour is the JAX
package's on instances without ties.

Tours are 0-indexed permutations of length N (closing edge implied).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from rlsolver_tpu_torch.classical.matching import min_weight_perfect_matching
from rlsolver_tpu_torch.device import resolve_device
from rlsolver_tpu_torch.problems.objectives import obj_tsp


# -------------------------------------------------------- host constructions
def nearest_neighbor_tour(dist: np.ndarray, start: int = 0) -> np.ndarray:
    """Greedy nearest-neighbour construction (`TSP/nn.py`)."""
    n = dist.shape[0]
    visited = np.zeros(n, bool)
    tour = np.empty(n, np.int32)
    tour[0] = start
    visited[start] = True
    for i in range(1, n):
        d = dist[tour[i - 1]].copy()
        d[visited] = np.inf
        tour[i] = int(d.argmin())
        visited[tour[i]] = True
    return tour


def _insertion_tour(dist: np.ndarray, mode: str, start: int = 0) -> np.ndarray:
    """Grow a subtour by choosing a city (by `mode`) and splicing it in at
    its cheapest position: 'nearest' (`TSP/ins_n.py`), 'farthest'
    (`ins_f.py`) or 'cheapest' (`ins_c.py`)."""
    n = dist.shape[0]
    in_tour = np.zeros(n, bool)
    first = int(np.argsort(dist[start] + np.where(np.arange(n) == start, np.inf, 0))[0])
    tour = [start, first]
    in_tour[start] = in_tour[first] = True
    while len(tour) < n:
        outside = np.where(~in_tour)[0]
        t = np.asarray(tour)
        nxt = np.roll(t, -1)
        # insertion cost of city c at each edge (a, b): d(a,c)+d(c,b)-d(a,b)
        inc = dist[t][:, outside] + dist[nxt][:, outside] - dist[t, nxt][:, None]
        if mode == "cheapest":
            pos, ci = np.unravel_index(int(np.argmin(inc)), inc.shape)
        else:
            d_to_tour = dist[np.ix_(t, outside)].min(axis=0)
            ci = int(d_to_tour.argmin() if mode == "nearest" else d_to_tour.argmax())
            pos = int(np.argmin(inc[:, ci]))
        tour.insert(pos + 1, int(outside[ci]))
        in_tour[outside[ci]] = True
    return np.asarray(tour, np.int32)


def nearest_insertion_tour(dist: np.ndarray, start: int = 0) -> np.ndarray:
    return _insertion_tour(dist, "nearest", start)


def farthest_insertion_tour(dist: np.ndarray, start: int = 0) -> np.ndarray:
    return _insertion_tour(dist, "farthest", start)


def cheapest_insertion_tour(dist: np.ndarray, start: int = 0) -> np.ndarray:
    return _insertion_tour(dist, "cheapest", start)


def kruskal_mst_edges(dist: np.ndarray) -> List[Tuple[int, int]]:
    """The minimum spanning tree's edges (u, v), u < v, in Kruskal's order:
    by weight, ties in row-major order of the pairs."""
    n = dist.shape[0]
    iu, ju = np.triu_indices(n, 1)
    order = np.argsort(np.asarray(dist, np.float64)[iu, ju], kind="stable")
    root = list(range(n))

    def find(x: int) -> int:
        while root[x] != x:
            root[x] = root[root[x]]
            x = root[x]
        return x

    out: List[Tuple[int, int]] = []
    for k in order:
        u, v = int(iu[k]), int(ju[k])
        ru, rv = find(u), find(v)
        if ru != rv:
            root[ru] = rv
            out.append((u, v))
            if len(out) == n - 1:
                break
    return out


def christofides_parts(dist: np.ndarray) -> Tuple[List[Tuple[int, int]], List[Tuple[int, int]]]:
    """(the MST's edges in Kruskal's order, the minimum-weight perfect
    matching on its odd-degree vertices as pairs (u, v), u < v)."""
    n = dist.shape[0]
    mst = kruskal_mst_edges(dist)
    deg = np.zeros(n, np.int64)
    for u, v in mst:
        deg[u] += 1
        deg[v] += 1
    odd = np.nonzero(deg % 2 == 1)[0]
    pairs = min_weight_perfect_matching(np.asarray(dist, np.float64)[np.ix_(odd, odd)])
    return mst, sorted((int(min(odd[a], odd[b])), int(max(odd[a], odd[b]))) for a, b in pairs)


def _add_edge(adj: List[dict], u: int, v: int, key: Optional[int] = None) -> None:
    """networkx's `MultiGraph.add_edge` on dicts {neighbour: {key: None}}
    shared by both ends (a new neighbour goes last; a parallel edge takes
    the next free key)."""
    keys = adj[u].get(v)
    if keys is None:
        keys = {}
        adj[u][v] = adj[v][u] = keys
    if key is None:
        key = len(keys)
        while key in keys:
            key += 1
    keys[key] = None


def christofides_tour(dist: np.ndarray) -> np.ndarray:
    """Christofides' 1.5-approximation (`TSP/christofides.py`): MST, plus a
    minimum-weight perfect matching on its odd-degree vertices, then the
    Eulerian circuit from city 0 shortcut to a tour."""
    n = dist.shape[0]
    mst, matching = christofides_parts(dist)
    tree: List[List[int]] = [[] for _ in range(n)]  # the MST graph's adjacency, in insertion order
    for u, v in mst:
        tree[u].append(v)
        tree[v].append(u)
    multi: List[dict] = [{} for _ in range(n)]  # nx.MultiGraph(mst): edges re-added node by node
    seen = set()
    for u in range(n):
        for v in tree[u]:
            if (u, v) not in seen:
                _add_edge(multi, u, v, 0)
            seen.add((v, u))
    for u, v in matching:
        _add_edge(multi, u, v)
    adj: List[dict] = [{} for _ in range(n)]  # the circuit's copy of the multigraph
    for u in range(n):
        for v, keys in multi[u].items():
            for key in keys:
                _add_edge(adj, u, v, key)
    # Hierholzer's walk as networkx's `_multigraph_eulerian_circuit` takes it:
    # always the first remaining edge of the vertex on top of the stack
    stack, last, order = [0], None, []
    while stack:
        cur = stack[-1]
        if not adj[cur]:
            if last is not None:
                order.append(last)
            last = cur
            stack.pop()
        else:
            nxt, keys = next(iter(adj[cur].items()))
            del keys[next(iter(keys))]
            if not keys:
                del adj[cur][nxt], adj[nxt][cur]
            stack.append(nxt)
    visited = np.zeros(n, bool)
    tour = []
    for a in order:
        if not visited[a]:
            tour.append(a)
            visited[a] = True
    return np.asarray(tour, np.int32)


def _patch_deltas(dist: np.ndarray, succ: np.ndarray, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """[len(rows), len(cols)]: the cost of redirecting a -> succ(a), b ->
    succ(b) into a -> succ(b), b -> succ(a), for a in rows (of the cycle
    earlier in the list) and b in cols, in the JAX package's order of
    operations."""
    sa, sb = succ[rows], succ[cols]
    return (dist[rows[:, None], sb[None, :]] + dist[cols[None, :], sa[:, None]]
            - dist[rows, sa][:, None] - dist[cols, sb][None, :])


def karp_steele_tour(dist: np.ndarray) -> np.ndarray:
    """Greedy Karp-Steele patching (`TSP/gksp.py`): the assignment
    relaxation's cycle cover (scipy), then repeatedly the two cycles whose
    patch is cheapest (the first such pair in list order) are merged into
    one, appended last. The cycles keep their relative order, so a pair's
    cost never changes: each is computed once, all at first as one matrix,
    then each merged cycle's against the rest."""
    from scipy.optimize import linear_sum_assignment

    n = dist.shape[0]
    d = dist.astype(np.float64).copy()
    np.fill_diagonal(d, np.inf)
    _, succ = linear_sum_assignment(d)
    cycles: List[List[int]] = []
    seen = np.zeros(n, bool)
    for s in range(n):
        if seen[s]:
            continue
        cyc = []
        v = s
        while not seen[v]:
            seen[v] = True
            cyc.append(v)
            v = int(succ[v])
        cycles.append(cyc)
    succ = np.asarray(succ, np.int64)
    c0 = len(cycles)
    cost = np.full((2 * c0, 2 * c0), np.inf)  # cost[x, y]: the pair's cheapest patch, x earlier in the list
    nodes = np.concatenate([np.asarray(c, np.int64) for c in cycles])
    starts = np.cumsum([0] + [len(c) for c in cycles[:-1]])
    block = np.minimum.reduceat(np.minimum.reduceat(_patch_deltas(dist, succ, nodes, nodes), starts, axis=1),
                                starts, axis=0)
    cost[:c0, :c0] = np.where(np.triu(np.ones((c0, c0), bool), 1), block, np.inf)
    ids, pool, new = list(range(c0)), dict(enumerate(cycles)), c0
    while len(ids) > 1:
        sub = cost[np.ix_(ids, ids)]
        sub[np.tril_indices(len(ids))] = np.inf
        ia, ib = np.unravel_index(int(np.argmin(sub)), sub.shape)  # the first cheapest pair, as JAX's loop finds it
        x, y = ids[ia], ids[ib]
        ca, cb = pool.pop(x), pool.pop(y)
        delta = _patch_deltas(dist, succ, np.asarray(ca), np.asarray(cb))
        i, j = np.unravel_index(int(np.argmin(delta)), delta.shape)
        merged = ca[: i + 1] + cb[j + 1:] + cb[: j + 1] + ca[i + 1:]
        succ[np.asarray(merged)] = np.roll(np.asarray(merged), -1)
        ids = [c for c in ids if c not in (x, y)]
        if ids:
            rest = np.concatenate([np.asarray(pool[c], np.int64) for c in ids])
            starts = np.cumsum([0] + [len(pool[c]) for c in ids[:-1]])
            mins = np.minimum.reduceat(_patch_deltas(dist, succ, rest, np.asarray(merged)).min(axis=1), starts)
            cost[ids, new] = mins
        pool[new] = merged
        ids.append(new)
        new += 1
    return np.asarray(pool[ids[0]], np.int32)


# ------------------------------------------------------- batched local search
def _as_dist(dist, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(dist) if not torch.is_tensor(dist) else dist,
                           dtype=torch.float32).to(device)


def tour_lengths(tours: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    return dist[tours, torch.roll(tours, -1, dims=1)].sum(dim=1)


def move_deltas(tours: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """2-opt deltas f32 [B, N, N]: delta[b, i, j] (0 < i < j < N-1) = the
    length change of reversing tours[b, i..j]; inf elsewhere (the dense
    form of `opt_2.py:25-47`'s double loop)."""
    n = tours.shape[1]
    prev, nxt = torch.roll(tours, 1, dims=1), torch.roll(tours, -1, dims=1)
    d_pi_tj = dist[prev[:, :, None], tours[:, None, :]]
    d_ti_nj = dist[tours[:, :, None], nxt[:, None, :]]
    d_pi_ti, d_tj_nj = dist[prev, tours], dist[tours, nxt]
    delta = d_pi_tj + d_ti_nj - d_pi_ti[:, :, None] - d_tj_nj[:, None, :]
    ii = torch.arange(n, device=tours.device)
    valid = (ii[:, None] < ii[None, :]) & (ii[:, None] > 0) & (ii[None, :] < n - 1)
    return torch.where(valid, delta, torch.inf)


def _reverse(tours: torch.Tensor, i: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """Reverse tours[b, i[b]..j[b]] (position arithmetic, one gather)."""
    pos = torch.arange(tours.shape[1], device=tours.device)[None, :]
    inside = (pos >= i[:, None]) & (pos <= j[:, None])
    return torch.gather(tours, 1, torch.where(inside, i[:, None] + j[:, None] - pos, pos))


def two_opt_best_improvement(tours, dist, max_iters: int = 200, device=None,
                             check_every: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched best-improvement 2-opt descent: each iteration applies each
    tour's single best move while it shortens the tour by more than 1e-6
    (then the tour stays). Returns (tours [B, N] int64, lengths [B] f32).
    Stops early, every `check_every` iterations, once no tour moved."""
    dev = resolve_device(device) if not torch.is_tensor(tours) else tours.device
    d = _as_dist(dist, dev)
    t = torch.as_tensor(tours).to(dev).long()
    b, n = t.shape
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    rows = torch.arange(b, device=dev)
    for it in range(max_iters):
        delta = move_deltas(t, d).reshape(b, n * n)
        k = delta.argmin(dim=1)
        improve = delta[rows, k] < -1e-6
        moved = improve & ~done
        t = torch.where(moved[:, None], _reverse(t, k // n, k % n), t)
        done = done | ~improve
        if (it + 1) % check_every == 0 and bool(done.all()):
            break
    return t, tour_lengths(t, d)


def three_opt_tour(dist: np.ndarray, tour: np.ndarray, max_rounds: int = 50) -> Tuple[np.ndarray, float]:
    """3-opt best-improvement descent (`TSP/opt_3.py`: every segment triple
    i < j < k, all 7 reconnections, until no move improves); each i's whole
    (j, k) plane is one numpy delta array. Host-side. Returns (tour,
    length)."""
    d = np.asarray(dist, np.float64)
    t = np.asarray(tour, np.int64).copy()
    n = len(t)
    if n < 6:
        return t, float(-obj_tsp(t, d))
    for _ in range(max_rounds):
        best_delta, best_move = -1e-9, None
        for i in range(n - 2):
            a, b = t[i], t[i + 1]
            j = np.arange(i + 1, n - 1)
            k = np.arange(i + 2, n if i > 0 else n - 1)  # i == 0, k == n-1 would re-split edge (f == a)
            J, K = np.meshgrid(j, k, indexing="ij")
            valid = J < K
            c, dd = t[J], t[J + 1]
            e, f = t[K], t[(K + 1) % n]
            d0 = d[a, b] + d[c, dd] + d[e, f]
            deltas = np.stack([
                d[a, c] + d[b, dd] + d[e, f],  # rev X1
                d[a, b] + d[c, e] + d[dd, f],  # rev X2
                d[a, c] + d[b, e] + d[dd, f],  # rev both
                d[a, dd] + d[e, b] + d[c, f],  # swap
                d[a, e] + d[dd, b] + d[c, f],  # swap + rev X2
                d[a, dd] + d[e, c] + d[b, f],  # swap + rev X1
                d[a, e] + d[dd, c] + d[b, f],  # swap + rev both
            ]) - d0
            deltas = np.where(valid[None], deltas, np.inf)
            case, jj, kk = np.unravel_index(np.argmin(deltas), deltas.shape)
            if deltas[case, jj, kk] < best_delta:
                best_delta = float(deltas[case, jj, kk])
                best_move = (int(case), i, int(J[jj, kk]), int(K[jj, kk]))
        if best_move is None:
            break
        case, i, j, k = best_move
        A, X1, X2, C = t[: i + 1], t[i + 1: j + 1], t[j + 1: k + 1], t[k + 1:]
        r = lambda s: s[::-1]  # noqa: E731
        parts = [(r(X1), X2), (X1, r(X2)), (r(X1), r(X2)), (X2, X1), (r(X2), X1), (X2, r(X1)), (r(X2), r(X1))][case]
        t = np.concatenate([A, *parts, C])
    return t, float(-obj_tsp(t, d))


def or_opt_draws(gen: Optional[torch.Generator], num_iters: int, batch: int, n: int, device) -> Tuple[torch.Tensor, ...]:
    """(segment lengths in 1..3, segment starts and insertion points in
    [1, n-3)), each [T, B]."""
    shape = (num_iters, batch)
    return (torch.randint(1, 4, shape, generator=gen, device=device),
            torch.randint(1, n - 3, shape, generator=gen, device=device),
            torch.randint(1, n - 3, shape, generator=gen, device=device))


def or_opt_moves(tours, dist, num_iters: int = 200, gen: Optional[torch.Generator] = None,
                 draws: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
                 device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched sampled or-opt (`opt_3.py` capability): each step relocates a
    random segment of 1-3 cities to a random position and keeps the result
    if it is shorter by more than 1e-6. `draws` = (seg, i, j) [T, B] from
    `or_opt_draws`, drawn from `gen` unless given."""
    dev = resolve_device(device) if not torch.is_tensor(tours) else tours.device
    d = _as_dist(dist, dev)
    ts = torch.as_tensor(tours).to(dev).long()
    b, n = ts.shape
    if draws is None:
        draws = or_opt_draws(gen, num_iters, b, n, dev)
    pos = torch.arange(n, device=dev)[None, :]
    ls = tour_lengths(ts, d)
    for s in range(num_iters):
        seg, i, j = (x[s].to(dev).long()[:, None] for x in draws)
        # remove the segment [i, i+seg), reinsert it after position j of the
        # compacted tour: all gathers of index arithmetic
        kept = torch.gather(ts, 1, torch.where(pos < i, pos, pos + seg).clamp(0, n - 1))
        segment = torch.gather(ts, 1, (i + pos).clamp(0, n - 1))
        jj = torch.minimum(j, n - seg - 1)
        before = pos <= jj
        in_seg = (pos > jj) & (pos <= jj + seg)
        cand = torch.where(before, kept, torch.where(in_seg, torch.gather(segment, 1, (pos - jj - 1).clamp(0, n - 1)),
                                                     torch.gather(kept, 1, (pos - seg).clamp(0, n - 1))))
        cl = tour_lengths(cand, d)
        better = cl < ls - 1e-6
        ts = torch.where(better[:, None], cand, ts)
        ls = torch.where(better, cl, ls)
    return ts, ls


def tabu_search(tours, dist, num_iters: int = 100, tenure: int = 10,
                device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched 2-opt tabu search (`s_tabu.py` capability): each iteration
    takes the best non-tabu move (a tabu move when it beats the incumbent
    by 1e-6), and marks the reversed pair tabu for `tenure` iterations.
    Deterministic. Returns (best tours, best lengths)."""
    dev = resolve_device(device) if not torch.is_tensor(tours) else tours.device
    d = _as_dist(dist, dev)
    t = torch.as_tensor(tours).to(dev).long()
    b, n = t.shape
    rows = torch.arange(b, device=dev)
    tabu = torch.zeros(b, n * n, dtype=torch.int64, device=dev)
    ls = tour_lengths(t, d)
    best_t, best_l = t, ls
    for it in range(num_iters):
        delta = move_deltas(t, d).reshape(b, n * n)
        blocked = (tabu > it) & ~(ls[:, None] + delta < best_l[:, None] - 1e-6)
        masked = torch.where(blocked, torch.inf, delta)
        k = masked.argmin(dim=1)
        ok = torch.isfinite(masked[rows, k])
        t = torch.where(ok[:, None], _reverse(t, k // n, k % n), t)
        ls = torch.where(ok, ls + delta[rows, k], ls)
        tabu[rows, k] = torch.where(ok, it + tenure, tabu[rows, k])
        improve = ls < best_l
        best_t = torch.where(improve[:, None], t, best_t)
        best_l = torch.where(improve, ls, best_l)
    return best_t, best_l


def genetic_tsp(dist: np.ndarray, seed: int, pop_size: int = 64, num_generations: int = 100,
                elite_frac: float = 0.25, mutation_rate: float = 0.3, device=None) -> Tuple[np.ndarray, float]:
    """Order-crossover GA with a 2-opt polish (`TSP/ga.py`): host selection
    and crossover from `np.random.RandomState(seed)` (the JAX package draws
    that seed from its key), and every 10 generations 10 iterations of
    batched best-improvement 2-opt of the whole population on the device.
    Returns (best tour, its length)."""
    dev = resolve_device(device)
    n = dist.shape[0]
    rng = np.random.RandomState(int(seed))
    pop = np.stack([rng.permutation(n) for _ in range(pop_size)]).astype(np.int32)
    n_elite = max(2, int(pop_size * elite_frac))
    d_dev = _as_dist(dist, dev)

    def lengths(p):
        nxt = np.roll(p, -1, axis=1)
        return dist[p.reshape(-1), nxt.reshape(-1)].reshape(p.shape).sum(axis=1)

    def order_crossover(a, b):
        i, j = sorted(rng.choice(n, 2, replace=False))
        child = -np.ones(n, np.int32)
        child[i: j + 1] = a[i: j + 1]
        fill = [c for c in np.roll(b, -(j + 1)) if c not in set(a[i: j + 1])]
        child[[(j + 1 + k) % n for k in range(n - (j - i + 1))]] = fill
        return child

    best_t, best_l = None, np.inf
    for gen in range(num_generations):
        ls = lengths(pop)
        order = np.argsort(ls)
        if ls[order[0]] < best_l:
            best_l = float(ls[order[0]])
            best_t = pop[order[0]].copy()
        elite = pop[order[:n_elite]]
        children = []
        while len(children) < pop_size - n_elite:
            a, b = elite[rng.randint(n_elite)], elite[rng.randint(n_elite)]
            c = order_crossover(a, b)
            if rng.rand() < mutation_rate:
                i, j = sorted(rng.choice(n, 2, replace=False))
                c[i: j + 1] = c[i: j + 1][::-1]
            children.append(c)
        pop = np.concatenate([elite, np.stack(children)], axis=0)
        if (gen + 1) % 10 == 0:
            improved, _ = two_opt_best_improvement(torch.from_numpy(pop).to(dev), d_dev, max_iters=10)
            pop = improved.cpu().numpy().astype(np.int32)
    ls = lengths(pop)
    if ls.min() < best_l:
        best_l = float(ls.min())
        best_t = pop[ls.argmin()].copy()
    return best_t, best_l
