"""Batched TSP environment: permutation states with vectorized 2-opt moves
(counterpart of `rlsolver_tpu/envs/tsp.py`; RLSolver's `ISCO_TSP`,
`envs/env_ISCO.py:176-363`).

The state is `tours: int64 [B, N]` on the device (city visited at position
t). A 2-opt move reverses positions lo+1..hi; its length change needs four
distance lookups,
    delta = d(a, c) + d(b, d) - d(a, b) - d(c, d)
with a = tour[lo], b = tour[lo+1], c = tour[hi], d = tour[hi+1 mod N]. The
reversal is a gather through a remapped position index.

Every drawing method takes its draws from a `torch.Generator` or, where
given, from `TSPDraws` (each field [T, B] over T steps), so that a test can
feed it the JAX package's draws. Annealing temperatures are numpy float32
powers: XLA computes `decay ** arange` as the C library's `powf`, not as a
running product. A step is about 30 small launches: on the card the chains
replay as CUDA graphs of GRAPH_CHUNK steps, equal to the eager loop bit for
bit.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from rlsolver_tpu_torch.capture import CapturedCall
from rlsolver_tpu_torch.device import resolve_device

GRAPH_CHUNK = 100  # chain steps in one CUDA graph


class TSPDraws(NamedTuple):
    """A chain's proposals over T steps, each [T, B]: the position i, the
    uniform of the k-NN/uniform mix, the k-NN rank, the uniform candidate
    j, and (for `anneal`) the accept uniform."""

    i: torch.Tensor
    mix: torch.Tensor
    nn_choice: torch.Tensor
    j_rand: torch.Tensor
    u_acc: Optional[torch.Tensor] = None


def anneal_temperatures(num_steps: int, init_temp: float, final_temp: float) -> np.ndarray:
    """f32 [T]: init * decay ** t with decay = (final / init) ** (1 / T),
    each power a float32 `powf` as XLA computes it."""
    decay = np.float32((final_temp / init_temp) ** (1.0 / num_steps))
    powers = np.array([decay ** np.float32(t) for t in range(num_steps)], np.float32)
    return np.float32(init_temp) * powers


class TSPEnv:
    """Distances f32 [N, N] and each city's `knn_k` nearest neighbours on
    one device (`cuda` unless `device="cpu"`)."""

    def __init__(self, dist: np.ndarray, knn_k: int = 10, device=None):
        self.device = resolve_device(device)
        self.num_cities = int(dist.shape[0])
        self.dist = torch.as_tensor(np.asarray(dist), dtype=torch.float32).to(self.device)
        k = min(knn_k, self.num_cities - 1)
        order = np.argsort(np.asarray(dist) + np.eye(self.num_cities) * 1e18, axis=1)
        self.knn = torch.from_numpy(order[:, :k].astype(np.int64)).to(self.device)  # [N, k]
        self.knn_k = k

    # ------------------------------------------------------------------ state
    def random_tours(self, gen: Optional[torch.Generator], num_sims: int) -> torch.Tensor:
        """Uniform random permutations [num_sims, N]."""
        u = torch.rand(num_sims, self.num_cities, generator=gen, device=self.device)
        return torch.argsort(u, dim=1)

    def nearest_neighbor_tours(self, gen: Optional[torch.Generator], num_sims: int,
                               starts: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Greedy nearest-neighbour tours from random (or given) start cities."""
        n = self.num_cities
        if starts is None:
            starts = torch.randint(0, n, (num_sims,), generator=gen, device=self.device)
        starts = starts.to(self.device).long()
        rows = torch.arange(num_sims, device=self.device)
        tours = torch.zeros(num_sims, n, dtype=torch.long, device=self.device)
        tours[:, 0] = starts
        visited = torch.zeros(num_sims, n, dtype=torch.bool, device=self.device)
        visited[rows, starts] = True
        cur = starts
        for t in range(1, n):
            nxt = torch.where(visited, torch.inf, self.dist[cur]).argmin(dim=1)
            tours[:, t] = nxt
            visited[rows, nxt] = True
            cur = nxt
        return tours

    def tour_length(self, tours: torch.Tensor) -> torch.Tensor:
        return self.dist[tours, torch.roll(tours, -1, dims=1)].sum(dim=1)

    # ------------------------------------------------------------------ 2-opt
    def draw(self, gen: Optional[torch.Generator], num_steps: int, batch: int, accept: bool = False) -> TSPDraws:
        """Fresh `TSPDraws` for num_steps steps of batch tours."""
        n, dev, shape = self.num_cities, self.device, (num_steps, batch)
        return TSPDraws(
            i=torch.randint(0, n, shape, generator=gen, device=dev),
            mix=torch.rand(shape, generator=gen, device=dev),
            nn_choice=torch.randint(0, self.knn_k, shape, generator=gen, device=dev),
            j_rand=torch.randint(0, n, shape, generator=gen, device=dev),
            u_acc=torch.rand(shape, generator=gen, device=dev) if accept else None,
        )

    def propose_2opt(self, tours: torch.Tensor, knn_prob: float = 0.5, gen: Optional[torch.Generator] = None,
                     draws: Optional[TSPDraws] = None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One 2-opt move per tour -> (lo, hi, delta), lo <= hi positions and
        delta the length change if positions lo+1..hi reverse. The candidate
        j is the position of one of city tour[i]'s k nearest neighbours with
        probability `knn_prob`, else uniform (`env_ISCO.py:246-267`). The
        draws are one step's ([B] each), from `gen` unless given."""
        b, n = tours.shape
        if draws is None:
            d = self.draw(gen, 1, b)
            draws = TSPDraws(d.i[0], d.mix[0], d.nn_choice[0], d.j_rand[0])
        rows = torch.arange(b, device=tours.device)
        i = draws.i.long()
        a_city = tours[rows, i]
        pos = torch.empty_like(tours).scatter_(1, tours, torch.arange(n, device=tours.device).expand(b, n))
        j_knn = pos[rows, self.knn[a_city, draws.nn_choice.long()]]
        j = torch.where(draws.mix < knn_prob, j_knn, draws.j_rand.long())
        lo, hi = torch.minimum(i, j), torch.maximum(i, j)
        a, bb = tours[rows, lo], tours[rows, (lo + 1) % n]
        c, dd = tours[rows, hi], tours[rows, (hi + 1) % n]
        dist = self.dist
        delta = dist[a, c] + dist[bb, dd] - dist[a, bb] - dist[c, dd]
        degenerate = (lo == hi) | ((lo == 0) & (hi == n - 1))
        return lo, hi, torch.where(degenerate, torch.zeros_like(delta), delta)

    @staticmethod
    def apply_2opt(tours: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, accept: torch.Tensor) -> torch.Tensor:
        """Reverse positions lo+1..hi (inclusive) of the tours where accept."""
        n = tours.shape[1]
        t = torch.arange(n, device=tours.device)[None, :]
        lo_, hi_ = lo[:, None], hi[:, None]
        inside = (t > lo_) & (t <= hi_) & accept[:, None]
        return torch.gather(tours, 1, torch.where(inside, lo_ + 1 + hi_ - t, t))

    # --------------------------------------------------------------- solvers
    def _steps(self, state: List[torch.Tensor], draws: TSPDraws, temps: Optional[torch.Tensor],
               knn_prob: float) -> None:
        """len(draws.i) steps of the chain on state = [tours, lengths, best
        tours, best lengths], written back in place: annealed (accept when
        shorter or u < exp(-delta / temp)) with `temps`, else improving only."""
        tours, lengths, best_t, best_l = state
        for s in range(draws.i.shape[0]):
            lo, hi, delta = self.propose_2opt(tours, knn_prob, draws=TSPDraws(*(x[s] for x in draws[:4])))
            accept = delta < 0
            if temps is not None:
                accept = accept | (draws.u_acc[s] < torch.exp(-delta / temps[s]))
            tours = self.apply_2opt(tours, lo, hi, accept)
            lengths = lengths + torch.where(accept, delta, torch.zeros_like(delta))
            if temps is not None:
                better = lengths < best_l
                best_l = torch.where(better, lengths, best_l)
                best_t = torch.where(better[:, None], tours, best_t)
        for dst, src in zip(state, (tours, lengths, best_t, best_l)):
            dst.copy_(src)

    def _chain(self, tours: torch.Tensor, draws: TSPDraws, temps: Optional[torch.Tensor], knn_prob: float,
               cuda_graph: bool) -> List[torch.Tensor]:
        """Runs the chain in chunks of GRAPH_CHUNK steps, each one CUDA graph
        replay on the card (`capture.CapturedCall`) unless `cuda_graph` is
        off; the remainder runs eagerly."""
        lengths = self.tour_length(tours)
        state = [tours.clone(), lengths.clone(), tours.clone(), lengths.clone()]
        annealed = temps is not None
        streams = list(draws[:4]) + ([draws.u_acc, temps] if annealed else [])

        def chunk(*xs):  # i, mix, nn_choice, j_rand[, u_acc, temps]
            self._steps(state, TSPDraws(*xs[:5]), xs[5] if annealed else None, knn_prob)

        call = CapturedCall(chunk, cuda_graph, restore=state)
        total = draws.i.shape[0]
        full = total - total % GRAPH_CHUNK
        for c in range(0, full, GRAPH_CHUNK):
            call(*(x[c:c + GRAPH_CHUNK] for x in streams))
        if full < total:
            chunk(*(x[full:] for x in streams))
        return state

    def anneal(self, tours: torch.Tensor, num_steps: int = 5000, init_temp: float = 1.0, final_temp: float = 1e-3,
               knn_prob: float = 0.5, gen: Optional[torch.Generator] = None, draws: Optional[TSPDraws] = None,
               cuda_graph: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        """Annealed batched 2-opt chains (ISCO_TSP). A move is accepted when
        it shortens the tour or u < exp(-delta / temp). Returns (best tours,
        best lengths). On the card the steps replay as CUDA graphs of
        GRAPH_CHUNK steps unless `cuda_graph` is off."""
        if draws is None:
            draws = self.draw(gen, num_steps, tours.shape[0], accept=True)
        draws = TSPDraws(*(None if x is None else x[:num_steps] for x in draws))
        temps = torch.from_numpy(anneal_temperatures(num_steps, init_temp, final_temp)).to(tours.device)
        _, _, best_t, best_l = self._chain(tours, draws, temps, knn_prob, cuda_graph)
        return best_t, best_l

    def two_opt_descent(self, tours: torch.Tensor, num_steps: int = 5000, knn_prob: float = 0.75,
                        gen: Optional[torch.Generator] = None, draws: Optional[TSPDraws] = None,
                        cuda_graph: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        """Sampled improving 2-opt (RLSolver's `opt_2.py`), batched, graphed on
        the card as `anneal`. Returns (tours, lengths)."""
        if draws is None:
            draws = self.draw(gen, num_steps, tours.shape[0])
        draws = TSPDraws(*(None if x is None else x[:num_steps] for x in draws))
        tours, lengths, _, _ = self._chain(tours, draws, None, knn_prob, cuda_graph)
        return tours, lengths
