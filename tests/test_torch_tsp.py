"""The TSP axis of the port (`core/io.py`'s readers, `generate_tsp_coords`,
`envs/tsp.py`, `classical/tsp.py` with `classical/matching.py`, `run.py
--problem tsp`) against the JAX package on the same seeded instances:
readers, the generator, the host constructions and Karp-Steele exact;
Christofides' tour equal to the networkx-built one (its MST and matching
equal too), within 1.5 of a brute-force optimum; the matching equal to
networkx's; TSPEnv's proposals, 200 annealing and descent steps with JAX's
draws injected (tours equal, lengths within 1e-5); best-improvement 2-opt,
3-opt, or-opt (JAX's draws), tabu search and the GA (JAX's integer seed)
with equal tours; the CLI's four algorithms within 1e-4."""

import itertools
import os

import jax
import jax.numpy as jnp
import networkx as nx
import numpy as np
import pytest
import torch

from rlsolver_tpu import run as jrun
from rlsolver_tpu.classical import tsp as jct
from rlsolver_tpu.core import generate as jgen
from rlsolver_tpu.core import io as jio
from rlsolver_tpu.envs import tsp as jtsp
from rlsolver_tpu_torch import run as trun
from rlsolver_tpu_torch.classical import matching as tmatch
from rlsolver_tpu_torch.classical import tsp as tct
from rlsolver_tpu_torch.core import generate as tgen
from rlsolver_tpu_torch.core import io as tio
from rlsolver_tpu_torch.envs import tsp as ttsp

torch.set_num_threads(1)
B = 6


def dist_of(n: int, seed: int) -> np.ndarray:
    return jio.tsp_distance_matrix(jgen.generate_tsp_coords(1, n, seed=seed)[0])


def test_readers_and_generator_equal(tmp_path):
    for mode in ("uniform", "gaussian"):
        np.testing.assert_array_equal(tgen.generate_tsp_coords(3, 9, 2.0, 5.0, mode, seed=4),
                                      jgen.generate_tsp_coords(3, 9, 2.0, 5.0, mode, seed=4))
    path = tmp_path / "x.tsp"
    path.write_text("NAME x\nNODE_COORD_SECTION\n1 0.5 1.5\n2 3 4\n1 7.25 8\n2 9 10\n3 11 12.5\nEOF\n4 1 1\n")
    a, b = tio.read_tsp_coords(str(path)), jio.read_tsp_coords(str(path))
    np.testing.assert_array_equal(a, b)
    assert a.shape == (3, 2)
    c = tgen.generate_tsp_coords(1, 15, seed=2)[0]
    np.testing.assert_array_equal(tio.tsp_distance_matrix(c), jio.tsp_distance_matrix(c))


def test_env_tables_lengths_and_nearest_neighbour_tours():
    d = dist_of(15, 1)
    jenv, tenv = jtsp.TSPEnv(d, knn_k=5), ttsp.TSPEnv(d, knn_k=5, device="cpu")
    np.testing.assert_array_equal(tenv.knn.numpy(), np.asarray(jenv.knn))
    key = jax.random.PRNGKey(3)
    jt = jenv.nearest_neighbor_tours(key, B)
    starts = jax.random.randint(key, (B,), 0, 15)
    tt = tenv.nearest_neighbor_tours(None, B, starts=torch.from_numpy(np.array(starts)))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    perm = np.array(jenv.random_tours(key, B))
    np.testing.assert_allclose(tenv.tour_length(torch.from_numpy(perm).long()).numpy(),
                               np.asarray(jenv.tour_length(jnp.asarray(perm))), rtol=0, atol=1e-5)
    assert sorted(tenv.random_tours(torch.Generator().manual_seed(0), 2)[1].tolist()) == list(range(15))


def _prop_draws(k, b, n, knn_k):
    k_i, k_mix, k_nn, k_rand = jax.random.split(k, 4)
    return (jax.random.randint(k_i, (b,), 0, n), jax.random.uniform(k_mix, (b,)),
            jax.random.randint(k_nn, (b,), 0, knn_k), jax.random.randint(k_rand, (b,), 0, n))


def _stack(draws):
    return ttsp.TSPDraws(*(torch.from_numpy(np.stack([np.asarray(d[f]) for d in draws]))
                           for f in range(len(draws[0]))))


def test_propose_and_apply_2opt_equal():
    n = 12
    d = dist_of(n, 2)
    jenv, tenv = jtsp.TSPEnv(d, knn_k=4), ttsp.TSPEnv(d, knn_k=4, device="cpu")
    tours = jenv.random_tours(jax.random.PRNGKey(0), 64)
    for s in range(3):
        k = jax.random.PRNGKey(10 + s)
        jlo, jhi, jdelta = jenv.propose_2opt(k, tours, knn_prob=0.5)
        dr = _stack([_prop_draws(k, 64, n, 4)])
        tlo, thi, tdelta = tenv.propose_2opt(torch.from_numpy(np.array(tours)).long(), 0.5,
                                             draws=ttsp.TSPDraws(*(x[0] for x in dr[:4])))
        np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
        np.testing.assert_array_equal(thi.numpy(), np.asarray(jhi))
        np.testing.assert_allclose(tdelta.numpy(), np.asarray(jdelta), rtol=0, atol=1e-6)
        acc = np.asarray(jdelta) < 0.05
        jt = jtsp.TSPEnv.apply_2opt(tours, jlo, jhi, jnp.asarray(acc))
        tt = ttsp.TSPEnv.apply_2opt(torch.from_numpy(np.array(tours)).long(), tlo, thi, torch.from_numpy(acc))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        tours = jt


def test_anneal_and_descent_equal_with_jax_draws():
    n, steps = 20, 200
    d = dist_of(n, 3)
    jenv, tenv = jtsp.TSPEnv(d), ttsp.TSPEnv(d, device="cpu")
    start = jenv.random_tours(jax.random.PRNGKey(1), B)
    key = jax.random.PRNGKey(7)
    jt, jl = jenv.anneal(key, start, num_steps=steps, init_temp=0.5, final_temp=1e-3)
    draws, kc = [], key
    for _ in range(steps):
        kc, k_prop, k_acc = jax.random.split(kc, 3)
        draws.append(_prop_draws(k_prop, B, n, tenv.knn_k) + (jax.random.uniform(k_acc, (B,)),))
    tt, tl = tenv.anneal(torch.from_numpy(np.array(start)).long(), steps, 0.5, 1e-3, draws=_stack(draws))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-5)
    jt2, jl2 = jenv.two_opt_descent(key, start, num_steps=steps)
    draws = [_prop_draws(k, B, n, tenv.knn_k) for k in jax.random.split(key, steps)]
    tt2, tl2 = tenv.two_opt_descent(torch.from_numpy(np.array(start)).long(), steps, draws=_stack(draws))
    np.testing.assert_array_equal(tt2.numpy(), np.asarray(jt2))
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(ttsp.anneal_temperatures(steps, 0.5, 1e-3),
                                  np.asarray(0.5 * ((1e-3 / 0.5) ** (1.0 / steps)) ** jnp.arange(steps)))


def test_chain_chunks_equal_one_loop():
    # the chain runs in chunks of GRAPH_CHUNK steps (CUDA graphs on the card)
    # and an eager remainder: the same as one pass of the step loop
    n, steps = 20, ttsp.GRAPH_CHUNK + 30
    tenv = ttsp.TSPEnv(dist_of(n, 4), device="cpu")
    gen = torch.Generator().manual_seed(0)
    start, draws = tenv.random_tours(gen, B), tenv.draw(gen, steps, B, accept=True)
    temps = torch.from_numpy(ttsp.anneal_temperatures(steps, 1.0, 1e-3))
    lengths = tenv.tour_length(start)
    state = [start.clone(), lengths.clone(), start.clone(), lengths.clone()]
    tenv._steps(state, draws, temps, 0.5)
    bt, bl = tenv.anneal(start, steps, 1.0, 1e-3, draws=draws)
    assert torch.equal(bt, state[2]) and torch.equal(bl, state[3])


@pytest.mark.parametrize("name", ["nearest_neighbor_tour", "nearest_insertion_tour", "farthest_insertion_tour",
                                  "cheapest_insertion_tour", "karp_steele_tour"])
def test_host_constructions_equal(name):
    for n, seed in ((7, 0), (20, 1), (33, 2)):
        d = dist_of(n, seed)
        np.testing.assert_array_equal(getattr(tct, name)(d), getattr(jct, name)(d))


@pytest.mark.parametrize("n", [6, 9, 14, 25, 60, 120])
def test_christofides_equal_to_networkx(n):
    for seed in range(2):
        d = dist_of(n, 100 * n + seed)
        np.testing.assert_array_equal(tct.christofides_tour(d), jct.christofides_tour(d))
        g = nx.Graph()
        for i in range(n):
            for j in range(i + 1, n):
                g.add_edge(i, j, weight=float(d[i, j]))
        mst = nx.minimum_spanning_tree(g)
        odd = [v for v, k in mst.degree() if k % 2 == 1]
        ref_match = {tuple(sorted(e)) for e in nx.algorithms.matching.min_weight_matching(g.subgraph(odd))}
        edges, match = tct.christofides_parts(d)
        assert sorted(edges) == sorted(tuple(sorted(e)) for e in mst.edges())
        assert set(match) == ref_match


def test_christofides_within_its_bound():
    n = 8
    d = dist_of(n, 8)
    best = min(d[(0,) + p, (p + (0,))].sum() for p in itertools.permutations(range(1, n)))
    t = tct.christofides_tour(d)
    assert sorted(t.tolist()) == list(range(n))
    assert -tct.obj_tsp(t, d) <= 1.5 * best + 1e-9


@pytest.mark.parametrize("n", [2, 4, 10, 17, 30])
def test_matching_equals_networkx(n):
    rng = np.random.default_rng(n)
    for trial in range(3):
        w = rng.random((n, n))
        w = np.triu(w, 1) + np.triu(w, 1).T
        g = nx.Graph()
        for i in range(n):
            for j in range(i + 1, n):
                g.add_edge(i, j, weight=float(w[i, j] - 0.5 * trial))
        for card in (False, True):
            mate = tmatch.max_weight_matching(np.where(np.eye(n, dtype=bool), 0.0, w - 0.5 * trial), card)
            got = {(u, int(mate[u])) for u in range(n) if 0 <= u < mate[u]}
            ref = {tuple(sorted(e)) for e in nx.max_weight_matching(g, maxcardinality=card)}
            assert got == ref, (n, trial, card)
        if n % 2 == 0:
            ref = {tuple(sorted(e)) for e in nx.min_weight_matching(g)}
            assert set(tmatch.min_weight_perfect_matching(w - 0.5 * trial)) == ref


def test_two_opt_three_opt_tabu_equal():
    n = 20
    d = dist_of(n, 5)
    start = np.array(jtsp.TSPEnv(d).random_tours(jax.random.PRNGKey(2), B))
    jt, jl = jct.two_opt_best_improvement(jnp.asarray(start), jnp.asarray(d), max_iters=200)
    tt, tl = tct.two_opt_best_improvement(start, d, max_iters=200, device="cpu")
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-5)
    jt, jl = jct.tabu_search(jax.random.PRNGKey(0), jnp.asarray(start), jnp.asarray(d), num_iters=60, tenure=5)
    tt, tl = tct.tabu_search(start, d, num_iters=60, tenure=5, device="cpu")
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-5)
    for row in start[:2]:
        a, la = tct.three_opt_tour(d, row, max_rounds=20)
        b, lb = jct.three_opt_tour(d, row, max_rounds=20)
        np.testing.assert_array_equal(a, b)
        assert la == lb


def test_or_opt_equal_with_jax_draws():
    n, steps = 16, 150
    d = dist_of(n, 6)
    start = np.array(jtsp.TSPEnv(d).random_tours(jax.random.PRNGKey(3), B))
    key = jax.random.PRNGKey(4)
    jt, jl = jct.or_opt_moves(key, jnp.asarray(start), jnp.asarray(d), num_iters=steps)
    seg, ii, jj = [], [], []
    for k in jax.random.split(key, steps):
        k1, k2, k3 = jax.random.split(k, 3)
        seg.append(np.asarray(jax.random.randint(k1, (B,), 1, 4)))
        ii.append(np.asarray(jax.random.randint(k2, (B,), 1, n - 3)))
        jj.append(np.asarray(jax.random.randint(k3, (B,), 1, n - 3)))
    draws = tuple(torch.from_numpy(np.stack(x)) for x in (seg, ii, jj))
    tt, tl = tct.or_opt_moves(start, d, steps, draws=draws, device="cpu")
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-5)


def test_genetic_equal_with_jax_seed():
    d = dist_of(14, 7)
    key = jax.random.PRNGKey(5)
    jt, jl = jct.genetic_tsp(key, d, pop_size=16, num_generations=20)
    seed = int(jax.random.randint(key, (), 0, 2 ** 31 - 1))
    tt, tl = tct.genetic_tsp(d, seed, pop_size=16, num_generations=20, device="cpu")
    np.testing.assert_array_equal(tt, jt)
    assert tl == jl


@pytest.mark.parametrize("alg", ["nn", "christofides", "karp_steele", "cheapest_insertion"])
def test_cli_tsp_equals_jax(alg, tmp_path, capsys):
    coords = tgen.generate_tsp_coords(1, 40, seed=40)[0]
    with open(os.path.join(tmp_path, "r40.tsp"), "w") as f:
        f.writelines(f"{i + 1} {x!r} {y!r}\n" for i, (x, y) in enumerate(coords.tolist()))
    path = str(tmp_path / "r40.tsp")
    length, _ = trun.run_tsp(alg, path, 0, device="cpu")
    ref, _ = jrun.run_tsp(alg, path, 0)
    assert abs(length - ref) <= 1e-4 * ref
    assert trun.main(["--problem", "tsp", "--alg", alg, "--data-dir", str(tmp_path), "--device", "cpu"]) == 0
    assert capsys.readouterr().out.startswith(f"{alg} r40.tsp: length=")


# public entry points that put tensors on a device: `cuda` unless told "cpu"
ENTRY_POINTS = {
    "TSPEnv": lambda dev: ttsp.TSPEnv(dist_of(6, 0), device=dev).dist,
    "two_opt_best_improvement": lambda dev: tct.two_opt_best_improvement(
        np.arange(6)[None], dist_of(6, 0), max_iters=1, device=dev)[0],
    "or_opt_moves": lambda dev: tct.or_opt_moves(np.arange(6)[None], dist_of(6, 0), 1, device=dev)[0],
    "tabu_search": lambda dev: tct.tabu_search(np.arange(6)[None], dist_of(6, 0), 1, device=dev)[0],
    "genetic_tsp": lambda dev: tct.genetic_tsp(dist_of(6, 0), 0, 4, 1, device=dev) and torch.zeros(0),
    "run_tsp": lambda dev: trun._tsp_solvers()["nn"](dist_of(6, 0), 0, trun.Options(device=dev)) and torch.zeros(0),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_need_a_card_unless_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    assert ENTRY_POINTS[name]("cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name](None)
