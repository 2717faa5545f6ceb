"""The classical maxcut baselines of the port (`rlsolver_tpu_torch/classical/`:
greedy, random walk, simulated annealing, GA, BLS, SDP) against the JAX
package's on the CPU. Every draw of a JAX run is made with JAX and injected
into the port (start bits, nodes, uniforms, masks, tenures, Gaussians), so
on integer weights the best bits and cuts are equal; SDP's vectors are
float sums in other orders, held at atol 1e-4. Every returned cut equals
the host objective of the returned bits."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlsolver_tpu.classical import bls as jbls
from rlsolver_tpu.classical import genetic as jga
from rlsolver_tpu.classical import greedy as jgreedy
from rlsolver_tpu.classical import random_walk as jrw
from rlsolver_tpu.classical import sdp as jsdp
from rlsolver_tpu.classical import simulated_annealing as jsa
from rlsolver_tpu.core.generate import graph_from_name as j_graph_from_name
from rlsolver_tpu.core.graph import Graph as JGraph
from rlsolver_tpu.envs.maxcut import MaxcutEnv as JMaxcutEnv
from rlsolver_tpu_torch.classical import bls, genetic, greedy, random_walk, sdp, simulated_annealing as sa
from rlsolver_tpu_torch.core.generate import graph_from_name
from rlsolver_tpu_torch.core.graph import Graph
from rlsolver_tpu_torch.problems.objectives import obj_maxcut

torch.set_num_threads(1)


def weighted_pair(n=40, m=160, seed=3):
    """The same random graph with integer weights in +-{1..5} in both packages."""
    rng = np.random.default_rng(seed)
    edges = {}
    while len(edges) < m:
        a, b = sorted(rng.choice(n, 2, replace=False).tolist())
        edges[(a, b)] = float(rng.choice([-5, -3, -2, -1, 1, 2, 4, 5]))
    el = [(a, b, w) for (a, b), w in edges.items()]
    return JGraph.from_edge_list(n, el), Graph.from_edge_list(n, el)


def pair(name):
    return j_graph_from_name(name), graph_from_name(name)


def check_host(bits, cut, g):
    assert obj_maxcut(np.asarray(bits).astype(np.int64), g) == cut


# -------------------------------------------------------------------- greedy
@pytest.mark.parametrize("name", ["BA_100_ID0", "BA_100_ID1", "BA_100_ID2", "weighted"])
def test_greedy_matches_jax(name):
    jg, tg = weighted_pair() if name == "weighted" else pair(name)
    j_bits, j_cut = jgreedy.greedy_maxcut(jg)
    t_bits, t_cut = greedy.greedy_maxcut(tg, device="cpu")
    np.testing.assert_array_equal(t_bits, j_bits)
    assert t_cut == j_cut
    check_host(t_bits, t_cut, tg)


# --------------------------------------------------------------- random walk
def test_random_walk_matches_jax_with_injected_draws():
    jg, tg = pair("BA_100_ID0")
    b, t, seed = 32, 200, 5
    key = jax.random.PRNGKey(seed)
    key, k_init = jax.random.split(key)
    xs = jax.random.bernoulli(k_init, 0.5, (b, tg.num_nodes))
    nodes = jax.vmap(lambda k: jax.random.randint(k, (b,), 0, tg.num_nodes))(jax.random.split(key, t))
    j_bits, j_cut = jrw.random_walk_maxcut(jg, num_chains=b, num_steps=t, seed=seed)
    draws = random_walk.WalkDraws(torch.tensor(np.asarray(xs)), torch.tensor(np.asarray(nodes)))
    t_bits, t_cut = random_walk.random_walk_maxcut(tg, b, t, device="cpu", draws=draws)
    np.testing.assert_array_equal(t_bits, j_bits)
    assert t_cut == j_cut
    check_host(t_bits, t_cut, tg)


# ------------------------------------------------------------------------ SA
@pytest.mark.parametrize("steps", [200, 2000, 12000])
def test_sa_temperatures_bit_for_bit(steps):
    cfg = jsa.SAConfig(num_steps=steps)
    decay = (cfg.final_temperature / cfg.init_temperature) ** (1.0 / cfg.num_steps)
    j = np.asarray(jax.jit(lambda: cfg.init_temperature * decay ** jnp.arange(cfg.num_steps))())
    t = sa.temperatures(sa.SAConfig(num_steps=steps))
    assert t.dtype == np.float32
    np.testing.assert_array_equal(t.view(np.int32), j.view(np.int32))


def sa_draws(cfg, n):
    key = jax.random.PRNGKey(cfg.seed)
    key, k_init = jax.random.split(key)
    xs = jax.random.bernoulli(k_init, 0.5, (cfg.num_chains, n))

    def one(k):
        k1, k2 = jax.random.split(k)
        return jax.random.randint(k1, (cfg.num_chains,), 0, n), jax.random.uniform(k2, (cfg.num_chains,))

    nodes, u = jax.vmap(one)(jax.random.split(key, cfg.num_steps))
    return sa.AnnealDraws(*(torch.tensor(np.asarray(a)) for a in (xs, nodes, u)))


@pytest.mark.parametrize("name", ["BA_100_ID3", "weighted"])
def test_sa_matches_jax_with_injected_draws(name):
    jg, tg = weighted_pair() if name == "weighted" else pair(name)
    kw = dict(num_chains=32, num_steps=200, seed=7)
    j_bits, j_cut = jsa.anneal_maxcut(jg, jsa.SAConfig(**kw))
    cfg = sa.SAConfig(**kw)
    t_bits, t_cut = sa.anneal_maxcut(tg, cfg, device="cpu", draws=sa_draws(cfg, tg.num_nodes))
    np.testing.assert_array_equal(t_bits, j_bits)
    assert t_cut == j_cut
    check_host(t_bits, t_cut, tg)


# ------------------------------------------------------------------------ GA
def test_ga_matches_jax_with_injected_masks():
    """3 generations; the sweep is K10's plain loop here (the kernel on the card)."""
    jg, tg = pair("BA_100_ID4")
    kw = dict(population=32, generations=3, seed=2)
    j_bits, j_cut = jga.genetic_maxcut(jg, jga.GAConfig(**kw))
    cfg = genetic.GAConfig(**kw)
    n, pop = tg.num_nodes, cfg.population
    n_elite = max(1, int(pop * cfg.elite_frac))
    key = jax.random.PRNGKey(cfg.seed)
    key, k_init = jax.random.split(key)
    xs0 = JMaxcutEnv(jg, dtype=jnp.float32).random_xs(k_init, pop)
    ranks = jnp.arange(pop, 0, -1).astype(jnp.float32)
    draws = []
    for _ in range(cfg.generations):
        key, k = jax.random.split(key)
        k_sel, k_cross, k_mut = jax.random.split(k, 3)
        parents = jax.random.choice(k_sel, pop, shape=(2, pop - n_elite), p=ranks / ranks.sum())
        cross = jax.random.bernoulli(k_cross, 0.5, (pop - n_elite, n))
        mut = jax.random.bernoulli(k_mut, cfg.mutation_rate, (pop - n_elite, n))
        draws.append(genetic.GenerationDraws(*(torch.tensor(np.asarray(a)) for a in (parents, cross, mut))))
    t_bits, t_cut = genetic.genetic_maxcut(tg, cfg, device="cpu", xs0=torch.tensor(np.asarray(xs0)), draws=draws)
    np.testing.assert_array_equal(t_bits, j_bits)
    assert t_cut == j_cut
    check_host(t_bits, t_cut, tg)
    # the port's own draws: a valid run of the same budget
    bits, cut = genetic.genetic_maxcut(tg, cfg, device="cpu")
    check_host(bits, cut, tg)


# ----------------------------------------------------------------------- BLS
def bls_draws(cfg, n):
    """JAX's warm-start bits and per-round draws of `solve_maxcut_bls`."""
    key = jax.random.PRNGKey(cfg.seed)
    k_init, key = jax.random.split(key)
    b = cfg.num_chains
    phi_max = max(cfg.phi_min + 1, int(cfg.phi_max_ratio * n))
    phi_desc = max(cfg.phi_min + 1, min(cfg.desc_tenure, n // 10))

    def one(kk):
        k_mode, k_rand, k_td, k_tp = jax.random.split(kk, 4)
        return (jax.random.uniform(k_mode, (b,)), jax.random.randint(k_rand, (b,), 0, n),
                jax.random.randint(k_td, (b,), cfg.phi_min, phi_desc + 1),
                jax.random.randint(k_tp, (b,), cfg.phi_min, phi_max + 1))

    rounds = [jax.vmap(one)(jax.random.split(k, cfg.steps_per_round))
              for k in jax.random.split(key, cfg.num_rounds)]
    return k_init, [bls.BLSRoundDraws(*(torch.tensor(np.asarray(a)) for a in r)) for r in rounds]


@pytest.mark.parametrize("packed", [False, True], ids=["f32", "packed"])
def test_bls_matches_jax_with_injected_draws(packed, monkeypatch):
    """2 rounds of 64 steps; T = 16 so that stagnation bursts (directed and
    random perturbations) occur within them. With `packed_sweep` the warm
    start runs JAX's Pallas 1-flip kernel in interpret mode and the port's
    K5 plain version."""
    monkeypatch.setattr(jbls, "MaxcutEnv", functools.partial(JMaxcutEnv, packed_interpret=True))
    jg, tg = pair("BA_100_ID5")
    kw = dict(num_chains=16, num_rounds=2, steps_per_round=64, t_stag=16, seed=3, packed_sweep=packed)
    hist = []
    j_bits, j_cut, j_hist = jbls.solve_maxcut_bls(jg, jbls.BLSConfig(**kw))
    cfg = bls.BLSConfig(**kw)
    k_init, draws = bls_draws(cfg, tg.num_nodes)
    xs0 = JMaxcutEnv(jg).random_xs(k_init, cfg.num_chains)
    t_bits, t_cut, t_hist = bls.solve_maxcut_bls(tg, cfg, record=lambda i, v: hist.append((i, v)), device="cpu",
                                                 xs0=torch.tensor(np.asarray(xs0)), draws=draws)
    np.testing.assert_array_equal(t_bits, j_bits)
    assert t_cut == j_cut and t_hist == j_hist and hist == list(enumerate(j_hist))
    check_host(t_bits, t_cut, tg)


def test_masked_argmax_of_all_minus_inf_is_zero():
    """BLS's tabu move on a chain with no admissible node: both packages
    take node 0, as the first of equal maxima."""
    g = np.array([[3.0, -1.0, 7.0], [1.0, 2.0, 0.5]], np.float32)
    adm = np.array([[False, False, False], [False, True, True]])
    j = np.asarray(jnp.argmax(jnp.where(adm, g, -jnp.inf), axis=1))
    t = torch.argmax(torch.where(torch.from_numpy(adm), torch.from_numpy(g), float("-inf")), dim=1).numpy()
    np.testing.assert_array_equal(t, j)
    assert list(t) == [0, 1]


def test_bls_time_budget_stops_the_rounds():
    tg = graph_from_name("BA_100_ID0")
    bits, cut, hist = bls.solve_maxcut_bls(tg, bls.BLSConfig(num_chains=8, num_rounds=1000, steps_per_round=8),
                                           time_budget=0.0, device="cpu")
    assert len(hist) == 1 and cut == hist[0]
    check_host(bits, cut, tg)


# ----------------------------------------------------------------------- SDP
def jax_sdp_v(jg, cfg, v0):
    """JAX's projected ascent, as `rlsolver_tpu.classical.sdp.sdp_maxcut`
    runs it, from the unit rows v0."""
    adj = jnp.asarray(jg.adjacency_dense(), jnp.float32)
    step = cfg.lr * 8.0 / (float(np.abs(np.asarray(jg.weighted_degrees())).max()) or 1.0)

    def body(v, _):
        grad = -jnp.matmul(adj, v, preferred_element_type=jnp.float32)
        grad = grad - jnp.sum(grad * v, axis=1, keepdims=True) * v
        v = v + step * grad
        return v / jnp.linalg.norm(v, axis=1, keepdims=True), None

    return np.asarray(jax.jit(lambda v: jax.lax.scan(body, v, None, length=cfg.num_iters)[0])(v0))


@pytest.mark.parametrize("name", ["BA_100_ID6", "weighted", "BA_1000_ID0"])
def test_sdp_matches_jax(name):
    jg, tg = weighted_pair() if name == "weighted" else pair(name)
    cfg = jsdp.SDPConfig(seed=4)
    n = tg.num_nodes
    k = sdp.sdp_rank(n, sdp.SDPConfig())
    key = jax.random.PRNGKey(cfg.seed)
    key, k_init, k_round = jax.random.split(key, 3)
    v0 = jax.random.normal(k_init, (n, k))
    h = jax.random.normal(k_round, (cfg.num_roundings, k))
    j_v = jax_sdp_v(jg, cfg, v0 / jnp.linalg.norm(v0, axis=1, keepdims=True))
    t_v0 = torch.tensor(np.asarray(v0))
    t_v0 = t_v0 / torch.linalg.norm(t_v0, dim=1, keepdim=True)
    step = cfg.lr * 8.0 / (float(np.abs(tg.weighted_degrees()).max()) or 1.0)
    t_v = sdp.optimize(torch.from_numpy(tg.adjacency_dense()), t_v0, step, cfg.num_iters).numpy()
    np.testing.assert_allclose(t_v, j_v, atol=1e-4, rtol=0)
    j_bits, j_cut = jsdp.sdp_maxcut(jg, cfg)
    t_bits, t_cut = sdp.sdp_maxcut(tg, sdp.SDPConfig(seed=4), device="cpu", v0=torch.tensor(np.asarray(v0)),
                                   h=torch.tensor(np.asarray(h)))
    assert t_cut == j_cut
    check_host(t_bits, t_cut, tg)


# ---------------------------------------------------------- own draws, CLI
@pytest.mark.parametrize("alg", ["greedy", "random_walk", "sa", "ga", "sdp", "bls"])
def test_cli_runs_each_baseline_on_cpu(alg, capsys, monkeypatch):
    """`--alg` on BA_100_ID0 with `--device cpu` (the CLI re-scores the cut
    on the host); the iterative solvers at a smaller depth than their
    defaults, which the card runs."""
    small = {"sa": (sa, "SAConfig", dict(num_steps=300)), "ga": (genetic, "GAConfig", dict(generations=4)),
             "bls": (bls, "BLSConfig", dict(num_rounds=2, steps_per_round=64)),
             "sdp": (sdp, "SDPConfig", dict(num_iters=100))}
    if alg in small:
        mod, name, kw = small[alg]
        monkeypatch.setattr(mod, name, functools.partial(getattr(mod, name), **kw))
    if alg == "random_walk":
        monkeypatch.setattr(random_walk, "random_walk_maxcut",
                            functools.partial(random_walk.random_walk_maxcut, num_steps=300))
    from rlsolver_tpu_torch.run import main as cli_main

    assert cli_main(["--alg", alg, "--graphs", "BA_100_ID0", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith(f"{alg} BA_100_ID0: obj=") and float(out.split("obj=")[1].split()[0]) >= 220
