"""Set cover, knapsack, number partitioning, the QUBO formulations and the
HiGHS MILP on the port, against the JAX package on the CPU.

Host solvers (greedy set cover, knapsack's greedy, FPTAS and branch and
bound, Karmarkar-Karp) and the device DP and brute force must give equal
solutions and values (integer weights and profits, sums below 2^24, so f32
is exact). The device annealers (`anneal_set_cover`, `anneal_bitvector`,
`sa_knapsack`, `anneal_partition`) take JAX's draws, made here with JAX's
own key splits, and must give equal bits and values: bit for bit. Their
temperature schedules follow XLA's compiled arithmetic (set cover's
division by the constant T is a product with f32(1 / T) fused with the
subtraction from 1; the geometric schedules are numpy float32 powers or
numpy float64 values cast to f32) and are held equal to JAX's first.
MILP's objectives must equal JAX's where both prove the optimum (bound ==
objective)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from rlsolver_tpu.classical import greedy as jgreedy
from rlsolver_tpu.classical import knapsack as jkp
from rlsolver_tpu.classical import number_partitioning as jnp_part
from rlsolver_tpu.classical import simulated_annealing as jsa
from rlsolver_tpu.core import io as jio
from rlsolver_tpu.core.generate import generate_knapsack as j_generate_knapsack
from rlsolver_tpu.core.generate import graph_from_name as j_graph_from_name
from rlsolver_tpu.solvers import formulations as jform
from rlsolver_tpu.solvers import milp as jmilp
from rlsolver_tpu_torch.classical import greedy, knapsack as kp, number_partitioning as part
from rlsolver_tpu_torch.classical import simulated_annealing as sa
from rlsolver_tpu_torch.core import io
from rlsolver_tpu_torch.core.generate import generate_knapsack, graph_from_name
from rlsolver_tpu_torch.problems import objectives as obj
from rlsolver_tpu_torch.run import main as cli_main
from rlsolver_tpu_torch.solvers import formulations as form
from rlsolver_tpu_torch.solvers import milp

torch.set_num_threads(1)


def set_cover_pair(num_items=40, num_sets=60, seed=4):
    """A random instance, every item covered: sets of 2-6 items, and each
    item's own set added where no set covers it."""
    rng = np.random.default_rng(seed)
    subsets = [tuple(sorted(set(rng.integers(1, num_items + 1, rng.integers(2, 7)).tolist())))
               for _ in range(num_sets)]
    covered = {i for s in subsets for i in s}
    subsets += [(i,) for i in range(1, num_items + 1) if i not in covered]
    return jio.SetCoverInstance(num_items, tuple(subsets)), io.SetCoverInstance(num_items, tuple(subsets))


def knapsack_pair(n, seed=0):
    j = j_generate_knapsack(n, seed)
    return j, generate_knapsack(n, seed)


def t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------- set cover
@pytest.mark.parametrize("seed", [4, 9])
def test_greedy_set_cover_matches_jax(seed):
    j_inst, t_inst = set_cover_pair(seed=seed)
    (j_bits, j_val), (t_bits, t_val) = jgreedy.greedy_set_cover(j_inst), greedy.greedy_set_cover(t_inst)
    np.testing.assert_array_equal(t_bits, j_bits)
    assert t_val == j_val == obj.obj_set_cover(t_bits.astype(int), t_inst)


@pytest.mark.parametrize("steps", [37, 120, 2000])
def test_set_cover_temperatures_follow_xla(steps):
    cfg = sa.SAConfig(num_steps=steps, init_temperature=4.0)
    # JAX's expression as its jitted annealer compiles it (an input keeps
    # XLA from folding it to a constant)
    want = jax.jit(lambda z: cfg.init_temperature * (1.0 - (jnp.arange(steps) + z) / steps) + 1e-6)(jnp.float32(1))
    np.testing.assert_array_equal(sa.set_cover_temperatures(cfg), np.asarray(want))


def test_anneal_set_cover_matches_jax_with_injected_draws():
    j_inst, t_inst = set_cover_pair()
    cfg = sa.SAConfig(num_chains=16, num_steps=120, seed=2)
    j_bits, j_val = jsa.anneal_set_cover(j_inst, jsa.SAConfig(num_chains=16, num_steps=120, seed=2))
    b, s = cfg.num_chains, t_inst.num_sets

    def step(k):
        k1, k2, k3, k4 = jax.random.split(k, 4)
        return (jax.random.uniform(k1, (b, s)), jax.random.uniform(k2, (b, s)), jax.random.uniform(k3, (b, 1)),
                jax.random.uniform(k4, (b,)))

    draws = sa.SetCoverDraws(*map(t, jax.vmap(step)(jax.random.split(jax.random.PRNGKey(cfg.seed), cfg.num_steps))))
    t_bits, t_val = sa.anneal_set_cover(t_inst, cfg, device="cpu", draws=draws)
    np.testing.assert_array_equal(t_bits, j_bits)
    assert t_val == j_val == obj.obj_set_cover(t_bits.astype(int), t_inst)
    assert t_val >= greedy.greedy_set_cover(t_inst)[1]
    # the generator's own draws: a cover at least as small as greedy's
    g_bits, g_val = sa.anneal_set_cover(t_inst, cfg, device="cpu")
    assert g_val == obj.obj_set_cover(g_bits.astype(int), t_inst) >= greedy.greedy_set_cover(t_inst)[1]


def test_gumbel_top_breaks_ties_by_lowest_index():
    u = torch.full((2, 6), 0.5)
    mask = torch.tensor([[False] * 6, [False, True, False, False, False, False]])
    np.testing.assert_array_equal(sa._gumbel_top(u, mask, 2).numpy(), [[0, 1], [1, 0]])
    want = jax.lax.top_k(jnp.where(jnp.asarray(mask.numpy()), 0.3665, -jnp.inf), 2)[1]
    np.testing.assert_array_equal(sa._gumbel_top(u, mask, 2).numpy(), np.asarray(want))


def test_anneal_bitvector_matches_jax_with_injected_draws():
    """Penalized MIS (|S| - 2 edges inside S) on BA_100_ID0, from uniform
    bits and from an all-zero start."""
    jg, tg = j_graph_from_name("BA_100_ID0"), graph_from_name("BA_100_ID0")
    adj = tg.adjacency_dense()
    j_adj, t_adj = jnp.asarray(adj), torch.from_numpy(adj)

    def j_obj(xs):
        x = xs.astype(jnp.float32)
        return x.sum(1) - jnp.sum((x @ j_adj) * x, axis=1)

    def t_obj(xs):
        x = xs.to(torch.float32)
        return x.sum(1) - torch.sum((x @ t_adj) * x, dim=1)

    b, steps, n = 16, 300, tg.num_nodes
    for init in (None, np.zeros(n, bool)):
        cfg_j = jsa.SAConfig(num_chains=b, num_steps=steps, init_temperature=2.0, final_temperature=0.05, seed=1)
        j_bits, j_val = jsa.anneal_bitvector(j_obj, n, cfg_j, None if init is None else jnp.asarray(init))
        key, k_init = jax.random.split(jax.random.PRNGKey(cfg_j.seed))
        nodes, u = jax.vmap(lambda k: (jax.random.randint(jax.random.split(k)[0], (b,), 0, n),
                                       jax.random.uniform(jax.random.split(k)[1], (b,))))(jax.random.split(key, steps))
        draws = sa.AnnealDraws(t(jax.random.bernoulli(k_init, 0.5, (b, n))), t(nodes), t(u))
        cfg_t = sa.SAConfig(num_chains=b, num_steps=steps, init_temperature=2.0, final_temperature=0.05, seed=1)
        t_bits, t_val = sa.anneal_bitvector(t_obj, n, cfg_t, init_bits=init, device="cpu", draws=draws)
        np.testing.assert_array_equal(t_bits, j_bits)
        assert t_val == j_val


# ----------------------------------------------------------------- knapsack
@pytest.mark.parametrize("n", [12, 60, 200])
def test_knapsack_solvers_match_jax(n):
    j_inst, t_inst = knapsack_pair(n)
    solvers = [(jkp.greedy_knapsack, kp.greedy_knapsack), (jkp.dp_knapsack, lambda i: kp.dp_knapsack(i, "cpu")),
               (jkp.fptas_knapsack, kp.fptas_knapsack), (jkp.branch_and_bound_knapsack, kp.branch_and_bound_knapsack)]
    if n <= 24:
        solvers.append((jkp.brute_force_knapsack, lambda i: kp.brute_force_knapsack(i, "cpu")))
    values = []
    for jf, tf in solvers:
        (j_bits, j_val), (t_bits, t_val) = jf(j_inst), tf(t_inst)
        np.testing.assert_array_equal(t_bits, j_bits)
        assert t_val == j_val == obj.obj_knapsack(t_bits.astype(int), t_inst)
        values.append(t_val)
    greedy_v, dp_v, fptas_v, bb_v = values[:4]
    assert bb_v == dp_v >= fptas_v >= 0.9 * dp_v and greedy_v <= dp_v
    if n <= 24:
        assert values[4] == dp_v


@pytest.mark.parametrize("eps", [0.1, 0.3])
def test_fptas_matches_jax_on_real_weights(eps):
    """The port's FPTAS updates only the reachable levels, in place: the
    same choices as JAX's whole-row update, on non-integer weights and
    profits too."""
    rng = np.random.default_rng(int(eps * 10))
    w, p = rng.uniform(1, 30, 80).astype(np.float32), rng.uniform(1, 100, 80).astype(np.float32)
    cap = float(w.sum() * 0.3)
    (j_bits, j_val), (t_bits, t_val) = (jkp.fptas_knapsack(jio.KnapsackInstance(0, cap, w, p), eps),
                                        kp.fptas_knapsack(io.KnapsackInstance(0, cap, w, p), eps))
    np.testing.assert_array_equal(t_bits, j_bits)
    assert t_val == j_val


def test_sa_knapsack_matches_jax_with_injected_draws():
    j_inst, t_inst = knapsack_pair(60, seed=3)
    c, steps, seed = 32, 400, 5
    j_bits, j_val = jkp.sa_knapsack(j_inst, jax.random.PRNGKey(seed), num_chains=c, num_steps=steps)
    _, k_run = jax.random.split(jax.random.PRNGKey(seed))

    def step(k):
        k1, k2 = jax.random.split(k)
        return jax.random.randint(k1, (c,), 0, 60), jax.random.uniform(k2, (c,))

    idx, u = jax.vmap(step)(jax.random.split(k_run, steps))
    draws = sa.AnnealDraws(None, t(idx), t(u))
    t_bits, t_val = kp.sa_knapsack(t_inst, num_chains=c, num_steps=steps, device="cpu", draws=draws)
    np.testing.assert_array_equal(t_bits, j_bits)
    assert t_val == j_val == obj.obj_knapsack(t_bits.astype(int), t_inst)
    g_bits, g_val = kp.sa_knapsack(t_inst, seed=0, num_chains=c, num_steps=steps, device="cpu")
    assert 0 < g_val == obj.obj_knapsack(g_bits.astype(int), t_inst) <= kp.dp_knapsack(t_inst, "cpu")[1]


# ------------------------------------------------------ number partitioning
def test_partition_solvers_match_jax():
    rng = np.random.default_rng(8)
    for nums in (rng.integers(1, 1000, 14), rng.integers(1, 100, 200), np.array([4, 5, 6, 7, 8])):
        j_bits, j_val = jnp_part.karmarkar_karp(nums)
        t_bits, t_val = part.karmarkar_karp(nums)
        np.testing.assert_array_equal(t_bits, j_bits)
        assert t_val == j_val == -obj.obj_number_partitioning(t_bits.astype(int), nums)
        if len(nums) <= 24:
            (j_bits, j_val), (t_bits, t_val) = jnp_part.brute_force_partition(nums), part.brute_force_partition(
                nums, "cpu")
            np.testing.assert_array_equal(t_bits, j_bits)
            assert t_val == j_val <= part.karmarkar_karp(nums)[1]


def test_anneal_partition_matches_jax_with_injected_draws():
    nums = np.random.default_rng(2).integers(1, 1000, 150)
    c, steps, seed = 32, 500, 7
    j_bits, j_val = jnp_part.anneal_partition(nums, jax.random.PRNGKey(seed), num_chains=c, num_steps=steps)
    k_init, k_run = jax.random.split(jax.random.PRNGKey(seed))

    def step(k):
        k1, k2 = jax.random.split(k)
        return jax.random.randint(k1, (c,), 0, len(nums)), jax.random.uniform(k2, (c,))

    idx, u = jax.vmap(step)(jax.random.split(k_run, steps))
    draws = sa.AnnealDraws(t(jax.random.bernoulli(k_init, 0.5, (c, len(nums)))), t(idx), t(u))
    t_bits, t_val = part.anneal_partition(nums, num_chains=c, num_steps=steps, device="cpu", draws=draws)
    np.testing.assert_array_equal(t_bits, j_bits)
    assert t_val == j_val
    g_bits, g_val = part.anneal_partition(nums, num_chains=c, num_steps=steps, device="cpu")
    assert g_val == part.partition_difference(nums, g_bits)


# ------------------------------------------------------- QUBO and MILP
def test_qubo_formulations_match_jax():
    jg, tg = j_graph_from_name("BA_20_ID0"), graph_from_name("BA_20_ID0")
    for name in ("qubo_maxcut", "qubo_mis", "qubo_mvc", "qubo_graph_partitioning"):
        (jq, jc), (tq, tc) = getattr(jform, name)(jg), getattr(form, name)(tg)
        np.testing.assert_array_equal(tq, jq)
        assert tc == jc
    nums = np.array([3.0, 1.0, 4.0, 1.0, 5.0])
    (jq, jc), (tq, tc) = jform.qubo_number_partitioning(nums), form.qubo_number_partitioning(nums)
    np.testing.assert_array_equal(tq, jq)
    assert tc == jc
    x = np.random.default_rng(0).integers(0, 2, 20)
    q, c = form.qubo_maxcut(tg)
    assert form.qubo_value(x, q, c) == jform.qubo_value(x, *jform.qubo_maxcut(jg)) == obj.obj_maxcut(x, tg)


@pytest.mark.parametrize("problem", ["maxcut", "mis", "mvc", "graph_partitioning"])
def test_milp_graph_problems_match_jax(problem):
    jg, tg = j_graph_from_name("BA_20_ID0"), graph_from_name("BA_20_ID0")
    j_res = getattr(jmilp, f"solve_{problem}")(jg, time_limit=30.0)
    t_res = getattr(milp, f"solve_{problem}")(tg, time_limit=30.0)
    # both proved optimal: the bound meets the objective (partitioning
    # reports the negated cut beside the bound of the cut it minimized)
    sign = -1.0 if problem == "graph_partitioning" else 1.0
    assert j_res.bound == sign * j_res.obj and t_res.bound == sign * t_res.obj
    assert t_res.obj == j_res.obj
    rescore = {"maxcut": obj.obj_maxcut, "mis": obj.obj_maximum_independent_set,
               "mvc": lambda x, g: -obj.obj_minimum_vertex_cover(x, g),
               "graph_partitioning": obj.obj_graph_partitioning}[problem]
    assert rescore(t_res.solution, tg) == t_res.obj


def test_milp_set_cover_and_knapsack_match_jax():
    j_sc, t_sc = set_cover_pair(num_items=20, num_sets=30)
    j_res, t_res = jmilp.solve_set_cover(j_sc), milp.solve_set_cover(t_sc)
    assert j_res.bound == j_res.obj and t_res.bound == t_res.obj and t_res.obj == j_res.obj
    assert obj.obj_set_cover(t_res.solution, t_sc) == -t_res.obj
    j_kp, t_kp = knapsack_pair(40, seed=1)
    j_res, t_res = jmilp.solve_knapsack(j_kp), milp.solve_knapsack(t_kp)
    assert j_res.bound == j_res.obj and t_res.bound == t_res.obj and t_res.obj == j_res.obj
    assert t_res.obj == kp.dp_knapsack(t_kp, "cpu")[1] == obj.obj_knapsack(t_res.solution, t_kp)


def test_milp_partitioning_stopped_early_scores_its_solution(monkeypatch):
    """An incumbent of a solve cut by its time limit may set an edge's y to 1
    where both ends share a side (the formulation bounds y only from below).
    HiGHS's objective then counts that edge; the reported objective must be
    the re-score of the reported partition, exactly."""
    g = graph_from_name("BA_20_ID0")
    n, m = g.num_nodes, g.num_edges
    x = np.arange(n) % 2
    fake = lambda c, **kw: type("Res", (), {"x": np.concatenate([x, np.ones(m)]), "fun": float(m),
                                            "mip_dual_bound": 0.0, "message": "Time limit reached."})()
    monkeypatch.setattr(milp, "milp", fake)
    res = milp.solve_graph_partitioning(g)
    assert -float(m) < res.obj == obj.obj_graph_partitioning(res.solution, g)
    np.testing.assert_array_equal(res.solution, x)


# ---------------------------------------------------------------------- CLI
@pytest.mark.parametrize("problem,algs", [("set_cover", ["greedy", "milp"]),
                                          ("knapsack", ["greedy", "dp", "branch_and_bound", "fptas", "sa", "milp"])])
def test_cli_instance_problems(problem, algs, tmp_path, capsys):
    data = tmp_path / "data"
    data.mkdir()
    if problem == "set_cover":
        _, inst = set_cover_pair(num_items=20, num_sets=30)
        lines = [f"{inst.num_items} {inst.num_sets}"] + [" ".join(map(str, s)) for s in inst.subsets]
    else:
        inst = generate_knapsack(30, seed=2)
        lines = [f"0 {inst.num_items} {int(inst.capacity)}"] + [
            f"{int(w)} {int(p)}" for w, p in zip(inst.weights, inst.profits)]
    (data / f"{problem}_0.txt").write_text("\n".join(lines) + "\n")
    values = {}
    for alg in algs:
        assert cli_main(["--problem", problem, "--alg", alg, "--data-dir", str(data), "--write", "--device",
                         "cpu"]) == 0
        out = capsys.readouterr().out
        assert out.startswith(f"{alg} {problem}_0.txt: obj=")
        values[alg] = float(out.split("obj=")[1].split()[0])
    assert len(list((tmp_path / "result").iterdir())) == len(algs)
    best = values["milp"]
    assert all(v <= best for v in values.values())
    if problem == "knapsack":
        assert values["dp"] == values["branch_and_bound"] == best


# ------------------------------------------------------------- device rule
ENTRY_POINTS = {
    "dp_knapsack": lambda dev: kp.dp_knapsack(knapsack_pair(8)[1], device=dev)[1],
    "brute_force_knapsack": lambda dev: kp.brute_force_knapsack(knapsack_pair(8)[1], device=dev)[1],
    "sa_knapsack": lambda dev: kp.sa_knapsack(knapsack_pair(8)[1], num_chains=4, num_steps=5, device=dev)[1],
    "anneal_set_cover": lambda dev: sa.anneal_set_cover(set_cover_pair(10, 12)[1], sa.SAConfig(num_chains=4,
                                                                                          num_steps=5), device=dev)[1],
    "anneal_bitvector": lambda dev: sa.anneal_bitvector(lambda x: x.sum(-1), 8, sa.SAConfig(num_chains=4, num_steps=5),
                                                        device=dev)[1],
    "brute_force_partition": lambda dev: part.brute_force_partition([3.0, 1.0, 4.0, 1.0, 5.0], device=dev)[1],
    "anneal_partition": lambda dev: part.anneal_partition([3.0, 1.0, 4.0, 1.0, 5.0], num_chains=4, num_steps=5,
                                                          device=dev)[1],
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_need_a_card_unless_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    assert ENTRY_POINTS[name]("cpu") is not None
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name](None)
