"""The port's problem envs (QUBO, MaxSAT, Cheeger, MIMO, subset-sum) against
the JAX package's: objectives and sweeps bit for bit on integer data (a
unit-graph and an integer QUBO, integer clause weights and amounts, a MIMO
channel on multiples of 1/64, whose f32 sums are exact), energies at rtol
1e-5 on a Gaussian MIMO channel; the file readers' round trips."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlsolver_tpu.core.generate import graph_from_name as j_graph_from_name
from rlsolver_tpu.problems import cheeger as jc, maxsat as jms, mimo as jmi, qubo as jq, subset_sum as jss
from rlsolver_tpu_torch.core.generate import graph_from_name
from rlsolver_tpu_torch.problems import cheeger as tc, maxsat as tms, mimo as tmi, qubo as tq, subset_sum as tss

torch.set_num_threads(1)


def t(a):
    return torch.from_numpy(np.array(a))


def eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# --------------------------------------------------------------------- qubo
def qubo_cases():
    g = j_graph_from_name("BA_30_ID2")
    yield "maxcut_BA_30", jq.maxcut_to_qubo(g.adjacency_dense())
    yield "integer", np.random.default_rng(5).integers(-4, 5, size=(25, 25)).astype(np.float64)


@pytest.mark.parametrize("name,q", list(qubo_cases()), ids=lambda v: v if isinstance(v, str) else "")
def test_qubo_matches_jax(name, q):
    jenv, tenv = jq.QuboEnv(q), tq.QuboEnv(q, "cpu")
    n = q.shape[0]
    eq(tenv.q.numpy(), jenv.q)
    rng = np.random.default_rng(n)
    bits = rng.random((12, n)) < 0.5
    spins = np.where(bits, 1.0, -1.0).astype(np.float32)
    eq(tenv.obj_pm(t(spins)).numpy(), jenv.obj_pm(jnp.asarray(spins)))
    eq(tenv.obj_bin(t(bits)).numpy(), jenv.obj_bin(jnp.asarray(bits)))
    for sweeps in (1, 2):
        eq(tenv.sweep_pm(t(spins), sweeps).numpy(), jenv.sweep_pm(jnp.asarray(spins), sweeps))
        eq(tenv.sweep_bin(t(bits), sweeps).numpy(), jenv.sweep_bin(jnp.asarray(bits), sweeps))


def test_qubo_maxcut_identity_and_read_roundtrip(tmp_path):
    g = graph_from_name("BA_16_ID0")
    env = tq.QuboEnv(tq.maxcut_to_qubo(g.adjacency_dense()), "cpu")
    bits = np.random.default_rng(5).random((4, 16)) < 0.5
    e = env.obj_pm(t(np.where(bits, 1.0, -1.0).astype(np.float32))).numpy()
    cut = [sum(w for (a, b), w in zip(g.edges, g.weights) if x[a] != x[b]) for x in bits]
    np.testing.assert_array_equal(e, 4.0 * np.asarray(cut) - 2.0 * g.total_weight)
    q = np.arange(9, dtype=float).reshape(3, 3) - 2.5
    p = tmp_path / "q.txt"
    p.write_text("\n".join(", ".join(str(x) for x in row) for row in q) + "\n\n")
    eq(tq.read_qubo(str(p)), jq.read_qubo(str(p)))
    eq(tq.read_qubo(str(p)), q)
    (tmp_path / "r.txt").write_text("1 2\n3 4\n5 6\n")
    with pytest.raises(ValueError, match="square"):
        tq.read_qubo(str(tmp_path / "r.txt"))


# ------------------------------------------------------------------- maxsat
@pytest.fixture(scope="module")
def sat_instance():
    rng = np.random.RandomState(0)
    clauses = []
    for _ in range(60):
        k = rng.randint(1, 5)
        vs = rng.choice(14, size=k, replace=False) + 1
        clauses.append(list(vs * rng.choice([-1, 1], size=k)))
    clauses.append([3, -3])  # a variable twice in one clause
    weights = rng.randint(1, 6, size=len(clauses)).astype(float)
    return 14, clauses, weights


def test_maxsat_matches_jax(sat_instance):
    n, clauses, weights = sat_instance
    jenv = jms.MaxSatEnv(jms.MaxSatInstance.from_clauses(n, clauses, weights))
    tenv = tms.MaxSatEnv(tms.MaxSatInstance.from_clauses(n, clauses, weights), "cpu")
    eq(tenv.var_clauses.numpy(), jenv.var_clauses)
    eq(np.asarray(tenv.sweep_order), jenv.sweep_order)
    bits = np.random.default_rng(1).random((16, n)) < 0.5
    eq(tenv.obj(t(bits)).numpy(), jenv.obj(jnp.asarray(bits)))
    key = jax.random.PRNGKey(2)
    for sweeps, noise in ((1, 0.5), (2, 0.5), (2, 0.0)):
        expect = jenv.sweep(key, jnp.asarray(bits), num_sweeps=sweeps, noise=noise)
        keys = jax.random.split(key, sweeps * n)
        u = jax.vmap(lambda k: jax.random.uniform(k, (16,), minval=-noise, maxval=noise))(keys)
        eq(tenv.sweep(None, t(bits), sweeps, noise, u=t(u)).numpy(), expect)


def test_maxsat_cnf_and_wcnf_roundtrip(tmp_path, sat_instance):
    n, clauses, weights = sat_instance
    lines = [f"c a comment", f"p cnf {n} {len(clauses)}"] + [" ".join(map(str, c)) + " 0" for c in clauses]
    (tmp_path / "t.cnf").write_text("\n".join(lines) + "\n")
    wlines = [f"p wcnf {n} {len(clauses)} 99"] + [f"{int(w)} " + " ".join(map(str, c)) + " 0"
                                                 for w, c in zip(weights, clauses)]
    (tmp_path / "t.wcnf").write_text("\n".join(wlines) + "\n")
    for name in ("t.cnf", "t.wcnf"):
        path = str(tmp_path / name)
        ji, ti = jms.MaxSatInstance.from_cnf(path), tms.MaxSatInstance.from_cnf(path)
        for f in ("clause_vars", "clause_signs", "weights"):
            eq(getattr(ti, f), getattr(ji, f))
        assert (ti.num_vars, ti.hard_weight) == (ji.num_vars, ji.hard_weight)
    assert tms.MaxSatInstance.from_cnf(str(tmp_path / "t.wcnf")).hard_weight == 99.0
    with pytest.raises(ValueError, match="literal 0"):
        tms.MaxSatInstance.from_clauses(3, [[1, 0, 2]])


# ------------------------------------------------------------------ cheeger
def test_wcnf_line_without_literals_adds_no_clause(tmp_path):
    """A weighted line with no literal ("7 0") adds neither a clause nor a
    weight, so each clause keeps its own weight. Port only: the JAX parser
    (rlsolver_tpu/problems/maxsat.py:86-93) appends the weight without the
    clause and returns [5, 7, 9] for these two clauses."""
    path = tmp_path / "t.wcnf"
    path.write_text("p wcnf 3 3 100\n5 1 2 0\n7 0\n9 -1 3 0\n")
    inst = tms.MaxSatInstance.from_cnf(str(path))
    assert inst.num_clauses == 2 and inst.num_vars == 3 and inst.hard_weight == 100.0
    np.testing.assert_array_equal(np.asarray(inst.weights), [5.0, 9.0])
    assert (np.abs(inst.clause_signs).sum(axis=1) == [2, 2]).all()


@pytest.mark.parametrize("normalized", [False, True])
def test_cheeger_matches_jax(normalized):
    name = "BA_40_ID1"
    jenv = jc.CheegerEnv(j_graph_from_name(name), normalized=normalized)
    tenv = tc.CheegerEnv(graph_from_name(name), normalized=normalized, device="cpu")
    rng = np.random.default_rng(3)
    bits = rng.random((20, 40)) < 0.3
    bits[0], bits[1] = False, True  # one side empty: inf
    got, expect = tenv.obj(t(bits)).numpy(), np.asarray(jenv.obj(jnp.asarray(bits)))
    eq(got, expect)
    assert np.isinf(got[:2]).all() and np.isfinite(got[2:]).all()
    eq(tenv.seed_bits(50).numpy(), jenv.seed_bits(50))
    for start in (bits[2:], np.asarray(jenv.seed_bits(20))):
        for sweeps in (1, 2):
            eq(tenv.sweep(t(start), sweeps).numpy(), jenv.sweep(jnp.asarray(start), sweeps))
    # a chain with one side empty never moves (its ratio is not a number)
    eq(tenv.sweep(t(bits[:2]), 1).numpy(), bits[:2])


# --------------------------------------------------------------------- mimo
def quantized_instance(k=5, seed=9):
    """A real channel and received vector on multiples of 1/64."""
    rng = np.random.RandomState(seed)
    h = np.round(rng.randn(2 * k, 2 * k) * 16) / 64
    x = rng.choice([-1.0, 1.0], size=2 * k)
    y = h @ x + np.round(rng.randn(2 * k) * 8) / 64
    return h, y, x


def test_mimo_quantized_matches_jax_bit_for_bit():
    h, y, x = quantized_instance()
    ji, ti = jmi.MimoInstance(h, y, x, 10.0, 0.5), tmi.MimoInstance(h, y, x, 10.0, 0.5)
    jenv, tenv = jmi.MimoEnv(ji), tmi.MimoEnv(ti, "cpu")
    for f in ("sigma", "sigma_offdiag", "d", "h", "y"):
        eq(getattr(tenv, f).numpy(), getattr(jenv, f))
    assert tenv.const == jenv.const
    spins = np.where(np.random.default_rng(4).random((32, 10)) < 0.5, 1.0, -1.0).astype(np.float32)
    eq(tenv.obj(t(spins)).numpy(), jenv.obj(jnp.asarray(spins)))
    for sweeps in (1, 3):
        out = tenv.sweep(t(spins), sweeps)
        eq(out.numpy(), jenv.sweep(jnp.asarray(spins), sweeps))
        eq(tenv.bit_error_rate(out).numpy(), jenv.bit_error_rate(jnp.asarray(out.numpy())))
    eq(tmi.detect_ml_brute(ti), jmi.detect_ml_brute(ji))


def test_mimo_gaussian_matches_jax():
    ji, ti = jmi.generate_mimo(k=6, snr_db=8.0, seed=3), tmi.generate_mimo(k=6, snr_db=8.0, seed=3)
    for f in ("h", "y", "x_true"):
        eq(getattr(ti, f), getattr(ji, f))
    assert ti.sigma2 == ji.sigma2
    jenv, tenv = jmi.MimoEnv(ji), tmi.MimoEnv(ti, "cpu")
    spins = np.where(np.random.default_rng(6).random((64, 12)) < 0.5, 1.0, -1.0).astype(np.float32)
    np.testing.assert_allclose(tenv.obj(t(spins)).numpy(), np.asarray(jenv.obj(jnp.asarray(spins))), rtol=1e-5)
    out = tenv.sweep(t(spins), 2)
    np.testing.assert_allclose(tenv.obj(out).numpy(), np.asarray(jenv.obj(jenv.sweep(jnp.asarray(spins), 2))),
                               rtol=1e-5)
    for fn in ("detect_zf", "detect_mmse", "detect_ml_brute"):
        eq(getattr(tmi, fn)(ti), getattr(jmi, fn)(ji))


# --------------------------------------------------------------- subset-sum
@pytest.mark.parametrize("with_tags", [False, True])
def test_subset_sum_matches_jax(with_tags):
    rng = np.random.RandomState(7)
    amounts = rng.randint(-500, 500, 40)
    tags = rng.randint(0, 4, 40) if with_tags else None
    jenv, tenv = jss.SubsetSumEnv(amounts, tags=tags), tss.SubsetSumEnv(amounts, tags=tags, device="cpu")
    bits = rng.rand(24, 40) < 0.5
    eq(tenv.components(t(bits)).numpy(), jenv.components(jnp.asarray(bits)))
    eq(tenv.obj(t(bits)).numpy(), jenv.obj(jnp.asarray(bits)))
    for sweeps in (1, 2):
        eq(tenv.sweep(t(bits), sweeps).numpy(), jenv.sweep(jnp.asarray(bits), sweeps))


def test_read_amounts_csv_roundtrip(tmp_path):
    p = tmp_path / "a.csv"
    p.write_text("id,amount,tag\n0,1.23,JF\n1,-4.56,JW\n2,0.10,JF\n3,1e2,JW\n")
    eq(tss.read_amounts_csv(str(p)), jss.read_amounts_csv(str(p)))
    eq(tss.read_amounts_csv(str(p)), [123, -456, 10, 10000])


def _entry_points():
    """Each new entry point, called with a device; `cuda` when it is None."""
    from rlsolver_tpu_torch.algos import mcpg_batch as tb, mcpg_multi as tmm
    from rlsolver_tpu_torch.algos.mcpg import MCPGConfig
    from rlsolver_tpu_torch.ops.sweeps import EdgeSweepData

    g = graph_from_name("BA_20_ID0")
    inst = tms.MaxSatInstance.from_clauses(3, [[1, -2], [2, 3]])
    return {
        "QuboEnv": lambda dev: tq.QuboEnv(np.eye(3), dev).q,
        "MaxSatEnv": lambda dev: tms.MaxSatEnv(inst, dev).cv,
        "CheegerEnv": lambda dev: tc.CheegerEnv(g, device=dev).nbrs,
        "MimoEnv": lambda dev: tmi.MimoEnv(tmi.generate_mimo(2, seed=1), dev).h,
        "SubsetSumEnv": lambda dev: tss.SubsetSumEnv(np.arange(4), device=dev).amounts,
        "EdgeSweepData.build": lambda dev: EdgeSweepData.build(g, dev).nbrs,
        "StackedGraphs.build": lambda dev: tb.StackedGraphs.build([g], dev).adj,
        "maxcut_edge_problem": lambda dev: tmm.maxcut_edge_problem(g, device=dev).score(
            torch.zeros(1, 20, dtype=torch.bool)),
        "solve_mcpg": lambda dev: torch.from_numpy(tmm.solve_mcpg(
            tmm.qubo_problem(tq.QuboEnv(np.eye(3), "cpu")), tmm.MultiMCPGConfig(num_rounds=1), dev).best_bits),
        "solve_maxcut_mcpg_batched": lambda dev: torch.from_numpy(tb.solve_maxcut_mcpg_batched(
            [g], MCPGConfig(total_mcmc_num=2, repeat_times=2, num_ls=1, max_epoch_num=1, reset_epoch_num=8),
            device=dev)[0]),
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_points_need_a_card_unless_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    fn = _entry_points()[name]
    assert fn("cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn(None)
