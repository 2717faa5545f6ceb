"""The RL+OR trainers (`solvers/rlor_train.py`), column generation
(`solvers/column_generation.py`), VRPTW (`solvers/vrptw.py`) and the gated
Gurobi/SCIP adapters against the JAX package's: `ScorePolicy` from JAX's
converted parameters (scores within 1e-5, the same `sample` choices from
the same numpy generator, the same `greedy` choices, `imitate` and one
`reinforce` step to parameters within 1e-5); a cut-depth `train_cut_policy`
(3 updates x 2 episodes on `deceptive_knapsack_ilp`) from JAX's initial
parameters: the LP bound after every cut within 1e-6 and the parameters
within 1e-5 (the output bias, whose gradient is zero up to f32 noise that
Adam scales to lr a step, within lr x updates); a cut-depth
`train_branch_policy_rl` (6 updates x 2 episodes) from JAX's initial
parameters: every B&B run's nodes and objective equal, the same update kept
by the validation, its parameters as above; a cut-depth
`train_pricing_policy` (2 updates x 2 episodes) from JAX's initial
parameters: every CG solve's iterations and value equal, the parameters as
above; the pricing knapsack, cutting-stock CG (LP and integer values,
columns) and FFD equal; ESPPRC's routes and reduced costs and
`solve_vrptw` equal; the Solomon reader; each adapter raising ImportError
through `_require()` without its package (the dispatch before it first)."""

import jax
import numpy as np
import pytest
import torch

from rlsolver_tpu.solvers import column_generation as jcg
from rlsolver_tpu.solvers import cutting as jcut
from rlsolver_tpu.solvers import rlor_train as jrl
from rlsolver_tpu.solvers import vrptw as jvr
from rlsolver_tpu_torch import convert
from rlsolver_tpu_torch.core.generate import graph_from_name
from rlsolver_tpu_torch.solvers import column_generation as tcg
from rlsolver_tpu_torch.solvers import cutting as tcut
from rlsolver_tpu_torch.solvers import gurobi, scip
from rlsolver_tpu_torch.solvers import rlor_train as trl
from rlsolver_tpu_torch.solvers import vrptw as tvr

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def ported(jpolicy, **kw):
    tpol = trl.ScorePolicy(device="cpu", **kw)
    tpol.net.load_state_dict(convert.flax_state_dict(jax.tree.map(np.array, jpolicy.params)))
    return tpol


def assert_params(tpol, jpolicy, adam_moves: float = 0.0):
    """Within 1e-5; the output bias, whose gradient under a softmax over
    candidates is zero up to f32 noise that Adam scales to lr a step,
    within `adam_moves` (lr x steps) when given."""
    sd = convert.flax_state_dict(jax.tree.map(np.array, jpolicy.params))
    for k, v in tpol.net.state_dict().items():
        if k == "Dense_2.bias" and adam_moves:
            assert np.abs(v.numpy() - sd[k].numpy()).max() <= adam_moves
            continue
        np.testing.assert_allclose(v.numpy(), sd[k].numpy(), err_msg=k, **TOL)


def candidate_rows(rng, k, f=6):
    return rng.standard_normal((k, f)).astype(np.float32)


def test_score_policy_matches_jax():
    jpol = jrl.ScorePolicy(num_features=6, seed=3, max_candidates=8, hidden=16)
    tpol = ported(jpol, num_features=6, max_candidates=8, hidden=16)
    rng = np.random.default_rng(0)
    for k in (1, 5, 8, 10):
        f = candidate_rows(rng, k)
        np.testing.assert_allclose(tpol.scores(f), jpol.scores(f), **TOL)
        assert tpol.greedy(f) == jpol.greedy(f)
        ra, rb = np.random.default_rng(k), np.random.default_rng(k)
        assert [tpol.sample(f, ra, 0.7) for _ in range(20)] == [jpol.sample(f, rb, 0.7) for _ in range(20)]
    samples = [(candidate_rows(rng, int(k)), int(p)) for k, p in zip(rng.integers(2, 11, 12), rng.integers(0, 9, 12))]
    np.testing.assert_allclose(tpol.imitate(samples, epochs=5), jpol.imitate(samples, epochs=5), **TOL)
    assert_params(tpol, jpol)
    steps = [(candidate_rows(rng, int(k)), int(a), float(g))
             for k, a, g in zip(rng.integers(2, 11, 9), rng.integers(0, 9, 9), rng.standard_normal(9))]
    np.testing.assert_allclose(tpol.reinforce(steps), jpol.reinforce(steps), **TOL)
    assert_params(tpol, jpol)
    assert trl.ScorePolicy(4, device="cpu").reinforce([]) == 0.0


def test_train_cut_policy_follows_jax(monkeypatch):
    """3 updates x 2 episodes from JAX's initial parameters: every cut's LP
    bound within 1e-6, in the same order, and the trained parameters within
    1e-5."""
    traces = {"jax": [], "port": []}
    for name, cls in (("jax", jcut.CuttingPlaneEnv), ("port", tcut.CuttingPlaneEnv)):
        step = cls.step

        def recording(self, cuts, action, _step=step, _trace=traces[name]):
            out = _step(self, cuts, action)
            _trace.append((action, self.bound))
            return out

        monkeypatch.setattr(cls, "step", recording)
    kw = dict(num_updates=3, episodes_per_update=2, rounds=3, instance_fn=jrl.deceptive_knapsack_ilp, seed=0)
    jnet = jrl.train_cut_policy(**kw)
    init = ported(jrl.ScorePolicy(num_features=4, seed=0), num_features=4)
    tnet = trl.train_cut_policy(**dict(kw, instance_fn=trl.deceptive_knapsack_ilp), init_from=init, device="cpu")
    assert len(traces["port"]) == len(traces["jax"]) >= 6
    assert [a for a, _ in traces["port"]] == [a for a, _ in traces["jax"]]
    np.testing.assert_allclose([b for _, b in traces["port"]], [b for _, b in traces["jax"]], rtol=1e-6, atol=1e-6)
    assert_params(tnet, jnet, adam_moves=3 * 3e-3)
    for s in (0, 3):
        jilp, tilp = jrl.deceptive_knapsack_ilp(s), trl.deceptive_knapsack_ilp(s)
        np.testing.assert_array_equal(tilp.a, jilp.a)
        np.testing.assert_array_equal(trl.multi_knapsack_ilp(s).a, jrl.multi_knapsack_ilp(s).a)


def test_train_branch_policy_rl_follows_jax(monkeypatch, capsys):
    """A cut-depth `train_branch_policy_rl` (6 updates x 2 episodes on set
    cover 20 x 40) from JAX's converted initial parameters, the same numpy
    generator drawing the episodes and the samples: every B&B run (episodes
    and greedy validations, in order) expands the same nodes to the same
    objective; the validation keeps the same update (here the last, whose
    parameters have moved), printed alike; the kept parameters lie within
    1e-5 (the output bias within lr x updates, as above)."""
    runs = {"jax": [], "port": []}
    for name, mod in (("jax", jrl), ("port", trl)):
        bnb = mod.branch_and_bound

        def recording(*args, _bnb=bnb, _runs=runs[name], **kw):
            stats = _bnb(*args, **kw)
            _runs.append((stats.num_nodes, stats.objective))
            return stats

        monkeypatch.setattr(mod, "branch_and_bound", recording)
    kw = dict(num_updates=6, episodes_per_update=2, max_nodes=150, lr=5e-4, temperature=0.5, seed=0, verbose=True)
    jinit = jrl.ScorePolicy(num_features=6, seed=2, max_candidates=8, hidden=64)
    jnet = jrl.train_branch_policy_rl([jrl.generate_set_cover(20, 40, seed=s) for s in (0, 1)], init_from=jinit,
                                      validation=[jrl.generate_set_cover(20, 40, seed=s) for s in (30, 31)], **kw)
    jlog = capsys.readouterr().out
    tnet = trl.train_branch_policy_rl([trl.generate_set_cover(20, 40, seed=s) for s in (0, 1)],
                                      init_from=ported(jinit, num_features=6, max_candidates=8, hidden=64),
                                      validation=[trl.generate_set_cover(20, 40, seed=s) for s in (30, 31)],
                                      device="cpu", **kw)
    tlog = capsys.readouterr().out
    assert len(runs["port"]) == len(runs["jax"]) == 6 * 2 + 2 * 2
    assert [n for n, _ in runs["port"]] == [n for n, _ in runs["jax"]]
    np.testing.assert_allclose([o for _, o in runs["port"]], [o for _, o in runs["jax"]], rtol=1e-9)
    greedy = [[ln.split("greedy geomean ")[1].split()[0] for ln in log.splitlines()] for log in (jlog, tlog)]
    assert greedy[0] == greedy[1] and float(greedy[0][-1]) < float(greedy[0][0])  # the last update is kept
    moved = convert.flax_state_dict(jax.tree.map(np.array, jinit.params))
    assert max(float((v - moved[k]).abs().max()) for k, v in tnet.net.state_dict().items()) > 1e-3
    assert_params(tnet, jnet, adam_moves=6 * 5e-4)


def test_train_pricing_policy_follows_jax(monkeypatch, capsys):
    """A cut-depth `train_pricing_policy` (2 updates x 2 episodes) from
    JAX's converted initial parameters: every column-generation solve (the
    imitation's, the episodes' and the greedy validations', in order) takes
    the same pricing iterations to the same integer value, the validations
    print alike, and the kept parameters lie within 1e-5 (the output bias
    within lr x its Adam steps, as above)."""
    runs = {"jax": [], "port": []}
    for name, mod in (("jax", jrl), ("port", trl)):
        solve = mod.solve_cutting_stock

        def recording(*args, _solve=solve, _runs=runs[name], **kw):
            res = _solve(*args, **kw)
            _runs.append((res.num_iterations, res.int_value))
            return res

        monkeypatch.setattr(mod, "solve_cutting_stock", recording)
    kw = dict(num_updates=2, episodes_per_update=2, seed=0, verbose=True)
    jinit = jrl.ScorePolicy(num_features=4, seed=0, max_candidates=4, lr=1e-3)
    jnet = jrl.train_pricing_policy(**kw)
    jlog = capsys.readouterr().out
    tnet = trl.train_pricing_policy(init_from=ported(jinit, num_features=4, max_candidates=4, lr=1e-3),
                                    device="cpu", **kw)
    tlog = capsys.readouterr().out
    assert len(runs["port"]) == len(runs["jax"]) == 8 + 6 + 2 * (2 + 6)
    assert runs["port"] == runs["jax"]
    greedy = [[ln.split("greedy-val ")[1].split()[0] for ln in log.splitlines()] for log in (jlog, tlog)]
    assert greedy[0] == greedy[1] and len(greedy[0]) == 2
    assert_params(tnet, jnet, adam_moves=(200 + 2) * 1e-3)


def test_cutting_stock_matches_jax():
    sizes, duals, max_per = np.asarray([30.0, 40.0, 50.0]), np.asarray([0.4, 0.55, 0.9]), np.asarray([3, 2, 2])
    ta, tv = tcg.bounded_knapsack_pricing(sizes, 100.0, duals, max_per)
    ja, jv = jcg.bounded_knapsack_pricing(sizes, 100.0, duals, max_per)
    np.testing.assert_array_equal(ta, ja)
    assert tv == jv == pytest.approx(1.8)
    for seed, cands in ((3, 1), (4, 3)):
        tinst, jinst = tcg.CuttingStockInstance.random(8, seed=seed), jcg.CuttingStockInstance.random(8, seed=seed)
        np.testing.assert_array_equal(tinst.sizes, jinst.sizes)
        tr, jr = (m.solve_cutting_stock(i, num_candidates=cands) for m, i in ((tcg, tinst), (jcg, jinst)))
        assert (tr.lp_value, tr.int_value, tr.num_iterations) == (jr.lp_value, jr.int_value, jr.num_iterations)
        np.testing.assert_array_equal(tr.columns, jr.columns)
        np.testing.assert_array_equal(tr.int_counts, jr.int_counts)
        assert tr.history == jr.history
        assert tcg.first_fit_decreasing(tinst) == jcg.first_fit_decreasing(jinst)
    tinst = tcg.CuttingStockInstance.random(10, seed=101)
    feats = []
    trl_iters = tcg.solve_cutting_stock(
        tinst, num_candidates=4,
        policy=lambda d, c: feats.append(trl._pricing_features(tinst, d, c)) or tcg.best_reduced_cost(d, c))
    jfeats = []
    jinst = jcg.CuttingStockInstance.random(10, seed=101)
    jcg.solve_cutting_stock(
        jinst, num_candidates=4,
        policy=lambda d, c: jfeats.append(jrl._pricing_features(jinst, d, c)) or jcg.best_reduced_cost(d, c))
    assert trl_iters.num_iterations == len(feats) + 1 and len(feats) == len(jfeats)
    for a, b in zip(feats, jfeats):
        np.testing.assert_array_equal(a, b)


def test_vrptw_matches_jax(tmp_path):
    tinst, jinst = tvr.VrptwInstance.random(8, seed=1), jvr.VrptwInstance.random(8, seed=1)
    duals = np.concatenate([[0.0], np.full(8, 30.0)])
    troutes, jroutes = tvr.esspprc_pricing(tinst, duals), jvr.esspprc_pricing(jinst, duals)
    assert troutes == jroutes and len(troutes) > 5
    for r, _ in troutes[:5]:
        assert tvr.route_feasible(tinst, r) and tvr.route_cost(tinst, r) == jvr.route_cost(jinst, r)
    tr, jr = tvr.solve_vrptw(tvr.VrptwInstance.random(8, seed=2), max_iters=20), \
        jvr.solve_vrptw(jvr.VrptwInstance.random(8, seed=2), max_iters=20)
    assert (tr.routes, tr.selected, tr.history) == (jr.routes, jr.selected, jr.history)
    assert (tr.lp_value, tr.int_value, tr.num_iterations) == (jr.lp_value, jr.int_value, jr.num_iterations)
    p = tmp_path / "solomon.txt"
    p.write_text("TEST1\n\nVEHICLE\nNUMBER     CAPACITY\n  25         200\n\nCUSTOMER\n"
                 "CUST NO.  XCOORD.   YCOORD.   DEMAND    READY TIME  DUE DATE   SERVICE TIME\n\n"
                 "    0      40        50          0          0       1236          0\n"
                 "    1      45        68         10          0       1127         90\n"
                 "    2      45        70         30          0       1125         90\n")
    ts, js = tvr.VrptwInstance.from_solomon(str(p)), jvr.VrptwInstance.from_solomon(str(p))
    assert ts.num_customers == js.num_customers == 2 and ts.capacity == js.capacity == 200.0
    for f in ("coords", "demand", "tw_start", "tw_end", "service"):
        np.testing.assert_array_equal(getattr(ts, f), getattr(js, f))
    assert tvr.VrptwInstance.from_solomon(str(p), num_customers=1).num_customers == 1


def test_gated_adapters_raise_without_their_packages():
    g = graph_from_name("BA_24_ID0")
    with pytest.raises(ValueError):  # the dispatch comes before the gate
        gurobi.solve_problem_qubo("tsp", g)
    if gurobi.HAS_GUROBI:  # pragma: no cover - no license here
        pytest.skip("gurobipy is installed")
    with pytest.raises(ImportError, match="rlsolver_tpu_torch.solvers.milp"):
        gurobi.solve_problem_qubo("maxcut", g)
    with pytest.raises(ImportError):
        gurobi.solve_maxcut(g, formulation="milp")
    if scip.HAS_SCIP:  # pragma: no cover
        pytest.skip("pyscipopt is installed")
    for fn in (scip.solve_maxcut, scip.solve_mis, scip.solve_mvc, scip.solve_graph_partitioning):
        with pytest.raises(ImportError, match="pyscipopt is not installed"):
            fn(g)


ENTRY_POINTS = {
    "ScorePolicy": lambda dev: trl.ScorePolicy(4, device=dev).net.Dense_0.kernel,
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_need_a_card_unless_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    assert ENTRY_POINTS[name]("cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name](None)
