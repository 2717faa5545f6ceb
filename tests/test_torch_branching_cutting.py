"""Learn-to-branch (`solvers/branching.py`) and learn-to-cut
(`solvers/cutting.py`) against the JAX package's: for each generator at
`tests/test_branching.py`'s sizes, the instance equal, B&B's objective,
solution and node count equal under most-fractional and under strong
branching (with its imitation samples), the features within 1e-6;
`BranchNet` from JAX's converted parameters: scores within 1e-5, the same
`policy()` choices (also at a node with more than 8 candidates, where both
pick among the first 8), `train_il`'s loss history within 1e-4 over 20
epochs; cover cuts, their features and `CuttingPlaneEnv`'s bounds and
rewards within 1e-9."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlsolver_tpu.core.generate import graph_from_name as j_graph_from_name
from rlsolver_tpu.solvers import branching as jb
from rlsolver_tpu.solvers import cutting as jcut
from rlsolver_tpu_torch import convert
from rlsolver_tpu_torch.core.generate import graph_from_name
from rlsolver_tpu_torch.solvers import branching as tb
from rlsolver_tpu_torch.solvers import cutting as tcut

torch.set_num_threads(1)

GENERATORS = {
    "set_cover": (lambda m, s: m.generate_set_cover(12, 8, seed=s), None),
    "indset": (lambda m, s: m.generate_indset(j_graph_from_name(f"BA_14_ID{s}"), seed=s),
               lambda m, s: m.generate_indset(graph_from_name(f"BA_14_ID{s}"), seed=s)),
    "cauctions": (lambda m, s: m.generate_cauctions(10, 12, seed=s), None),
    "facility": (lambda m, s: m.generate_facility(4, 3, seed=s), None),
}


def pair(name, seed=0):
    jgen, tgen = GENERATORS[name]
    return jgen(jb, seed), (tgen or jgen)(tb, seed)


def assert_ilp_equal(t, j):
    for a, b in ((t.c, j.c), (t.a, j.a), (t.b, j.b)):
        np.testing.assert_array_equal(a, b)
    assert t.name == j.name


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_branch_and_bound_matches_jax(name):
    jilp, tilp = pair(name)
    assert_ilp_equal(tilp, jilp)
    for kw in (dict(), dict(use_strong=True, collect_samples=True)):
        js, ts = jb.branch_and_bound(jilp, **kw), tb.branch_and_bound(tilp, **kw)
        assert ts.objective == js.objective and ts.num_nodes == js.num_nodes, kw
        np.testing.assert_array_equal(ts.solution, js.solution)
        assert len(ts.samples) == len(js.samples)
        for (tf, tp), (jf, jp) in zip(ts.samples, js.samples):
            np.testing.assert_array_equal(tf, jf)
            assert tp == jp
    rng = np.random.RandomState(0)
    x = np.clip(rng.rand(tilp.num_vars), 0.01, 0.99)
    cand = rng.choice(tilp.num_vars, min(5, tilp.num_vars), replace=False)
    np.testing.assert_allclose(tb.branching_features(tilp.c, tilp.a, x, cand),
                               jb.branching_features(jilp.c, jilp.a, x, cand), rtol=1e-6, atol=1e-6)


def il_samples(module):
    samples = []
    for s in range(2):
        samples += module.branch_and_bound(module.generate_set_cover(20, 10, seed=s), use_strong=True,
                                           collect_samples=True).samples
    return samples


def test_branch_net_matches_jax():
    jnet = jb.BranchNet(hidden=32, seed=0)
    tnet = tb.BranchNet(hidden=32, device="cpu")
    tnet.net.load_state_dict(convert.flax_state_dict(jax.tree.map(np.array, jnet.params)))
    rng = np.random.default_rng(1)
    feats = rng.random((11, tb.NUM_FEATURES)).astype(np.float32)
    np.testing.assert_allclose(tnet.net(torch.from_numpy(feats)).detach().numpy(),
                               np.asarray(jnet._score(jnet.params, jnp.asarray(feats))), rtol=1e-5, atol=1e-5)
    jchoose, tchoose = jnet.policy(), tnet.policy()
    for k in (1, 3, 8, 11):  # 11 candidates: both pick among the first 8
        f = rng.random((k, tb.NUM_FEATURES)).astype(np.float32)
        assert tchoose(f, np.arange(k)) == jchoose(f, np.arange(k)) < 8
    samples = il_samples(tb)
    assert len(samples) > 4
    jh, th = jnet.train_il(samples, epochs=20), tnet.train_il(samples, epochs=20)
    np.testing.assert_allclose(th, jh, rtol=1e-4, atol=1e-4)
    assert th[-1] < th[0]
    ilp = tb.generate_set_cover(20, 10, seed=99)
    jr = jb.branch_and_bound(jb.generate_set_cover(20, 10, seed=99), policy=jnet.policy())
    tr = tb.branch_and_bound(ilp, policy=tnet.policy())
    assert (tr.objective, tr.num_nodes) == (jr.objective, jr.num_nodes)


def knapsack_pair(seed=0, n=12):
    rng = np.random.RandomState(seed)
    w = rng.uniform(1, 10, n)
    p = w + rng.uniform(0, 2, n)
    cap = 0.5 * w.sum()
    return (jb.BinaryILP(p, w[None, :], np.asarray([cap]), "knapsack"),
            tb.BinaryILP(p, w[None, :], np.asarray([cap]), "knapsack"))


def assert_cuts_equal(tcuts, jcuts):
    assert len(tcuts) == len(jcuts)
    for t, j in zip(tcuts, jcuts):
        np.testing.assert_array_equal(t.cover, j.cover)
        assert (t.rhs, t.source_row) == (j.rhs, j.source_row)
        assert abs(t.violation - j.violation) <= 1e-9


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cutting_plane_env_matches_jax(seed):
    from scipy.optimize import linprog

    jilp, tilp = knapsack_pair(seed) if seed < 2 else (jb.generate_cauctions(10, 14, seed=5),
                                                       tb.generate_cauctions(10, 14, seed=5))
    x = np.asarray(linprog(c=-tilp.c, A_ub=tilp.a, b_ub=tilp.b, bounds=(0, 1), method="highs").x)
    tcuts, jcuts = tcut.separate_cover_cuts(tilp, x), jcut.separate_cover_cuts(jilp, x)
    assert_cuts_equal(tcuts, jcuts)
    np.testing.assert_allclose(tcut.cut_features(tilp, x, tcuts), jcut.cut_features(jilp, x, jcuts), atol=1e-9)
    jenv, tenv = jcut.CuttingPlaneEnv(jilp), tcut.CuttingPlaneEnv(tilp)
    (jf, jc), (tf, tc) = jenv.reset(), tenv.reset()
    steps = 0
    while tc and steps < 12:
        assert_cuts_equal(tc, jc)
        np.testing.assert_allclose(tf, jf, atol=1e-9)
        action = steps % len(tc)
        jf, jc, jr, jd = jenv.step(jc, action)
        tf, tc, tr, td = tenv.step(tc, action)
        assert abs(tr - jr) <= 1e-9 and abs(tenv.bound - jenv.bound) <= 1e-9 and td == jd
        steps += 1
        if td:
            break
    assert tcut.cutting_plane_loop(tilp, max_rounds=6) == pytest.approx(jcut.cutting_plane_loop(jilp, max_rounds=6),
                                                                       abs=1e-9)


ENTRY_POINTS = {
    "BranchNet": lambda dev: tb.BranchNet(hidden=8, device=dev).net.Dense_0.kernel,
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_need_a_card_unless_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    assert ENTRY_POINTS[name]("cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name](None)
