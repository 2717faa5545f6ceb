"""Port parity: cut objective, flip gains, reductions and the f32 1-flip
sweep of `rlsolver_tpu_torch` equal the JAX values exactly on integer-weight
graphs (all partial sums are integers below 2^24 in both)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlsolver_tpu.core.generate import graph_from_name as j_graph_from_name
from rlsolver_tpu.core.graph import Graph as JGraph
from rlsolver_tpu.envs.maxcut import MaxcutEnv as JEnv
from rlsolver_tpu.ops import cut as j_cut
from rlsolver_tpu.ops import reductions as j_red
from rlsolver_tpu.ops import sampling as j_sampling
from rlsolver_tpu_torch.core.generate import graph_from_name
from rlsolver_tpu_torch.core.graph import Graph
from rlsolver_tpu_torch.envs.maxcut import MaxcutEnv
from rlsolver_tpu_torch.ops import cut as t_cut
from rlsolver_tpu_torch.ops import reductions as t_red
from rlsolver_tpu_torch.ops import sampling as t_sampling

torch.set_num_threads(1)


def _weighted_pair(seed=0, n=48):
    """The same integer-weight graph (weights in -3..3 without 0) in both packages."""
    rng = np.random.default_rng(seed)
    edges = [(a, b, float(rng.choice([-3, -2, -1, 1, 2, 3])))
             for a in range(n) for b in range(a + 1, n) if rng.random() < 0.2]
    return JGraph.from_edge_list(n, edges, "w"), Graph.from_edge_list(n, edges, "w")


def _pairs():
    out = [(j_graph_from_name(n), graph_from_name(n)) for n in ("BA_100_ID0", "ER_64_ID1")]
    return out + [_weighted_pair()]


@pytest.fixture(scope="module", params=[0, 1, 2], ids=["BA_100", "ER_64", "weighted_48"])
def pair(request):
    return _pairs()[request.param]


def _bits(n, b=96, seed=1):
    return np.random.default_rng(seed).random((b, n)) < 0.5


def test_cut_and_gains_exact(pair):
    jg, tg = pair
    xs = _bits(jg.num_nodes)
    jcg = j_cut.CutGraph.build(jg)
    tcg = t_cut.CutGraph.build(tg, "cpu")
    x_j, x_t = jnp.asarray(xs), torch.from_numpy(xs)
    for jf, tf in ((j_cut.cut_dense, t_cut.cut_dense), (j_cut.cut_sparse, t_cut.cut_sparse),
                   (j_cut.flip_gains_dense, t_cut.flip_gains_dense),
                   (j_cut.flip_gains_sparse, t_cut.flip_gains_sparse),
                   (j_cut.node_cut_contrib_sparse, t_cut.node_cut_contrib_sparse)):
        np.testing.assert_array_equal(tf(x_t, tcg).numpy(), np.asarray(jf(x_j, jcg)))
    for mode in ("auto", "dense", "sparse"):
        np.testing.assert_array_equal(t_cut.cut_value(x_t, tcg, mode).numpy(),
                                      np.asarray(j_cut.cut_value(x_j, jcg, mode)))


def test_cut_dense_chunks_rows(monkeypatch, pair):
    jg, tg = pair
    xs = torch.from_numpy(_bits(jg.num_nodes, b=37))
    tcg = t_cut.CutGraph.build(tg, "cpu")
    whole = t_cut.cut_dense(xs, tcg)
    monkeypatch.setattr(t_cut, "CHUNK", 8)
    torch.testing.assert_close(t_cut.cut_dense(xs, tcg), whole, rtol=0, atol=0)
    torch.testing.assert_close(t_cut.cut_sparse(xs, tcg), whole, rtol=0, atol=0)


def test_env_obj_and_f32_sweep_1flip_exact(pair):
    jg, tg = pair
    xs = _bits(jg.num_nodes, b=64, seed=2)
    jenv, tenv = JEnv(jg), MaxcutEnv(tg, "cpu")
    np.testing.assert_array_equal(tenv.obj(torch.from_numpy(xs)).numpy(), np.asarray(jenv.obj(jnp.asarray(xs))))
    jb, jv = jenv.sweep_1flip(jnp.asarray(xs), jenv.obj(jnp.asarray(xs)))
    tb, tv = tenv.sweep_1flip(torch.from_numpy(xs), tenv.obj(torch.from_numpy(xs)))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tv.numpy(), tenv.obj(tb).numpy())


def test_reductions_exact():
    rng = np.random.default_rng(4)
    R, B, N = 4, 16, 10
    xs = rng.random((R * B, N)) < 0.5
    vs = rng.integers(0, 5, R * B).astype(np.float32)  # many ties: first repeat wins
    for maximize in (True, False):
        jx, jv = j_red.pick_xs_by_vs(jnp.asarray(xs), jnp.asarray(vs), R, maximize)
        tx, tv = t_red.pick_xs_by_vs(torch.from_numpy(xs), torch.from_numpy(vs), R, maximize)
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        gx, gv = xs[:B], vs[:B]
        jx2, jv2 = j_red.update_xs_by_vs(jnp.asarray(gx), jnp.asarray(gv), jx, jv, maximize)
        tx2, tv2 = t_red.update_xs_by_vs(torch.from_numpy(gx), torch.from_numpy(gv), tx, tv, maximize)
        np.testing.assert_array_equal(tx2.numpy(), np.asarray(jx2))
        np.testing.assert_array_equal(tv2.numpy(), np.asarray(jv2))


def test_bernoulli_logp_matches():
    rng = np.random.default_rng(6)
    probs = rng.uniform(0.2, 0.8, 30).astype(np.float32)
    bits = rng.random((40, 30)) < 0.5
    np.testing.assert_allclose(
        t_sampling.bernoulli_logp(torch.from_numpy(probs), torch.from_numpy(bits)).numpy(),
        np.asarray(j_sampling.bernoulli_logp(jnp.asarray(probs), jnp.asarray(bits))),
        rtol=1e-6,  # f32 sums of 30 logs, taken in another order
    )
