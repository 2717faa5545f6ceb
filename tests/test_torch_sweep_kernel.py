"""Port parity: K10, the greedy 1-flip sweep with f32 incremental gains. Its
plain version is bit-exact with the Pallas kernel (interpret mode) on the
same (adj, s, gains, vs), and `MaxcutEnv.sweep_1flip` without a packed path
agrees with the JAX env's f32 sweep on random f32 weights."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlsolver_tpu.core.generate import graph_from_name as j_graph_from_name
from rlsolver_tpu.core.graph import Graph as JGraph
from rlsolver_tpu.envs.maxcut import MaxcutEnv as JEnv
from rlsolver_tpu.ops import cut as jcut
from rlsolver_tpu.ops.pallas.sweep_kernel import sweep_1flip_pallas
from rlsolver_tpu_torch.core.graph import Graph
from rlsolver_tpu_torch.envs.maxcut import MaxcutEnv
from rlsolver_tpu_torch.ops.kernels import sweep_kernel as tsk
from rlsolver_tpu_torch.problems.objectives import obj_maxcut

torch.set_num_threads(1)


def _graphs(name: str, weights: str):
    """The JAX and port graphs of a synthetic topology, with its unit
    weights, fractional weights that bf16 holds exactly (k / 4, k in 1..8:
    the Pallas kernel keeps adj in bf16 at n <= 2048), or random f32."""
    jg = j_graph_from_name(name)
    rng = np.random.default_rng(len(name) + len(weights))
    w = {
        "unit": jg.weights,
        "quarters": rng.integers(1, 9, jg.num_edges) / 4.0,
        "random": rng.uniform(0.5, 1.5, jg.num_edges),
    }[weights].astype(np.float32)
    return JGraph(jg.num_nodes, jg.edges, w, name), Graph(jg.num_nodes, jg.edges.copy(), w.copy(), name)


def _state(jg, b, seed):
    env = JEnv(jg, dtype=jnp.float32)
    xs = np.random.default_rng(seed).random((b, jg.num_nodes)) < 0.5
    s = np.array(jcut.signs_from_bits(jnp.asarray(xs), jnp.float32))
    return env, xs, s, np.array(env.gains(jnp.asarray(xs))), np.array(env.obj(jnp.asarray(xs)))


@pytest.mark.parametrize("weights", ["unit", "quarters"])
@pytest.mark.parametrize("name,b", [("BA_48_ID0", 64), ("ER_32_ID1", 32)])
def test_k10_plain_bit_exact_vs_pallas(name, b, weights):
    jg, tg = _graphs(name, weights)
    _, _, s, gains, vs = _state(jg, b, seed=b)
    adj = tg.adjacency_dense()
    js, jgains, jvs = sweep_1flip_pallas(jnp.asarray(adj), jnp.asarray(s), jnp.asarray(gains), jnp.asarray(vs),
                                         block_chains=32, interpret=True)
    ts, tgains, tvs = tsk.sweep_1flip_f32(*(torch.from_numpy(a) for a in (adj, s, gains, vs)))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tgains.numpy(), np.asarray(jgains))
    np.testing.assert_array_equal(tvs.numpy(), np.asarray(jvs))
    # some chains flipped, and the inputs were not written
    assert (ts.numpy() != s).any()
    assert np.array_equal(np.asarray(jcut.signs_from_bits(jnp.asarray(s > 0), jnp.float32)), s)


@pytest.mark.parametrize("name", ["BA_48_ID0", "ER_32_ID1", "PL_40_ID2"])
def test_env_sweep_matches_jax_f32_env_on_random_weights(name):
    jg, tg = _graphs(name, "random")
    jenv, xs, _, _, vs = _state(jg, 48, seed=7)
    j_bits, j_vs = jenv.sweep_1flip(jnp.asarray(xs), jnp.asarray(vs))
    env = MaxcutEnv(tg, "cpu")
    assert env.flip_engine is None
    t_bits, t_vs = env.sweep_1flip(torch.from_numpy(xs), torch.from_numpy(vs))
    np.testing.assert_array_equal(t_bits.numpy(), np.asarray(j_bits))
    np.testing.assert_allclose(t_vs.numpy(), np.asarray(j_vs), atol=1e-4, rtol=0)
    # a packed env falls back to the same f32 sweep on non-integer weights
    packed = MaxcutEnv(tg, "cpu", packed_sweep=True)
    assert packed.flip_engine is None
    np.testing.assert_array_equal(packed.sweep_1flip(torch.from_numpy(xs), torch.from_numpy(vs))[0].numpy(),
                                  t_bits.numpy())


@pytest.mark.parametrize("name", ["ER_32_ID1", "BA_48_ID0"])
def test_env_sweep_host_parity_and_local_optimum(name):
    tg = _graphs(name, "unit")[1]
    env = MaxcutEnv(tg, "cpu")
    xs = torch.from_numpy(np.random.default_rng(3).random((32, tg.num_nodes)) < 0.5)
    vs = env.obj(xs)
    out, out_vs = env.sweep_1flip(xs, vs)
    assert bool((out_vs >= vs).all())
    for b in range(out.shape[0]):
        assert float(out_vs[b]) == obj_maxcut(out[b].numpy().astype(np.int64), tg)
    # the returned gains are those of a fresh computation on the result
    s, gains, _ = tsk.sweep_1flip_f32(env.cg.adj, (2.0 * xs.float() - 1.0), env.gains(xs), vs)
    torch.testing.assert_close(gains, env.gains(s > 0), rtol=0, atol=1e-5)


def test_k10_wrapper_needs_dense_adjacency():
    tg = _graphs("BA_48_ID0", "unit")[1]
    env = MaxcutEnv(tg, "cpu", mode="sparse")
    xs = torch.zeros(2, tg.num_nodes, dtype=torch.bool)
    with pytest.raises(NotImplementedError, match="dense adjacency"):
        env.sweep_1flip(xs, env.obj(xs))


def test_packed_sweep_env_picks_by_weight_fault(monkeypatch):
    """`MaxcutEnv(packed_sweep=True)` builds the packed 1-flip engine exactly
    where `weight_fault` finds none, takes K10's f32 sweep elsewhere, and
    lets any other error of the engine's build through."""
    from rlsolver_tpu_torch.envs import maxcut as env_mod

    unit = _graphs("BA_48_ID0", "unit")[1]
    frac = _graphs("BA_48_ID0", "random")[1]
    env = MaxcutEnv(unit, "cpu", packed_sweep=True)
    assert env.flip_engine is not None and env.f32_lists is None
    env = MaxcutEnv(frac, "cpu", packed_sweep=True)
    assert env.flip_engine is None and env.f32_lists is not None
    xs = torch.rand(4, frac.num_nodes, generator=torch.Generator().manual_seed(0)) < 0.5
    out, out_vs = env.sweep_1flip(xs, env.obj(xs))
    assert float(out_vs[0]) == pytest.approx(obj_maxcut(out[0].numpy().astype(np.int64), frac), rel=1e-6)

    def broken_build(graph, device=None):
        raise ValueError("a table could not be built")

    monkeypatch.setattr(env_mod.FlipSweepEngine, "build", staticmethod(broken_build))
    with pytest.raises(ValueError, match="table could not be built"):
        MaxcutEnv(unit, "cpu", packed_sweep=True)
    assert MaxcutEnv(frac, "cpu", packed_sweep=True).flip_engine is None
