"""Port parity: packed sweep tables and the plain versions of K4 and K5.
Tables equal JAX's word for word (without the TPU's lane padding); K4 fed
JAX's noise is bit-exact with `mcpg_sweep_reference` and the Pallas kernel
(interpret mode), and with zero noise equals both packages'
`degree_ordered_sweep`; K5 is bit-exact with the Pallas kernel and the f32
incremental-gain sweep. With `packed_sweep=True` on integer weights the env
takes the bit-plane 1-flip sweep and equals the f32 sweep; on non-integer
weights it keeps the f32 sweep, and packed MCPG raises, as in JAX."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlsolver_tpu.core.generate import graph_from_name as j_graph_from_name
from rlsolver_tpu.core.graph import Graph as JGraph
from rlsolver_tpu.envs.maxcut import MaxcutEnv as JEnv
from rlsolver_tpu.ops import sweeps as j_sweeps
from rlsolver_tpu.ops.pallas import mcpg_sweep as jsw
from rlsolver_tpu_torch.algos.mcpg import MCPGConfig, solve_maxcut_mcpg
from rlsolver_tpu_torch.core.generate import graph_from_name
from rlsolver_tpu_torch.core.graph import Graph
from rlsolver_tpu_torch.envs.maxcut import MaxcutEnv
from rlsolver_tpu_torch.ops import sweeps as t_sweeps
from rlsolver_tpu_torch.ops.kernels import mcpg_sweep as tsw
from rlsolver_tpu_torch.ops.kernels import philox
from rlsolver_tpu_torch.ops.kernels import weighted_sweep as twsw
from rlsolver_tpu_torch.problems.objectives import obj_maxcut

torch.set_num_threads(1)


def _signed_edges():
    """BA_100_ID2 with a deterministic half of the edges at weight -1."""
    g = j_graph_from_name("BA_100_ID2")
    return [(a, b, -1.0 if (a + b) % 2 else 1.0) for a, b, _ in g.to_edge_list()]


def _pair(name):
    if name == "BA_100_pm1":
        e = _signed_edges()
        return JGraph.from_edge_list(100, e, name), Graph.from_edge_list(100, e, name)
    return j_graph_from_name(name), graph_from_name(name)


@pytest.fixture(scope="module", params=["BA_100_ID0", "ER_64_ID1", "BA_100_pm1"])
def setup(request):
    jg, tg = _pair(request.param)
    return jg, tg, jsw.PackedSweepTables.build(jg), tsw.PackedSweepTables.build(tg, "cpu")


def test_tables_and_adjacency_match_jax(setup):
    jg, tg, jt, tt = setup
    w = (jg.num_nodes + 31) // 32
    assert tt.signed == jt.signed
    names = [("m_proc", False), ("m_unproc", False), ("m_all", False)]
    if jt.signed:
        names += [(n, True) for n, _ in names]
    for name, neg in names:
        j = np.asarray(getattr(jt, name + ("_neg" if neg else "")))
        np.testing.assert_array_equal(tt.plane(name, neg).numpy(), j[:, :w])
        assert not j[:, w:].any()  # the JAX lane padding holds nothing
    np.testing.assert_array_equal(tt.nodes.numpy(), np.asarray(jt.nodes))
    np.testing.assert_array_equal(tt.thr1.numpy(), np.asarray(jt.thr1))
    np.testing.assert_array_equal(tt.thr2.numpy(), np.asarray(jt.thr2))
    j_pos, j_neg = jsw.pack_adjacency(jg)
    adj = tsw.pack_adjacency(tg, "cpu")
    np.testing.assert_array_equal(adj.pos.numpy(), np.asarray(j_pos)[:, :w])
    assert (adj.neg is None) == (j_neg is None)
    if j_neg is not None:
        np.testing.assert_array_equal(adj.neg.numpy(), np.asarray(j_neg)[:, :w])


@pytest.mark.parametrize("num_sweeps", [1, 2])
def test_k4_plain_bit_exact_vs_jax(setup, num_sweeps):
    jg, tg, jt, tt = setup
    n, b = jg.num_nodes, 128
    rng = np.random.default_rng(num_sweeps)
    bits = rng.random((b, n)) < 0.5
    noise = rng.integers(0, 65536, (num_sweeps * n, b)).astype(np.int32)
    ref = np.asarray(jsw.mcpg_sweep_reference(jnp.asarray(noise), jnp.asarray(bits), jt, jg,
                                              num_sweeps=num_sweeps))
    pallas = np.asarray(jsw.mcpg_sweep_packed(jnp.asarray(noise), jnp.asarray(bits), jt,
                                              num_sweeps=num_sweeps, block_chains=b, interpret=True))
    out = tsw.mcpg_sweep_packed(torch.from_numpy(noise), torch.from_numpy(bits), tt,
                                num_sweeps=num_sweeps).numpy()
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, pallas)


def test_k4_zero_noise_equals_degree_ordered_sweeps(setup):
    jg, tg, _, tt = setup
    n, b = jg.num_nodes, 64
    bits = np.random.default_rng(2).random((b, n)) < 0.5
    out = tsw.mcpg_sweep_packed(torch.zeros(2 * n, b, dtype=torch.int32), torch.from_numpy(bits), tt,
                                num_sweeps=2, noise_scale=0.0).numpy()
    xt_j = j_sweeps.degree_ordered_sweep(jax.random.PRNGKey(3), j_sweeps.mcpg_init_values(jnp.asarray(bits)),
                                         j_sweeps.SweepData.build(jg), num_sweeps=2, noise_scale=0.0)
    xt_t = t_sweeps.degree_ordered_sweep(torch.Generator().manual_seed(3),
                                         t_sweeps.mcpg_init_values(torch.from_numpy(bits)),
                                         t_sweeps.SweepData.build(tg, "cpu"), num_sweeps=2, noise_scale=0.0)
    np.testing.assert_array_equal(out, np.asarray(xt_j[:, :n] > 0.5))
    np.testing.assert_array_equal(out, (xt_t[:, :n] > 0.5).numpy())


def test_k4_fused_draws_the_philox_noise(setup):
    # the fused sweep is the injected one fed draw t = s*N + k of each chain
    _, tg, _, tt = setup
    n, b, s, seed = tg.num_nodes, 48, 2, 77
    bits = torch.from_numpy(np.random.default_rng(4).random((b, n)) < 0.5)
    chains = torch.arange(b)
    noise = torch.stack([philox.philox_block(seed, philox.TAG_SWEEP, t >> 2, chains)[t & 3] & 0xFFFF
                         for t in range(s * n)]).to(torch.int32)
    fused = tsw.mcpg_sweep_fused(seed, bits, tt, num_sweeps=s)
    assert torch.equal(fused, tsw.mcpg_sweep_packed(noise, bits, tt, num_sweeps=s))
    assert not torch.equal(fused, tsw.mcpg_sweep_fused(seed + 1, bits, tt, num_sweeps=s))


def test_k5_plain_bit_exact_vs_jax(setup):
    jg, tg, _, _ = setup
    bits = np.random.default_rng(6).random((64, jg.num_nodes)) < 0.5
    pallas = np.asarray(jsw.sweep_1flip_packed(jnp.asarray(bits), jsw.pack_adjacency(jg),
                                               block_chains=64, interpret=True))
    jenv = JEnv(jg)
    j_bits, j_vs = jenv.sweep_1flip(jnp.asarray(bits), jenv.obj(jnp.asarray(bits)))
    env = MaxcutEnv(tg, "cpu", packed_sweep=True)
    x = torch.from_numpy(bits)
    out, vs = env.sweep_1flip(x, env.obj(x))
    np.testing.assert_array_equal(out.numpy(), pallas)
    np.testing.assert_array_equal(out.numpy(), np.asarray(j_bits))
    np.testing.assert_array_equal(vs.numpy(), np.asarray(j_vs))


def _int_weighted_graph():
    """BA_100_ID2 with integer weights in +-{1..5}, drawn from a seed."""
    rng = np.random.default_rng(17)
    edges = [(a, b, float(rng.integers(1, 6) * rng.choice((-1, 1))))
             for a, b, _ in j_graph_from_name("BA_100_ID2").to_edge_list()]
    return Graph.from_edge_list(100, edges, name="BA_100_w5")


def test_env_packed_sweep_on_integer_weights_equals_f32_sweep():
    g = _int_weighted_graph()
    env = MaxcutEnv(g, "cpu", packed_sweep=True)
    assert env.flip_engine is not None and env.flip_engine.weighted
    ref = MaxcutEnv(g, "cpu")
    x = torch.from_numpy(np.random.default_rng(8).random((48, 100)) < 0.5)
    out, vs = env.sweep_1flip(x, env.obj(x))
    ref_bits, ref_vs = ref.sweep_1flip(x, ref.obj(x))
    assert torch.equal(out, ref_bits)
    assert torch.equal(vs, ref_vs)


def test_non_integer_weights_take_the_f32_sweep_and_refuse_packed_mcpg():
    g = Graph.from_edge_list(4, [(0, 1, 0.5), (1, 2, 1.0), (2, 3, 2.0)], name="frac")
    with pytest.raises(ValueError, match="0, \\+-1"):
        tsw.PackedSweepTables.build(g, "cpu")
    with pytest.raises(ValueError, match="integer"):
        twsw.WeightedSweepTables.build(g, "cpu")
    env = MaxcutEnv(g, "cpu", packed_sweep=True)
    assert env.flip_engine is None  # as in the JAX package: the f32 sweep
    x = torch.tensor([[False, True, True, False]])
    out, vs = env.sweep_1flip(x, env.obj(x))
    assert torch.equal(out, MaxcutEnv(g, "cpu").sweep_1flip(x, env.obj(x))[0])
    assert float(vs[0]) == obj_maxcut(out[0].numpy().astype(np.int64), g)
    with pytest.raises(ValueError, match="integer"):
        solve_maxcut_mcpg(g, MCPGConfig(sweep_mode="packed"), device="cpu")
