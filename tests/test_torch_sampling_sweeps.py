"""The port's MH scan, accept mask, Gumbel top-k, edge-pair and colored
sweeps and greedy coloring against the JAX package's, with JAX's draws
injected. Every comparison is exact: bits and indices, on unit-weight
graphs whose sums are integers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlsolver_tpu.core.generate import graph_from_name as j_graph_from_name
from rlsolver_tpu.ops import sampling as js
from rlsolver_tpu.ops import sweeps as jsw
from rlsolver_tpu_torch.core.generate import build_g22_like, graph_from_name
from rlsolver_tpu_torch.ops import sampling as ts
from rlsolver_tpu_torch.ops import sweeps as tsw

torch.set_num_threads(1)


def mh_draws(key, num_rounds, num_chains, num_nodes):
    """The (nodes, u) [R, C] that `metropolis_bitflip_scan` draws from key."""

    def one(k):
        k_node, k_u = jax.random.split(k)
        return jax.random.randint(k_node, (num_chains,), 0, num_nodes), jax.random.uniform(k_u, (num_chains,))

    return jax.vmap(one)(jax.random.split(key, num_rounds))


@pytest.mark.parametrize("num_nodes,num_chains,num_rounds", [(10, 7, 30), (64, 33, 100)])
def test_metropolis_bitflip_scan_matches_jax(num_nodes, num_chains, num_rounds):
    rng = np.random.default_rng(num_nodes)
    probs = rng.uniform(0.2, 0.8, num_nodes).astype(np.float32)
    bits = rng.random((num_chains, num_nodes)) < 0.5
    key = jax.random.PRNGKey(num_rounds)
    expect, (nodes, u) = jax.jit(lambda p, x: (js.metropolis_bitflip_scan(key, p, x, num_rounds),
                                               mh_draws(key, num_rounds, num_chains, num_nodes)))(probs, bits)
    nodes, u = torch.from_numpy(np.array(nodes)), torch.from_numpy(np.array(u))
    got = ts.metropolis_bitflip_scan(None, torch.from_numpy(probs), torch.from_numpy(bits), num_rounds, nodes, u)
    np.testing.assert_array_equal(got.numpy(), np.asarray(expect))
    # drawn from a generator, the chains still move and keep their shape
    gen = torch.Generator().manual_seed(0)
    drawn = ts.metropolis_bitflip_scan(gen, torch.from_numpy(probs), torch.from_numpy(bits), num_rounds)
    assert drawn.shape == bits.shape and drawn.dtype == torch.bool and (drawn.numpy() != bits).any()


def test_mh_accept_and_gumbel_topk_match_jax():
    key = jax.random.PRNGKey(3)
    log_alpha = jnp.asarray(np.random.default_rng(3).normal(size=(6, 50)).astype(np.float32))
    u = np.array(jax.random.uniform(key, log_alpha.shape))
    np.testing.assert_array_equal(
        ts.mh_accept(None, torch.from_numpy(np.array(log_alpha)), torch.from_numpy(u)).numpy(),
        np.asarray(js.mh_accept(key, log_alpha)))
    logits = jnp.asarray(np.random.default_rng(4).normal(size=(5, 40)).astype(np.float32))
    g = np.array(jax.random.gumbel(key, logits.shape, logits.dtype))
    got = ts.gumbel_topk(None, torch.from_numpy(np.array(logits)), 7, torch.from_numpy(g))
    np.testing.assert_array_equal(got.numpy(), np.asarray(js.gumbel_topk(key, logits, 7)))
    drawn = ts.gumbel_topk(torch.Generator().manual_seed(0), torch.from_numpy(np.array(logits)), 7)
    assert drawn.shape == (5, 7) and all(len(set(r)) == 7 for r in drawn.tolist())


@pytest.mark.parametrize("name", ["BA_32_ID0", "BA_40_ID3", "ER_30_ID1"])
def test_greedy_coloring_matches_jax(name):
    jc, jn = j_graph_from_name(name).greedy_coloring()
    tc, tn = graph_from_name(name).greedy_coloring()
    assert tn == jn
    np.testing.assert_array_equal(tc, jc)


def test_greedy_coloring_g22_like_is_proper():
    g = build_g22_like()
    color, num_colors = g.greedy_coloring()
    assert (color[g.edges[:, 0]] != color[g.edges[:, 1]]).all()
    assert num_colors == color.max() + 1 and (color >= 0).all()
    assert g.density == pytest.approx(2 * 19990 / (2000 * 1999))
    assert g.to_edge_list()[0] == (int(g.edges[0, 0]), int(g.edges[0, 1]), 1.0)


@pytest.mark.parametrize("noise_scale,num_sweeps", [(0.0, 2), (0.1, 1), (0.3, 2)])
def test_edge_pair_sweep_matches_jax(noise_scale, num_sweeps):
    name, b = "BA_32_ID0", 24
    jg, tg = j_graph_from_name(name), graph_from_name(name)
    key = jax.random.PRNGKey(7)
    xs = np.random.default_rng(7).random((b, 32)) < 0.5
    expect = jsw.edge_pair_sweep(key, jnp.asarray(xs), jg, num_sweeps, noise_scale)
    keys = jax.random.split(key, jg.num_edges * num_sweeps)
    noise = torch.from_numpy(np.array(jax.vmap(lambda k: jax.random.uniform(k, (4, b)))(keys)))
    data = tsw.EdgeSweepData.build(tg, "cpu")
    got = tsw.edge_pair_sweep(None, torch.from_numpy(xs), data, num_sweeps, noise_scale, noise=noise)
    np.testing.assert_array_equal(got.numpy(), np.asarray(expect))
    if noise_scale == 0.0:  # no draws needed
        np.testing.assert_array_equal(tsw.edge_pair_sweep(None, torch.from_numpy(xs), data, num_sweeps, 0.0).numpy(),
                                      np.asarray(expect))


@pytest.mark.parametrize("num_sweeps", [1, 3])
def test_colored_sweep_matches_jax(num_sweeps):
    name, b = "BA_40_ID3", 16
    jg, tg = j_graph_from_name(name), graph_from_name(name)
    jdata = jsw.SweepData.build(jg)
    tdata = tsw.SweepData.build(tg, "cpu")
    np.testing.assert_array_equal(tdata.color_masks.numpy(), np.asarray(jdata.color_masks))
    key = jax.random.PRNGKey(11)
    xs = (np.random.default_rng(11).random((b, 40)) < 0.5).astype(np.float32)
    adj, wdeg = jg.adjacency_dense(), jg.weighted_degrees()
    expect = jsw.colored_sweep(key, jnp.asarray(xs), jnp.asarray(adj), jnp.asarray(wdeg), jdata.color_masks,
                               num_sweeps)
    num_colors = tdata.color_masks.shape[0]
    noise = jax.vmap(lambda k: jax.vmap(lambda kc: jax.random.uniform(kc, xs.shape))(jax.random.split(k, num_colors)))(
        jax.random.split(key, num_sweeps))
    got = tsw.colored_sweep(None, torch.from_numpy(xs), torch.from_numpy(adj), torch.from_numpy(wdeg),
                            tdata.color_masks, num_sweeps, noise=torch.from_numpy(np.array(noise)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(expect))
