"""Port parity: the word lists that K4 reads. The lists of
`PackedSweepTables` (each step's non-zero mask words, {w, m_proc, m_unproc,
m_all} per word, and the negative planes on a signed graph) expand back to
exactly the JAX package's mask planes, word for word, and the plain K4 fed
by them is bit-exact with JAX's `mcpg_sweep_reference` and the Pallas kernel
in interpret mode, given the same numpy noise. Graphs: the JAX package's
test instances, and graphs with isolated nodes (empty lists), N not a
multiple of 32, a unit hub, unsigned and signed. All sums are integers:
every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlsolver_tpu.core.generate import graph_from_name as j_graph_from_name
from rlsolver_tpu.core.graph import Graph as JGraph
from rlsolver_tpu.ops.pallas import mcpg_sweep as jsw
from rlsolver_tpu_torch.core.graph import Graph
from rlsolver_tpu_torch.ops.kernels import codec
from rlsolver_tpu_torch.ops.kernels import mcpg_sweep as tsw

torch.set_num_threads(1)


def _unit_edges(n, seed, signed, nodes=None, per_node=4):
    """Random edges among the first `nodes` nodes (all when None): each
    draws `per_node` partners; weight 1, or -1 with probability 0.4 if signed."""
    rng = np.random.default_rng(seed)
    m = n if nodes is None else nodes
    edges = {}
    for i in range(m):
        for j in rng.choice(m, size=per_node, replace=False):
            if i < j:
                edges[(i, int(j))] = -1.0 if signed and rng.random() < 0.4 else 1.0
    return [(a, b, w) for (a, b), w in sorted(edges.items())]


def _hub_edges(n):
    """Node 0 joined to every other node, plus a sparse ring."""
    return [(0, j, 1.0) for j in range(1, n)] + [(j, j + 1, 1.0) for j in range(1, n - 1, 3)]


def _signed_ba():
    """BA_100_ID2 with a deterministic half of the edges at weight -1."""
    return [(a, b, -1.0 if (a + b) % 2 else 1.0) for a, b, _ in j_graph_from_name("BA_100_ID2").to_edge_list()]


# name: (N, edges) or None for a named instance of both packages
GRAPHS = {
    "BA_100_ID0": None,
    "ER_64_ID1": None,
    "BA_100_pm1": (100, _signed_ba()),
    "isolated": (70, _unit_edges(70, 41, False, nodes=50)),  # nodes 50..69 have no edge
    "isolated_pm1": (80, _unit_edges(80, 42, True, nodes=61)),
    "N45": (45, _unit_edges(45, 43, False)),
    "hub": (96, _hub_edges(96)),
    "unsigned": (128, _unit_edges(128, 44, False, per_node=6)),
    "signed": (72, _unit_edges(72, 45, True)),
}


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def tables(request):
    name = request.param
    if GRAPHS[name] is None:
        from rlsolver_tpu_torch.core.generate import graph_from_name
        jg, tg = j_graph_from_name(name), graph_from_name(name)
    else:
        n, e = GRAPHS[name]
        jg, tg = JGraph.from_edge_list(n, e, name=name), Graph.from_edge_list(n, e, name=name)
    return jg, tg, jsw.PackedSweepTables.build(jg), tsw.PackedSweepTables.build(tg, "cpu")


def test_word_lists_expand_to_the_jax_planes(tables):
    jg, tg, jt, tt = tables
    n, w = tg.num_nodes, codec.num_words(tg.num_nodes)
    q = 2 if jt.signed else 1
    assert tt.signed == jt.signed and tt.word_entries.shape[1:] == (q, 4)
    off = tt.word_offsets.numpy().astype(np.int64)
    assert off[0] == 0 and np.all(np.diff(off) >= 0) and off[-1] == tt.word_entries.shape[0]
    ent = tt.word_entries.numpy()
    rows = np.repeat(np.arange(n), np.diff(off))
    idx = ent[:, 0, 0]
    # within a step, ascending and distinct word indices, each quad naming it
    assert np.all((np.diff(idx) > 0) | (np.diff(rows) > 0))
    assert np.all(ent[:, :, 0] == idx[:, None]) and np.all((idx >= 0) & (idx < w))
    # no entry for a word that is zero in every plane
    assert np.all(ent[:, :, 1:].reshape(len(idx), -1).any(axis=1))
    # m_all is m_proc | m_unproc, the two disjoint
    assert np.all(ent[:, :, 3] == ent[:, :, 1] | ent[:, :, 2]) and not np.any(ent[:, :, 1] & ent[:, :, 2])
    # the lists expand to JAX's planes word for word (and to the port's masks)
    planes = tsw.word_planes(tt)
    assert torch.equal(planes, tt.masks)
    names = [("m_proc", False), ("m_unproc", False), ("m_all", False)]
    if jt.signed:
        names += [(nm, True) for nm, _ in names]
    for name, neg in names:
        j = np.asarray(getattr(jt, name + ("_neg" if neg else "")))
        i = ("m_proc", "m_unproc", "m_all").index(name)
        np.testing.assert_array_equal(planes[2 * i + neg if jt.signed else i].numpy(), j[:, :w])
        assert not j[:, w:].any()  # the JAX lane padding holds nothing
    # a step's entries are exactly its non-zero words: as many as JAX's rows have
    j_rows = np.stack([np.asarray(getattr(jt, nm + ("_neg" if neg else "")))[:, :w] for nm, neg in names])
    np.testing.assert_array_equal(np.diff(off), (j_rows != 0).any(axis=0).sum(axis=1))


@pytest.mark.parametrize("sweeps", [1, 2, 3])
def test_word_fed_plain_k4_bit_exact_vs_jax(tables, sweeps):
    jg, tg, jt, tt = tables
    n, b = tg.num_nodes, 16
    rng = np.random.default_rng(200 + sweeps)
    bits, noise = rng.random((b, n)) < 0.5, rng.integers(0, 65536, (sweeps * n, b)).astype(np.int32)
    out = tsw.mcpg_sweep_packed(torch.from_numpy(noise), torch.from_numpy(bits), tt, num_sweeps=sweeps).numpy()
    ref = jsw.mcpg_sweep_reference(jnp.asarray(noise), jnp.asarray(bits), jt, jg, num_sweeps=sweeps)
    np.testing.assert_array_equal(out, np.asarray(ref))
    pallas = jsw.mcpg_sweep_packed(jnp.asarray(noise), jnp.asarray(bits), jt, num_sweeps=sweeps, block_chains=b,
                                   interpret=True)
    np.testing.assert_array_equal(out, np.asarray(pallas))
