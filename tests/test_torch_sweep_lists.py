"""Port parity: the neighbour lists that K6 and K7 read. The lists of
`WeightedSweepTables` expand back to exactly the bit-planes of the JAX
package's tables (weights word for word, and the `earlier` plane on every
neighbour), and the plain sweep fed by them is bit-exact with JAX's
`mcpg_sweep_reference` and the Pallas kernel in interpret mode, given the
same numpy noise. Graphs: the JAX package's test shapes, and graphs with
isolated nodes (empty lists), N not a multiple of 32, 15 planes, no
negative weight, and a hub. All sums are integers: every comparison is
exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlsolver_tpu.core.graph import Graph as JGraph
from rlsolver_tpu.ops.pallas import mcpg_sweep as jsw
from rlsolver_tpu.ops.pallas import weighted_sweep as jwsw
from rlsolver_tpu_torch.core.graph import Graph
from rlsolver_tpu_torch.ops.kernels import codec
from rlsolver_tpu_torch.ops.kernels import weighted_sweep as twsw

torch.set_num_threads(1)
W15 = (1 << 15) - 1  # the largest weight the kernels take: 15 planes


def _edges(n, seed, w_max, signed, nodes=None, per_node=4):
    """Random edges among the first `nodes` nodes (all when None): each
    draws `per_node` partners; weights in [1, w_max], 40% negative if signed."""
    rng = np.random.default_rng(seed)
    m = n if nodes is None else nodes
    edges = {}
    for i in range(m):
        for j in rng.choice(m, size=per_node, replace=False):
            if i < j:
                w = int(rng.integers(1, w_max + 1))
                edges[(i, int(j))] = -w if signed and rng.random() < 0.4 else w
    return [(a, b, float(w)) for (a, b), w in sorted(edges.items())]


def _hub_edges(n, seed):
    """Node 0 joined to every other node, plus a sparse ring of weights."""
    rng = np.random.default_rng(seed)
    edges = [(0, j, float(rng.integers(1, 4))) for j in range(1, n)]
    return edges + [(j, j + 1, float(rng.integers(1, 4))) for j in range(1, n - 1, 3)]


# name: (N, edges); the JAX package's test shapes first
GRAPHS = {
    "N72w5s": (72, _edges(72, 3, 5, True)),
    "N40w6u": (40, _edges(40, 7, 6, False)),
    "N56w7s": (56, _edges(56, 9, 7, True)),
    "N96w4s": (96, _edges(96, 21, 4, True)),
    "N64w3u": (64, _edges(64, 23, 3, False)),
    "isolated": (70, _edges(70, 31, 5, True, nodes=52)),  # nodes 52..69 have no edge
    "N45": (45, _edges(45, 32, 6, True)),
    "k15s": (48, _edges(48, 33, W15, True)),
    "k15u": (33, _edges(33, 34, W15, False, per_node=3)),
    "hub": (64, _hub_edges(64, 35)),
}


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def tables(request):
    n, e = GRAPHS[request.param]
    jg, tg = JGraph.from_edge_list(n, e, name=request.param), Graph.from_edge_list(n, e, name=request.param)
    return jg, tg, jwsw.WeightedSweepTables.build(jg), twsw.WeightedSweepTables.build(tg, "cpu")


def _signed_rows(planes, k, signed, n, dtype):
    """sum_b 2^b (pos_b - neg_b) over planes [k (+k), R, W] -> [R, n] weights."""
    out = torch.zeros(planes.shape[1], n, dtype=dtype)
    for b in range(k):
        out += (1 << b) * codec.unpack_bits(planes[b], n).to(dtype)
        if signed:
            out -= (1 << b) * codec.unpack_bits(planes[k + b], n).to(dtype)
    return out


def _jax_words(planes, w):
    return [np.array(p)[:, :w] for p in planes]


def test_lists_expand_to_the_jax_planes(tables):
    jg, tg, jt, tt = tables
    n, w = tg.num_nodes, codec.num_words(tg.num_nodes)
    off = tt.offsets.numpy().astype(np.int64)
    assert off[0] == 0 and np.all(np.diff(off) >= 0) and off[-1] == tt.entries.shape[0]
    rows = np.repeat(np.arange(n), np.diff(off))
    j, meta = tt.entries[:, 0].numpy().astype(np.int64), tt.entries[:, 1].numpy().astype(np.int64)
    # within a row, ascending and distinct neighbours, none of weight 0
    assert np.all((np.diff(j) > 0) | (np.diff(rows) > 0))
    assert np.all(meta >> 1 != 0)
    a = np.zeros((n, n), np.int64)
    a[rows, j] = meta >> 1
    earlier = np.zeros((n, n), bool)
    earlier[rows, j] = (meta & 1) == 1
    # the weights' signed bit-planes, packed, are JAX's planes word for word
    k = int(np.abs(a).max()).bit_length()
    assert k == tt.k == len(jt.planes_pos) and tt.signed == bool(jt.planes_neg) == bool((a < 0).any())
    for sign, jplanes in ((1, jt.planes_pos), (-1, jt.planes_neg)):
        for b, q in zip(range(k), _jax_words(jplanes, w)):
            bits = (np.sign(a) == sign) & (((np.abs(a) >> b) & 1) == 1)
            np.testing.assert_array_equal(codec.pack_bits(torch.from_numpy(bits)).numpy(), q)
    # the earlier flag is JAX's earlier plane on every neighbour
    j_earlier = codec.unpack_bits(torch.from_numpy(_jax_words([jt.earlier], w)[0]), n).numpy()
    np.testing.assert_array_equal(earlier, j_earlier & (a != 0))
    # and the lists hold every neighbour of every step, in JAX's sweep order
    order = np.asarray(jt.nodes)
    np.testing.assert_array_equal(tt.nodes.numpy(), order)
    np.testing.assert_array_equal(a, np.rint(jg.adjacency_dense()).astype(np.int64)[order])


def test_list_coefficients_are_the_first_and_later_sums(tables):
    # C1 = 2A - A*E and C2 = A, as the plain version computed them from the planes
    _, tg, _, tt = tables
    n = tg.num_nodes
    a = _signed_rows(tt.planes[1:], tt.k, tt.signed, n, torch.float32)
    e = codec.unpack_bits(tt.earlier, n).to(torch.float32)
    c1, c2 = twsw.list_coefficients(tt)
    assert torch.equal(c2, a)
    assert torch.equal(c1, 2.0 * a - a * e)


@pytest.mark.parametrize("sweeps", [1, 2, 3])
def test_list_fed_plain_sweep_bit_exact_vs_jax(tables, sweeps):
    jg, tg, jt, tt = tables
    n, b = tg.num_nodes, 16
    rng = np.random.default_rng(100 + sweeps)
    bits, noise = rng.random((b, n)) < 0.5, rng.integers(0, 65536, (sweeps * n, b)).astype(np.int32)
    out = twsw.mcpg_sweep_weighted(torch.from_numpy(noise), torch.from_numpy(bits), tt, num_sweeps=sweeps).numpy()
    ref = jsw.mcpg_sweep_reference(jnp.asarray(noise), jnp.asarray(bits), jt, jg, num_sweeps=sweeps)
    np.testing.assert_array_equal(out, np.asarray(ref))
    pallas = jwsw.mcpg_sweep_weighted(jnp.asarray(noise), jnp.asarray(bits), jt, num_sweeps=sweeps, block_chains=b,
                                      interpret=True)
    np.testing.assert_array_equal(out, np.asarray(pallas))
    # K7's wrapper takes the same plain version whatever its stage
    chunked = twsw.mcpg_sweep_weighted(torch.from_numpy(noise), torch.from_numpy(bits), tt, num_sweeps=sweeps,
                                       node_chunk=3)
    np.testing.assert_array_equal(chunked.numpy(), out)
