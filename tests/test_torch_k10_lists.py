"""Port parity: the neighbour lists that K10 reads. `F32AdjLists` holds each
row's non-zero adjacency entries {j, A[i, j] as f32 bits} in ascending j;
expanded back they are the dense adjacency bit for bit. The kernel's
arithmetic, emulated here in its order (at each node, the chains that accept
add (-2 s_i) s_j A[i, j] to the gains of the row's listed j only, each add
rounded once in f32), equals the Pallas kernel in interpret mode (on
weights bf16 holds exactly: it keeps adj in bf16 at n <= 2048) and the plain
loop over every j: s and vs exactly, gains up to the sign of a zero. Unit,
quarter and random f32 weights; a dense graph, isolated nodes and N not a
multiple of 32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlsolver_tpu.core.generate import graph_from_name as j_graph_from_name
from rlsolver_tpu.ops.pallas.sweep_kernel import sweep_1flip_pallas
from rlsolver_tpu_torch.core.generate import build_complete_f32
from rlsolver_tpu_torch.core.graph import Graph
from rlsolver_tpu_torch.envs.maxcut import MaxcutEnv
from rlsolver_tpu_torch.ops import cut
from rlsolver_tpu_torch.ops.kernels import sweep_kernel as tsk

torch.set_num_threads(1)


def _topology(name):
    """(N, edges [m, 2]) of a synthetic topology or a random one."""
    rng = np.random.default_rng(len(name))
    if name == "dense40":
        a, b = np.triu_indices(40, k=1)
        keep = rng.random(a.size) < 0.7
    elif name == "isolated50":  # nodes 30..49 have no edge
        a, b = np.triu_indices(30, k=1)
        keep = rng.random(a.size) < 0.2
        return 50, np.stack([a[keep], b[keep]], 1)
    else:
        g = j_graph_from_name(name)
        return g.num_nodes, np.asarray(g.edges)
    return 40, np.stack([a[keep], b[keep]], 1)


def _graph(name, weights):
    n, edges = _topology(name)
    rng = np.random.default_rng(len(name) + len(weights))
    m = edges.shape[0]
    w = {"unit": np.ones(m), "quarters": rng.integers(1, 9, m) / 4.0,
         "random": rng.uniform(0.5, 1.5, m)}[weights].astype(np.float32)
    return Graph(n, edges.astype(np.int32), w, f"{name}_{weights}")


TOPOLOGIES = ["BA_48_ID0", "ER_32_ID1", "PL_40_ID2", "dense40", "isolated50"]
WEIGHTS = ["unit", "quarters", "random"]


def _state(g, b, seed):
    env = MaxcutEnv(g, "cpu")
    xs = torch.from_numpy(np.random.default_rng(seed).random((b, g.num_nodes)) < 0.5)
    return env, cut.signs_from_bits(xs), env.gains(xs), env.obj(xs)


def _by_lists(lists, s, gains, vs):
    """K10's arithmetic in its order, with numpy's f32 (one rounding per
    operation): per node, the accepting chains update only the gains of the
    row's listed neighbours."""
    s, g, vs = s.numpy().copy(), gains.numpy().copy(), vs.numpy().copy()
    off = lists.offsets.tolist()
    j_all = lists.entries[:, 0].numpy().astype(np.int64)
    a_all = lists.entries[:, 1].numpy().view(np.float32)
    for i in range(s.shape[1]):
        gi = g[:, i].copy()
        acc = gi > np.float32(0)
        j, a = j_all[off[i] : off[i + 1]], a_all[off[i] : off[i + 1]]
        c = (np.float32(-2) * s[acc, i])[:, None]
        g[np.ix_(acc, j)] = g[np.ix_(acc, j)] + (c * s[np.ix_(acc, j)]) * a[None, :]
        g[acc, i] = -gi[acc]
        s[acc, i] = -s[acc, i]
        vs = vs + np.where(acc, gi, np.float32(0))
    return s, g, vs


def _same(a, b, name):
    """Equal values; a zero may differ in its sign (-0 == +0)."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b), name


@pytest.mark.parametrize("weights", WEIGHTS)
@pytest.mark.parametrize("name", TOPOLOGIES)
def test_lists_expand_to_the_adjacency(name, weights):
    g = _graph(name, weights)
    adj = torch.from_numpy(g.adjacency_dense())
    lists = tsk.F32AdjLists.build(adj)
    off = lists.offsets.numpy().astype(np.int64)
    n = g.num_nodes
    assert off.shape[0] == n + 1 and off[0] == 0 and off[-1] == lists.entries.shape[0] == 2 * g.num_edges
    rows = np.repeat(np.arange(n), np.diff(off))
    j = lists.entries[:, 0].numpy()
    assert all(np.all(np.diff(j[off[i] : off[i + 1]]) > 0) for i in range(n))  # ascending j
    dense = np.zeros((n, n), np.int32)
    dense[rows, j] = lists.entries[:, 1].numpy()
    np.testing.assert_array_equal(dense, adj.numpy().view(np.int32))  # every bit
    if name == "isolated50":
        assert np.all(np.diff(off)[30:] == 0)


@pytest.mark.parametrize("weights", WEIGHTS)
@pytest.mark.parametrize("name", TOPOLOGIES)
def test_list_sweep_equals_the_plain_loop_and_pallas(name, weights):
    g = _graph(name, weights)
    env, s, gains, vs = _state(g, 64, seed=len(name))
    assert env.f32_lists is not None
    ls, lg, lvs = _by_lists(env.f32_lists, s, gains, vs)
    ps, pg, pvs = tsk.sweep_1flip_f32(env.cg.adj, s, gains, vs, env.f32_lists)  # the plain loop on the CPU
    np.testing.assert_array_equal(ls, ps.numpy())
    np.testing.assert_array_equal(lvs, pvs.numpy())
    _same(lg, pg.numpy(), "gains")
    assert (ls != s.numpy()).any()  # some chain flipped
    if weights != "random":  # bf16 holds these weights exactly
        js, jg, jvs = sweep_1flip_pallas(*(jnp.asarray(t.numpy()) for t in (env.cg.adj, s, gains, vs)),
                                         block_chains=32, interpret=True)
        np.testing.assert_array_equal(ls, np.asarray(js))
        np.testing.assert_array_equal(lvs, np.asarray(jvs))
        _same(lg, np.asarray(jg), "gains vs Pallas")


def test_complete_graph_lists_and_sweep():
    """The densest case, cut to 96 nodes: every row lists all other nodes."""
    g = build_complete_f32(96, seed=2000)
    assert g.num_edges == 96 * 95 // 2 and g.name == "K96"
    env, s, gains, vs = _state(g, 32, seed=5)
    lists = env.f32_lists
    assert torch.equal(lists.offsets, torch.arange(97, dtype=torch.int32) * 95)
    ls, lg, lvs = _by_lists(lists, s, gains, vs)
    ps, pg, pvs = tsk.sweep_1flip_f32_plain(env.cg.adj, s, gains, vs)
    np.testing.assert_array_equal(ls, ps.numpy())
    np.testing.assert_array_equal(lvs, pvs.numpy())
    _same(lg, pg.numpy(), "gains")


def test_env_builds_lists_only_for_the_f32_sweep():
    g = _graph("BA_48_ID0", "unit")
    assert MaxcutEnv(g, "cpu", packed_sweep=True).f32_lists is None  # K5 runs
    assert MaxcutEnv(g, "cpu", mode="sparse").f32_lists is None  # no dense adjacency
    assert MaxcutEnv(_graph("BA_48_ID0", "quarters"), "cpu", packed_sweep=True).f32_lists is not None
