"""The TNCO env (`envs/tnco.py`) against the JAX package's: the builders and
edge numbering equal, `node2s_to_edge_sort` equal, the three codecs bit
for bit (rank ties included), the per-step contraction counts bit for bit
on 16 random orders of two networks, log10 costs within 2e-6, the float64
twin within 1e-9 of JAX's, and the local search with JAX's draws injected:
the same accept decisions, priorities within 1 ulp."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlsolver_tpu.envs import tnco as jt
from rlsolver_tpu_torch.envs import tnco as tt

torch.set_num_threads(1)

BUILDERS = [("train", (5,)), ("ring", (4,)), ("tree", (3,)), ("tree", (4,)), ("circuit", (4, 3, 1)),
            ("circuit", (6, 5, 0)), ("circuit", (12, 14, 0))]


def build(mod, kind, args):
    fn = {"train": mod.tensor_train_nodes, "ring": mod.tensor_ring_nodes, "tree": mod.tensor_tree_nodes,
          "circuit": mod.random_circuit_nodes}[kind]
    return fn(*args)


def envs(kind, args):
    jn = jt.TensorNetwork.from_nodes_list(*build(jt, kind, args))
    tn = tt.TensorNetwork.from_nodes_list(*build(tt, kind, args))
    return jt.TncoEnv(jn), tt.TncoEnv(tn, "cpu")


def jax_sorts(jenv, seed, num):
    return np.array(jenv.random_edge_sorts(jax.random.PRNGKey(seed), num))


@pytest.mark.parametrize("kind,args", BUILDERS)
def test_builders_and_edge_numbering_equal(kind, args):
    jl, tl = build(jt, kind, args), build(tt, kind, args)
    assert jl == tl
    jn, tn = jt.TensorNetwork.from_nodes_list(*jl), tt.TensorNetwork.from_nodes_list(*tl)
    np.testing.assert_array_equal(tn.edge_nodes, jn.edge_nodes)
    assert (tn.num_bits, tn.num_bases, tn.run_edges) == (jn.num_bits, jn.num_bases, jn.run_edges)


def test_sycamore_shape():
    net = tt.TensorNetwork.from_nodes_list(*tt.random_circuit_nodes(53, 12, seed=0))
    assert (net.num_nodes, net.num_edges, net.num_bits) == (418, 677, 6770)


def test_node2s_to_edge_sort_equal():
    nodes, ban = tt.random_circuit_nodes(5, 4, seed=3)
    jn, tn = jt.TensorNetwork.from_nodes_list(nodes, ban), tt.TensorNetwork.from_nodes_list(nodes, ban)
    # a node-pair sequence over cluster representatives: contract along the
    # edge list, merging
    parent = list(range(tn.num_nodes))

    def find(x):
        while parent[x] != x:
            x = parent[x]
        return x

    node2s = []
    for a, b in tn.edge_nodes.tolist():
        ra, rb = find(a), find(b)
        if ra != rb:
            node2s.append((ra, rb))
            parent[rb] = ra
    np.testing.assert_array_equal(tn.node2s_to_edge_sort(node2s), jn.node2s_to_edge_sort(node2s))
    with pytest.raises(ValueError):
        tn.node2s_to_edge_sort(node2s[:-1])


def test_reference_loader_raises_like_jax_when_absent(tmp_path, monkeypatch):
    with pytest.raises(OSError):
        tt.load_reference_tnco_constant("NodesSycamoreN53M12", str(tmp_path / "absent.py"))
    # with no path and no $RLSOLVER_REFERENCE, nothing outside is read
    monkeypatch.delenv("RLSOLVER_REFERENCE", raising=False)
    with pytest.raises(OSError):
        tt.sycamore_network(12)
    monkeypatch.setenv("RLSOLVER_REFERENCE", str(tmp_path))
    with pytest.raises(OSError):
        tt.sycamore_network(12)
    src = tmp_path / "TNCO_env.py"
    src.write_text("import torch\nNodesX = [[1], [0]]\n")
    assert tt.load_reference_tnco_constant("NodesX", str(src)) == jt.load_reference_tnco_constant("NodesX", str(src))
    with pytest.raises(KeyError):
        tt.load_reference_tnco_constant("NodesY", str(src))


@pytest.mark.parametrize("kind,args", [("circuit", (5, 4, 2)), ("train", (6,))])
def test_codecs_bit_exact(kind, args):
    jenv, tenv = envs(kind, args)
    sorts = jax_sorts(jenv, 0, 7)
    bits = np.asarray(jenv.edge_sorts_to_bits(jnp.asarray(sorts)))
    np.testing.assert_array_equal(tenv.edge_sorts_to_bits(torch.from_numpy(sorts)).numpy(), bits)
    # random bits: ranks with ties, ordered stably
    rb = np.random.default_rng(1).random((9, tenv.num_bits)) < 0.5
    rb[:, : tenv.num_bases * 3] = False  # three edges of rank 0 in every row
    np.testing.assert_array_equal(tenv.bits_to_edge_sorts(torch.from_numpy(rb)).numpy(),
                                  np.asarray(jenv.bits_to_edge_sorts(jnp.asarray(rb))))
    # priorities with ties, and the rank priorities of the compiled JAX step
    fs = np.round(np.random.default_rng(2).random((9, tenv.run_edges)) * 4).astype(np.float32) / 4
    np.testing.assert_array_equal(tenv.priorities_to_edge_sorts(torch.from_numpy(fs)).numpy(),
                                  np.asarray(jenv.priorities_to_edge_sorts(jnp.asarray(fs))))
    np.testing.assert_array_equal(tenv.ranks_to_priorities(torch.from_numpy(sorts)).numpy(),
                                  np.asarray(jax.jit(jenv.ranks_to_priorities)(jnp.asarray(sorts))))


@pytest.mark.parametrize("kind,args", [("circuit", (6, 5, 0)), ("tree", (3,))])
def test_contraction_pow_counts_bit_exact(kind, args):
    jenv, tenv = envs(kind, args)
    sorts = jax_sorts(jenv, 3, 16)
    jp = np.asarray(jax.jit(jenv.contraction_pow_counts)(jnp.asarray(sorts)))
    tp = tenv.contraction_pow_counts(torch.from_numpy(sorts)).numpy()
    np.testing.assert_array_equal(tp, jp)
    jv = np.asarray(jax.jit(jenv.log10_multiple_times)(jnp.asarray(sorts)))
    np.testing.assert_allclose(tenv.log10_multiple_times(torch.from_numpy(sorts)).numpy(), jv, rtol=0, atol=2e-6)
    np.testing.assert_allclose(tenv.log10_multiple_times_accurate(sorts), jenv.log10_multiple_times_accurate(sorts),
                               rtol=0, atol=1e-9)
    # the bits codec end to end
    bits = np.asarray(jenv.edge_sorts_to_bits(jnp.asarray(sorts)))
    np.testing.assert_allclose(tenv.obj(torch.from_numpy(bits)).numpy(), np.asarray(jax.jit(jenv.obj)(bits)),
                               rtol=0, atol=2e-6)


def jax_ls_draws(key, num_iters, b, num_spin, run_edges):
    """The idx and standard normals `TncoEnv.local_search` draws from key."""
    idx, normal = [], []
    for k in jax.random.split(key, num_iters):
        k_idx, k_noise = jax.random.split(k)
        idx.append(jax.random.randint(k_idx, (b, num_spin), 0, run_edges))
        normal.append(jax.random.normal(k_noise, (b, num_spin)))
    return tt.LocalSearchDraws(torch.from_numpy(np.asarray(jnp.stack(idx))),
                               torch.from_numpy(np.asarray(jnp.stack(normal))))


def test_local_search_with_injected_draws():
    jenv, tenv = envs("circuit", (6, 5, 7))
    key = jax.random.PRNGKey(8)
    b, iters, spin = 16, 8, 8
    sorts = jax_sorts(jenv, 8, b)
    fs0 = np.asarray(jax.jit(jenv.ranks_to_priorities)(jnp.asarray(sorts)))
    draws = jax_ls_draws(key, iters, b, spin, jenv.run_edges)
    # the same draws with every sim's first two edges repeated: duplicate adds
    idx_dup = draws.idx.clone()
    idx_dup[:, :, 1] = idx_dup[:, :, 0]
    for d in (draws, tt.LocalSearchDraws(idx_dup, draws.normal)):
        def jax_ls(fs):
            vs = jenv.obj_priorities(fs)
            accepts = []
            for it in range(iters):
                idx = jnp.asarray(d.idx[it].numpy())
                noise = jnp.asarray(d.normal[it].numpy()) * 0.3
                fs_try = fs.at[jnp.arange(b)[:, None], idx].add(noise)
                vs_try = jenv.obj_priorities(fs_try)
                better = vs_try < vs
                accepts.append(better)
                fs = jnp.where(better[:, None], fs_try, fs)
                vs = jnp.where(better, vs_try, vs)
            return fs, vs, jnp.stack(accepts)

        jfs, jvs, jacc = (np.asarray(x) for x in jax.jit(jax_ls)(jnp.asarray(fs0)))
        tfs, tvs = tenv.local_search(None, torch.from_numpy(fs0), num_iters=iters, num_spin=spin, draws=d)
        # accepted iterations: each sim's priorities changed where JAX's did
        assert jacc.any() and not jacc.all()
        np.testing.assert_array_equal(tfs.numpy() != fs0, jfs != fs0)
        np.testing.assert_array_max_ulp(tfs.numpy(), jfs, maxulp=1)
        np.testing.assert_allclose(tvs.numpy(), jvs, rtol=0, atol=2e-6)
    # with no draws it draws from the generator and never gets worse
    gen = torch.Generator().manual_seed(0)
    fs = tenv.ranks_to_priorities(torch.from_numpy(sorts))
    v0 = tenv.obj_priorities(fs)
    fs1, v1 = tenv.local_search(gen, fs, v0, num_iters=4)
    assert (v1 <= v0).all() and (v1 < v0).any()
    np.testing.assert_allclose(tenv.obj_priorities(fs1).numpy(), v1.numpy(), atol=0)


@pytest.mark.parametrize("nodes_list,ban_edges", [tt.tensor_train_nodes(5), tt.tensor_ring_nodes(4),
                                                  tt.tensor_tree_nodes(3), tt.random_circuit_nodes(4, 3, seed=1)])
def test_banned_edges_last_and_cost_matches_jax(nodes_list, ban_edges):
    tn = tt.TensorNetwork.from_nodes_list(nodes_list, ban_edges)
    deg = np.zeros(tn.num_nodes, int)
    for a, b in tn.edge_nodes:
        deg[a] += 1
        deg[b] += 1
    for e in range(tn.run_edges, tn.num_edges):
        a, b = tn.edge_nodes[e]
        assert deg[a] == 1 or deg[b] == 1
    jenv, tenv = jt.TncoEnv(jt.TensorNetwork.from_nodes_list(nodes_list, ban_edges)), tt.TncoEnv(tn, "cpu")
    sorts = jax_sorts(jenv, 3, 4)
    np.testing.assert_array_equal(tenv.contraction_pow_counts(torch.from_numpy(sorts)).numpy(),
                                  np.asarray(jenv.contraction_pow_counts(jnp.asarray(sorts))))


def test_duplicate_edges_cost_nothing():
    # a parallel bond: the second contraction of a merged pair costs 2**0
    net = tt.TensorNetwork.from_nodes_list([[1, 2], [0, 2], [0, 1]], 0)
    env = tt.TncoEnv(net, "cpu")
    jenv = jt.TncoEnv(jt.TensorNetwork.from_nodes_list([[1, 2], [0, 2], [0, 1]], 0))
    sorts = np.array([[0, 1, 2], [2, 0, 1]])
    tp = env.contraction_pow_counts(torch.from_numpy(sorts)).numpy()
    np.testing.assert_array_equal(tp, np.asarray(jenv.contraction_pow_counts(jnp.asarray(sorts))))
    assert (tp[:, 2] == 0).all()
