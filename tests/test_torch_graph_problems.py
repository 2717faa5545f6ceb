"""The CLI's graph-problem axis on the port, against the JAX package on the
CPU: the host objectives and the per-node cut primitives
(`node_cut_contrib_dense`, `apply_flip_update_gains`,
`MaxcutEnv.node_contrib`) on seeded random solutions, the graph and
instance readers and writer on files in tmp_path, the greedy MIS, MVC and
partitioning heuristics and the four colorings on BA_100_ID0..2 and
BA_1000_ID0 (host numpy on both sides: equal solutions and values), and
every `--problem mis|mvc|graph_partitioning|graph_coloring` pair of the
CLI on a 20-node graph. Integer weights throughout, so every f32 value is
exact and the tolerance is 0."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from rlsolver_tpu.classical import coloring as jcol
from rlsolver_tpu.classical import greedy as jgreedy
from rlsolver_tpu.core import io as jio
from rlsolver_tpu.core.generate import graph_from_name as j_graph_from_name
from rlsolver_tpu.core.graph import Graph as JGraph
from rlsolver_tpu.envs.maxcut import MaxcutEnv as JMaxcutEnv
from rlsolver_tpu.ops import cut as jcut
from rlsolver_tpu.problems import objectives as jobj
from rlsolver_tpu_torch.classical import coloring as col
from rlsolver_tpu_torch.classical import greedy
from rlsolver_tpu_torch.config import GraphType
from rlsolver_tpu_torch.core import io
from rlsolver_tpu_torch.core.generate import graph_from_name
from rlsolver_tpu_torch.core.graph import Graph
from rlsolver_tpu_torch.envs.maxcut import MaxcutEnv
from rlsolver_tpu_torch.ops import cut
from rlsolver_tpu_torch.problems import objectives as obj
from rlsolver_tpu_torch.run import main as cli_main

torch.set_num_threads(1)


def weighted_pair(n=40, m=160, seed=3):
    """One random graph with integer weights in +-{1..5} in both packages."""
    rng = np.random.default_rng(seed)
    edges = {}
    while len(edges) < m:
        a, b = sorted(rng.choice(n, 2, replace=False).tolist())
        edges[(a, b)] = float(rng.choice([-5, -3, -2, -1, 1, 2, 4, 5]))
    el = [(a, b, w) for (a, b), w in edges.items()]
    return JGraph.from_edge_list(n, el, name="W40"), Graph.from_edge_list(n, el, name="W40")


def pair(name):
    return (weighted_pair() if name == "weighted" else (j_graph_from_name(name), graph_from_name(name)))


def test_config_axes_match_jax():
    from rlsolver_tpu import config as jconfig

    assert [(t.name, t.value) for t in GraphType] == [(t.name, t.value) for t in jconfig.GraphType]


# ------------------------------------------------------------- objectives
@pytest.mark.parametrize("name", ["BA_100_ID0", "weighted"])
def test_graph_objectives_match_jax(name):
    jg, tg = pair(name)
    rng = np.random.default_rng(7)
    n = tg.num_nodes
    sols = [rng.integers(0, 2, n) for _ in range(20)]
    sols.append(np.r_[np.zeros(n // 2, int), np.ones(n - n // 2, int)])  # balanced
    sols.append(np.ones(n, int))  # a cover, dependent
    for x in sols:
        for jf, tf in ((jobj.obj_maxcut, obj.obj_maxcut), (jobj.obj_graph_partitioning, obj.obj_graph_partitioning),
                       (jobj.obj_minimum_vertex_cover, obj.obj_minimum_vertex_cover),
                       (jobj.obj_maximum_independent_set, obj.obj_maximum_independent_set)):
            assert tf(x, tg) == jf(x, jg)
    for k in (2, 3, 8, n):
        colors = rng.integers(0, k, n)
        assert obj.obj_graph_coloring(colors, tg) == jobj.obj_graph_coloring(colors, jg)
    colors, _ = col.dsatur(tg)
    assert obj.obj_graph_coloring(colors, tg) == jobj.obj_graph_coloring(colors, jg) > -np.inf


def test_instance_objectives_match_jax():
    rng = np.random.default_rng(11)
    subsets = tuple(tuple(sorted(set(rng.integers(1, 31, 5).tolist()))) for _ in range(25))
    j_sc, t_sc = jio.SetCoverInstance(30, subsets), io.SetCoverInstance(30, subsets)
    w, p = rng.integers(1, 20, 40).astype(np.float32), rng.integers(1, 50, 40).astype(np.float32)
    j_kp, t_kp = jio.KnapsackInstance(0, 150.0, w, p), io.KnapsackInstance(0, 150.0, w, p)
    nums = rng.integers(1, 1000, 40)
    dist = rng.uniform(0, 1, (12, 12))
    for _ in range(30):
        x = rng.integers(0, 2, 25)
        assert obj.obj_set_cover(x, t_sc) == jobj.obj_set_cover(x, j_sc)
        assert obj.obj_set_cover_ratio(x, t_sc) == jobj.obj_set_cover_ratio(x, j_sc)
        y = (rng.uniform(size=40) < 0.25).astype(int)
        assert obj.obj_knapsack(y, t_kp) == jobj.obj_knapsack(y, j_kp)
        assert obj.obj_number_partitioning(y, nums) == jobj.obj_number_partitioning(y, nums)
        tour = rng.permutation(12)
        assert obj.obj_tsp(tour, dist) == jobj.obj_tsp(tour, dist)
    assert obj.obj_set_cover(np.zeros(25, int), t_sc) == -np.inf
    assert obj.obj_set_cover(np.ones(25, int), t_sc) == jobj.obj_set_cover(np.ones(25, int), j_sc)


@pytest.mark.parametrize("name", ["BA_100_ID0", "weighted"])
def test_node_contrib_and_flip_update_match_jax(name):
    jg, tg = pair(name)
    rng = np.random.default_rng(5)
    xs = rng.integers(0, 2, (16, tg.num_nodes)).astype(bool)
    jcg = jcut.CutGraph.build(jg, dtype=jnp.float32)
    tcg = cut.CutGraph.build(tg, "cpu")
    want = np.asarray(jcut.node_cut_contrib_dense(jnp.asarray(xs), jcg))
    np.testing.assert_array_equal(cut.node_cut_contrib_dense(torch.from_numpy(xs), tcg).numpy(), want)
    # the env's dense and sparse modes give the JAX env's contributions
    for mode in ("dense", "sparse"):
        jenv = JMaxcutEnv(jg, dtype=jnp.float32, mode=mode)
        tenv = MaxcutEnv(tg, "cpu", mode=mode)
        np.testing.assert_array_equal(tenv.node_contrib(torch.from_numpy(xs)).numpy(),
                                      np.asarray(jenv.node_contrib(jnp.asarray(xs))))
    # rank-1 flips, one node after another, against JAX's
    s_j = jcut.signs_from_bits(jnp.asarray(xs), jnp.float32)
    g_j = jcut.flip_gains_dense(jnp.asarray(xs), jcg)
    s_t, g_t = cut.signs_from_bits(torch.from_numpy(xs)), cut.flip_gains_dense(torch.from_numpy(xs), tcg)
    for node in rng.integers(0, tg.num_nodes, 12).tolist():
        s_j, g_j = jcut.apply_flip_update_gains(s_j, g_j, node, jcg.adj[node])
        s_t, g_t = cut.apply_flip_update_gains(s_t, g_t, node, tcg.adj[node])
        np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
        np.testing.assert_array_equal(g_t.numpy(), np.asarray(g_j))
    # and the updated gains are the gains of the flipped state
    np.testing.assert_array_equal(g_t.numpy(), cut.flip_gains_dense(s_t > 0, tcg).numpy())


# -------------------------------------------------------------------- files
def test_write_read_graph_round_trip(tmp_path):
    _, tg = weighted_pair()
    tg = Graph(tg.num_nodes, tg.edges, np.where(np.arange(tg.num_edges) % 7 == 0, 0.5, tg.weights).astype(np.float32),
               tg.name)  # a few non-integer weights, written by repr
    path = str(tmp_path / "sub" / "W40.txt")
    io.write_graph(tg, path)
    back = io.read_graph(path)
    np.testing.assert_array_equal(back.edges, tg.edges)
    np.testing.assert_array_equal(back.weights, tg.weights)
    assert back.num_nodes == tg.num_nodes and back.name == "W40"
    jio.write_graph(JGraph(tg.num_nodes, tg.edges, tg.weights, "W40"), str(tmp_path / "jax.txt"))
    assert open(path).read() == open(str(tmp_path / "jax.txt")).read()


def test_instance_readers_match_jax(tmp_path):
    kp = tmp_path / "knap.txt"
    kp.write_text("3 4 20\n5 10\n4 40\n6 30\n3 50\n")
    sc = tmp_path / "sc.txt"
    sc.write_text("6 4\n1 2 3\n3 4\n4 5 6\n\n1 6\n")
    mk3 = tmp_path / "mk3.txt"
    mk3.write_text("4 2 95\n10 20 30 40\n1 2 3 4\n4 3 2 1\n7 6\n")
    mk2 = tmp_path / "mk2.txt"
    mk2.write_text("2 4\n10 20 30 40\n7 6\n1 2 3 4\n4 3 2 1\n95\n")
    for jf, tf, path in ((jio.read_knapsack, io.read_knapsack, kp), (jio.read_set_cover, io.read_set_cover, sc),
                         (jio.read_multiknapsack, io.read_multiknapsack, mk3),
                         (jio.read_multiknapsack, io.read_multiknapsack, mk2)):
        j, t = jf(str(path)), tf(str(path))
        for field in j.__dataclass_fields__:
            a, b = getattr(t, field), getattr(j, field)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b
    np.testing.assert_array_equal(io.read_set_cover(str(sc)).membership_matrix(),
                                  jio.read_set_cover(str(sc)).membership_matrix())
    assert io.read_multiknapsack(str(mk3)).constraints.shape == (2, 4)
    bad = tmp_path / "bad.txt"
    bad.write_text("3 3 20\n5 10\n4 40\n")
    with pytest.raises(ValueError, match="item count"):
        io.read_knapsack(str(bad))


def test_generate_knapsack_matches_jax():
    from rlsolver_tpu.core.generate import generate_knapsack as j_gen
    from rlsolver_tpu_torch.core.generate import generate_knapsack

    for n, seed in ((12, 0), (200, 5)):
        j, t = j_gen(n, seed), generate_knapsack(n, seed)
        assert (t.instance_id, t.capacity) == (j.instance_id, j.capacity)
        np.testing.assert_array_equal(t.weights, j.weights)
        np.testing.assert_array_equal(t.profits, j.profits)


# ------------------------------------------------------------------ solvers
HEURISTICS = {
    "greedy_mis": (jgreedy.greedy_mis, greedy.greedy_mis),
    "greedy_mvc": (jgreedy.greedy_mvc, greedy.greedy_mvc),
    "greedy_partitioning": (jgreedy.greedy_graph_partitioning, greedy.greedy_graph_partitioning),
    "greedy_coloring": (jcol.greedy_coloring, col.greedy_coloring),
    "welsh_powell": (jcol.welsh_powell, col.welsh_powell),
    "dsatur": (jcol.dsatur, col.dsatur),
    "rlf": (jcol.recursive_largest_first, col.recursive_largest_first),
}


@pytest.mark.parametrize("name", ["BA_100_ID0", "BA_100_ID1", "BA_100_ID2", "BA_1000_ID0"])
@pytest.mark.parametrize("alg", list(HEURISTICS))
def test_host_heuristics_match_jax(alg, name):
    jf, tf = HEURISTICS[alg]
    jg, tg = pair(name)
    (j_sol, j_val), (t_sol, t_val) = jf(jg), tf(tg)
    np.testing.assert_array_equal(t_sol, j_sol)
    assert t_sol.dtype == j_sol.dtype and t_val == j_val
    if "color" in alg or alg in ("dsatur", "rlf", "welsh_powell"):
        assert col.is_proper_coloring(tg, t_sol) and t_val == len(np.unique(t_sol))
    else:
        rescore = {"greedy_mis": obj.obj_maximum_independent_set, "greedy_mvc": obj.obj_minimum_vertex_cover,
                   "greedy_partitioning": obj.obj_graph_partitioning}[alg]
        assert rescore(t_sol.astype(np.int64), tg) == t_val > -np.inf


def test_improper_coloring_is_caught():
    _, tg = pair("BA_100_ID0")
    colors, _ = col.dsatur(tg)
    a, b = tg.edges[0]
    colors = colors.copy()
    colors[b] = colors[a]
    assert not col.is_proper_coloring(tg, colors)
    assert not col.is_proper_coloring(tg, np.full(tg.num_nodes, -1))


# ---------------------------------------------------------------------- CLI
CLI_PAIRS = [("mis", "greedy"), ("mis", "isco"), ("mis", "milp"), ("mvc", "greedy"), ("mvc", "milp"),
             ("graph_partitioning", "greedy"), ("graph_partitioning", "milp"), ("graph_coloring", "greedy"),
             ("graph_coloring", "welsh_powell"), ("graph_coloring", "dsatur"), ("graph_coloring", "rlf")]


@pytest.mark.parametrize("problem,alg", CLI_PAIRS)
def test_cli_graph_problem_pairs(problem, alg, tmp_path, capsys, monkeypatch):
    """Each pair on BA_20_ID0 written as a gset file; the CLI re-scores the
    solution (a mismatch raises) and writes the result file."""
    data = tmp_path / "data"
    io.write_graph(graph_from_name("BA_20_ID0"), str(data / "BA_20_ID0.txt"))
    if alg == "isco":  # a shorter chain than ISCO's default on one CPU thread
        from rlsolver_tpu_torch.algos import isco

        config = isco.ISCOConfig
        monkeypatch.setattr(isco, "ISCOConfig", lambda seed: config(seed=seed, batch_size=8, chain_length=50))
    assert cli_main(["--problem", problem, "--alg", alg, "--data-dir", str(data), "--write", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith(f"{alg} BA_20_ID0: obj=")
    value = float(out.split("obj=")[1].split()[0])
    assert value > -np.inf if problem != "graph_coloring" else 2 <= value <= 5
    written = list((tmp_path / "result").iterdir())
    assert len(written) == 1


def test_cli_mvc_milp_reports_the_objective(tmp_path, capsys):
    """The MVC MILP minimizes the cover's size; the CLI reports the MVC
    objective, its negative, which the re-score accepts. (The JAX CLI
    reports the size, and its re-score raises: a reference fault the port
    does not copy.)"""
    data = tmp_path / "data"
    io.write_graph(graph_from_name("BA_20_ID0"), str(data / "BA_20_ID0.txt"))
    assert cli_main(["--problem", "mvc", "--alg", "milp", "--data-dir", str(data), "--device", "cpu"]) == 0
    value = float(capsys.readouterr().out.split("obj=")[1].split()[0])
    _, greedy_value = greedy.greedy_mvc(graph_from_name("BA_20_ID0"))
    assert greedy_value <= value < 0


def test_cli_partitioning_milp_stopped_by_its_time_limit(tmp_path, capsys):
    """HiGHS stopped at 0.5 s on BA_100_ID0, far from a proof: the CLI's
    re-score (which raises on a mismatch) accepts the reported partition's
    objective."""
    data = tmp_path / "data"
    g = graph_from_name("BA_100_ID0")
    io.write_graph(g, str(data / "BA_100_ID0.txt"))
    assert cli_main(["--problem", "graph_partitioning", "--alg", "milp", "--data-dir", str(data), "--device", "cpu",
                     "--milp-time-limit", "0.5"]) == 0
    value = float(capsys.readouterr().out.split("obj=")[1].split()[0])
    assert -g.num_edges < value < 0


def test_cli_tsp_is_not_ported():
    # `--problem tsp` is ported with the JAX CLI's four algorithms; any other
    # --alg on it is not, and the message lists what is
    with pytest.raises(NotImplementedError, match="--problem tsp: nn, christofides, karp_steele, cheapest_insertion"):
        cli_main(["--problem", "tsp", "--alg", "greedy", "--graphs", "BA_20_ID0", "--device", "cpu"])
