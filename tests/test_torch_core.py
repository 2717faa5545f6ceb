"""Port parity, host side: graphs, generators, gset reader, codec, result
files and the host objective of `rlsolver_tpu_torch` against `rlsolver_tpu`."""

import numpy as np
import pytest
import torch

from rlsolver_tpu.core import encode as j_encode
from rlsolver_tpu.core import generate as j_generate
from rlsolver_tpu.core import io as j_io
from rlsolver_tpu.core import result as j_result
from rlsolver_tpu.problems import objectives as j_obj
from rlsolver_tpu_torch.core import encode as t_encode
from rlsolver_tpu_torch.core import generate as t_generate
from rlsolver_tpu_torch.core import io as t_io
from rlsolver_tpu_torch.core import result as t_result
from rlsolver_tpu_torch.problems import objectives as t_obj

torch.set_num_threads(1)

NAMES = ["BA_100_ID0", "BA_64_ID7", "ER_64_ID1", "ER_30_ID4", "PL_40_ID2", "PL_200_ID5"]


@pytest.mark.parametrize("name", NAMES)
def test_synthetic_graphs_match(name):
    jg, tg = j_generate.graph_from_name(name), t_generate.graph_from_name(name)
    assert tg.num_nodes == jg.num_nodes and tg.name == jg.name
    np.testing.assert_array_equal(tg.edges, jg.edges)
    np.testing.assert_array_equal(tg.weights, jg.weights)
    np.testing.assert_array_equal(tg.adjacency_dense(), jg.adjacency_dense())
    np.testing.assert_array_equal(tg.weighted_degrees(), jg.weighted_degrees())
    np.testing.assert_array_equal(tg.degree_sorted_nodes(), jg.degree_sorted_nodes())
    for a, b in zip(tg.edge_arrays(), jg.edge_arrays()):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tg.padded_neighbors(), jg.padded_neighbors()):
        np.testing.assert_array_equal(a, b)


def test_g22_like_equals_networkx_gnm():
    import networkx as nx

    g = t_generate.build_g22_like()
    ref = nx.gnm_random_graph(2000, 19990, seed=22)
    assert g.num_nodes == 2000 and g.num_edges == 19990
    assert set(map(tuple, g.edges.tolist())) == {(min(u, v), max(u, v)) for u, v in ref.edges}
    assert np.all(g.weights == 1.0)


def _write_gset(path):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(
        "// a comment line\n6 7\n1 2 1\n1 3 -1\n2 4 3\n3 4\n4 5 1\n5 6 -2\n2 1 5\n"
    )
    return str(path)


def test_gset_reader_and_listing_match(tmp_path):
    f = _write_gset(tmp_path / "data" / "gset_test.txt")
    (tmp_path / "data" / "other.txt").write_text("2 1\n1 2 1\n")
    jg, tg = j_io.read_graph(f), t_io.read_graph(f)
    assert tg.name == jg.name and tg.num_nodes == jg.num_nodes
    np.testing.assert_array_equal(tg.edges, jg.edges)
    np.testing.assert_array_equal(tg.weights, jg.weights)
    d = str(tmp_path / "data")
    assert t_io.list_graph_files(d, ["gset"]) == j_io.list_graph_files(d, ["gset"])
    assert t_io.list_graph_files(d, [""]) == j_io.list_graph_files(d, [""])


@pytest.mark.parametrize("n", [1, 6, 14, 100, 800])
def test_solution_codec_strings_match(n):
    bits = np.random.default_rng(n).random(n) < 0.5
    s = t_encode.SolutionCodec(n).bits_to_str(bits)
    assert s == j_encode.SolutionCodec(n).bits_to_str(bits)
    np.testing.assert_array_equal(t_encode.SolutionCodec(n).str_to_bits(s), bits)


def test_result_files_match(tmp_path):
    sol = (np.random.default_rng(3).random(20) < 0.5).astype(np.int64)
    paths = []
    for mod, sub in ((j_result, "j"), (t_result, "t")):
        inst = str(tmp_path / sub / "data" / "BA_20_ID0.txt")
        paths.append(mod.write_graph_result(41.0, 1.5, 20, "mcpg", sol, inst, info={"k": 2}))
    assert paths[0].replace("/j/", "/t/") == paths[1]
    with open(paths[0]) as a, open(paths[1]) as b:
        assert a.read() == b.read()
    header, labels = t_result.read_graph_result(paths[1])
    assert header["obj"] == "41.0"
    np.testing.assert_array_equal(labels, sol)


@pytest.mark.parametrize("name", ["BA_100_ID0", "ER_64_ID1"])
def test_host_objective_matches(name):
    jg, tg = j_generate.graph_from_name(name), t_generate.graph_from_name(name)
    rng = np.random.default_rng(5)
    for _ in range(4):
        x = (rng.random(jg.num_nodes) < 0.5).astype(np.int64)
        assert t_obj.obj_maxcut(x, tg) == j_obj.obj_maxcut(x, jg)
