"""The quality harness (`rlsolver_tpu_torch/eval/{quality,eco_distribution,
quality_summary,standing_pass}.py`) against the JAX package's scripts
(`scripts/{quality_table,bound_table,eco_distribution,summarize_quality,
check_standing,violating_cells,standing_pass}.py`): every cell's config
field for field (solvers stubbed to record what they receive, at N = 100,
500, 1000 and 2000, under the default environment and under the overrides),
greedy's and HiGHS's rows equal, resume and `--redo`, the table's text and
the standing checks' output character for character, the ECO checkpoint,
the convergence pass's attempts and rows, and the device rule."""

import csv
import dataclasses
import enum
import importlib.util
import os
import pickle
import runpy
import shutil
import sys

import numpy as np
import pytest
import torch

from rlsolver_tpu_torch import convert
from rlsolver_tpu_torch.eval import eco_distribution, quality, quality_summary, standing_pass

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
OVERRIDES = {"SPECB_ITERS": "123", "SPECB_BLOCK": "8", "SPECB_CERT": "5", "ECO_STEPS": "512", "ECO_ENVS": "16",
             "JUMANJI_ITERS": "7", "ISCO_BATCH": "32"}
ALL_ALGS = "greedy,sa,ga,sdp,rw,specb,mcpg,jumanji,eco,s2v,isco,pignn,l2a"


def _load(name):
    """A JAX script as a module, its directory on the path as when run."""
    if SCRIPTS not in sys.path:
        sys.path.insert(0, SCRIPTS)
    spec = importlib.util.spec_from_file_location(name, os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def norm(x):
    """Configs as comparable plain values: dataclasses by field, enums by
    value, JAX and torch dtypes by name."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: norm(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, enum.Enum):
        return x.value
    if isinstance(x, torch.dtype):
        return str(x).replace("torch.", "")
    if isinstance(x, type):
        return np.dtype(x).name
    if isinstance(x, dict):
        return {k: norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [norm(v) for v in x]
    return x


class FakeGraph:
    def __init__(self, name, n):
        self.name, self.num_nodes = name, n


def stub_package(monkeypatch, pkg, rec):
    """Replaces the solver entry points of package `pkg` ("rlsolver_tpu" or
    "rlsolver_tpu_torch") with recorders appending to `rec`."""
    def mod(path):
        return importlib.import_module(f"{pkg}.{path}")

    def put(path, name, fn):
        monkeypatch.setattr(mod(path), name, fn)

    put("core.generate", "graph_from_name", lambda name: FakeGraph(name, int(name.split("_")[1])))
    put("core.generate", "generate_graph",
        lambda gt, n, seed=None, name="": FakeGraph(f"{norm(gt)}_{n}_seed{seed}", n))

    def per_instance(alg, *keys):
        def fn(graph, *args, **kw):
            kw.pop("device", None)
            rec.append((alg, graph.name, norm(list(args)), norm(kw)))
            return np.zeros(graph.num_nodes, bool), 1.0
        return fn

    put("classical.greedy", "greedy_maxcut", per_instance("greedy"))
    put("classical.simulated_annealing", "anneal_maxcut", per_instance("sa"))
    put("classical.genetic", "genetic_maxcut", per_instance("ga"))
    put("classical.sdp", "sdp_maxcut", per_instance("sdp"))
    put("classical.random_walk", "random_walk_maxcut", per_instance("rw"))

    def cell(alg, returns_bits=True):
        def fn(graphs, cfg, mode="dense", **kw):
            kw.pop("device", None)
            assert mode == "dense"  # the JAX cell names the dense energy; the port's cell is dense
            rec.append((alg, [g.name for g in graphs], norm(cfg), norm(kw)))
            vals = np.ones(len(graphs))
            return (np.zeros((len(graphs), graphs[0].num_nodes), bool), vals) if returns_bits else list(vals)
        return fn

    put("classical.spectral_bound", "maxcut_upper_bound_cell", cell("specb", returns_bits=False))
    put("algos.isco", "solve_maxcut_isco_cell", cell("isco"))
    put("algos.pignn", "solve_maxcut_pignn_cell", cell("pignn"))

    def mcpg(graphs, cfg, **kw):
        kw.pop("device", None)
        rec.append(("mcpg", [g.name for g in graphs], norm(cfg), norm(kw)))
        return np.zeros((len(graphs), graphs[0].num_nodes), bool), np.ones(len(graphs)), []

    put("algos.mcpg_batch", "solve_maxcut_mcpg_batched", mcpg)

    def l2a_train(cfg, **kw):
        rec.append(("l2a_train", norm(cfg)))
        return "bundle"

    def l2a_eval(bundle, graphs, **kw):
        kw.pop("device", None)
        want_xs = kw.pop("return_xs", False)
        rec.append(("l2a_eval", bundle, [g.name for g in graphs], norm(kw)))
        vals = np.ones(len(graphs))
        return (vals, np.zeros((len(graphs), graphs[0].num_nodes), bool)) if want_xs else vals

    put("algos.l2a_distribution", "train_l2a_distribution", l2a_train)
    put("algos.l2a_distribution", "evaluate_l2a_packed", l2a_eval)

    class Env:
        def __init__(self, n, config):
            self.n, self.config = n, config

    put("envs.spin_system", "SpinSystemEnv", Env)

    def ppo_train(env, graph, cfg, **kw):
        rec.append(("jumanji_train", env.n, norm(env.config), graph.name, norm(cfg)))
        return "params", {}

    def evaluator(env, net):
        rec.append(("jumanji_evaluator", env.n, norm(env.config)))

        def ev(params, graph):
            rec.append(("jumanji_eval", params, graph.name))
            return 1.0
        ev.last_state = None
        return ev

    put("algos.jumanji_ppo", "train_spin_ppo", ppo_train)
    put("algos.jumanji_ppo", "make_greedy_evaluator", evaluator)
    put("algos.jumanji_ppo", "MPNNActorCritic", lambda *a, **k: None)

    class Agent:
        def __init__(self, env, cfg, device=None):
            self.last_eval_state = None
            rec.append(("dqn_agent", env.n, norm(env.config), norm(cfg)))

        def train_scan(self, graph, steps):
            rec.append(("dqn_train", graph.name, steps))
            return "params", 1.0, None

        def train_scan_select(self, pool, steps, val, num_segments=16, verbose=False):
            rec.append(("dqn_select", [g.name for g in pool], steps, [g.name for g in val], num_segments))
            return {"node_init.kernel": torch.ones(2, 3)} if pkg.endswith("torch") else {"params": {}}, []

        def evaluate_scan(self, params, graph):
            rec.append(("dqn_eval", graph.name))
            return 1.0

    put("algos.dqn", "DQNAgent", Agent)


def record_port(monkeypatch, rec):
    stub_package(monkeypatch, "rlsolver_tpu_torch", rec)
    monkeypatch.setattr(quality, "rescored", lambda label, g, bits, v: float(v))
    monkeypatch.setattr(quality, "state_bits", lambda state: None)


def run_jax_script(monkeypatch, name, argv):
    mod = _load(name)
    monkeypatch.setattr(sys, "argv", [name] + argv)
    return mod


@pytest.mark.parametrize("env", [{}, OVERRIDES], ids=["defaults", "overrides"])
def test_quality_table_protocols_match(env, tmp_path, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    argv = ["--sizes", "100,500,1000,2000", "--dists", "BA,PL", "--algs", ALL_ALGS, "--ids", "2"]
    jrec, trec = [], []
    with monkeypatch.context() as m:
        stub_package(m, "rlsolver_tpu", jrec)
        qt = run_jax_script(m, "quality_table", argv + ["--out", str(tmp_path / "j.csv")])
        qt.main()
    with monkeypatch.context() as m:
        record_port(m, trec)
        quality.main(argv + ["--out", str(tmp_path / "t.csv"), "--device", "cpu"])
    assert len(jrec) > 100
    assert trec == jrec
    # every cell wrote its rows, obj and id equal
    rows = [[r[:5] for r in csv.reader(open(tmp_path / f))] for f in ("j.csv", "t.csv")]
    assert rows[0] == rows[1]


def test_greedy_rows_resume_and_redo(tmp_path, monkeypatch):
    argv = ["--sizes", "30", "--dists", "BA,ER,PL", "--algs", "greedy", "--ids", "2"]
    qt = run_jax_script(monkeypatch, "quality_table", argv + ["--out", str(tmp_path / "j.csv"), "--cpu"])
    qt.main()
    out = str(tmp_path / "t.csv")
    quality.main(argv + ["--out", out, "--device", "cpu"])
    jrows, trows = (list(csv.reader(open(p))) for p in (tmp_path / "j.csv", out))
    assert trows[0] == jrows[0] == quality.HEADER
    assert [r[:5] for r in trows[1:]] == [r[:5] for r in jrows[1:]] and len(trows) == 7
    before = open(out).read()
    quality.main(argv + ["--out", out, "--device", "cpu"])
    assert open(out).read() == before  # a complete cell runs no more
    quality.main(argv + ["--out", out, "--device", "cpu", "--redo", "greedy"])
    again = list(csv.reader(open(out)))
    assert again[: len(trows)] == trows and [r[:5] for r in again[len(trows):]] == [r[:5] for r in trows[1:]]


def test_bound_table_rows_match(tmp_path, monkeypatch):
    argv = ["--sizes", "20", "--dists", "BA", "--ids", "2", "--time-limit", "5"]
    bt = run_jax_script(monkeypatch, "bound_table", argv + ["--out", str(tmp_path / "j.csv")])
    bt.main()
    quality.bound_main(argv + ["--out", str(tmp_path / "t.csv")])
    jrows = [r[:5] for r in csv.reader(open(tmp_path / "j.csv")) if r[0] != "dist"]
    trows = [r[:5] for r in csv.reader(open(tmp_path / "t.csv")) if r[0] != "dist"]
    assert trows == jrows and [r[3] for r in trows] == ["milp", "milp_bound"] * 2


def test_context_lost_exits_17_and_other_errors_move_on(tmp_path, monkeypatch):
    calls = []

    def cell(alg, dist, n, graphs, ids, device, pignn_seed):
        calls.append(alg)
        if alg == "sa":  # torch's text for a failed capture names device-side assertions: the context lives on
            raise RuntimeError("CUDA error: operation failed due to a previous error during capture\nCompile with "
                               "`TORCH_USE_CUDA_DSA` to enable device-side assertions.\n")
        if alg == "ga":
            raise RuntimeError("CUDA error: an illegal memory access was encountered")
        return [1.0] * len(ids), [0.0] * len(ids)

    monkeypatch.setattr(quality, "run_cell", cell)
    with pytest.raises(SystemExit) as e:
        quality.main(["--sizes", "20", "--dists", "BA", "--algs", "greedy,sa,ga,rw", "--ids", "1", "--out",
                      str(tmp_path / "t.csv"), "--device", "cpu"])
    assert e.value.code == quality.EXIT_CONTEXT_LOST == 17
    assert calls == ["greedy", "sa", "ga"]
    assert quality.existing_rows(str(tmp_path / "t.csv")) == {("BA", 20, 0, "greedy")}


@pytest.fixture
def quality_copy(tmp_path):
    d = tmp_path / "results_quality"
    d.mkdir()
    for f in ("dist_table.csv", "boost_log.csv"):
        shutil.copy(os.path.join(REPO, "results_quality", f), d / f)
    return d


def test_render_equals_the_jax_summary(quality_copy, monkeypatch):
    sq = _load("summarize_quality")
    monkeypatch.chdir(quality_copy.parent)  # the JAX script reads results_quality/boost_log.csv from here
    monkeypatch.setattr(sq, "IN", str(quality_copy / "dist_table.csv"))
    monkeypatch.setattr(sq, "OUT", str(quality_copy / "jax.md"))
    sq.main()
    text = quality_summary.render(str(quality_copy / "dist_table.csv"))
    assert text == open(quality_copy / "jax.md").read()
    assert "Convergence-pass protocol" in text and "## PL" in text
    with_device = quality_summary.render(str(quality_copy / "dist_table.csv"), "NVIDIA H100 80GB HBM3, 700.00 W")
    assert with_device.replace("Device: NVIDIA H100 80GB HBM3, 700.00 W.\n\n", "") == text


def test_standing_checks_equal_the_jax_scripts(quality_copy, monkeypatch, capsys):
    path = str(quality_copy / "dist_table.csv")
    cs = _load("check_standing")
    monkeypatch.setattr(cs, "IN", path)
    capsys.readouterr()
    jrc, jout = cs.main(), capsys.readouterr().out
    trc, tout = quality_summary.check_standing(path), capsys.readouterr().out
    assert (trc, tout) == (jrc, jout) and "failing cells" in tout
    monkeypatch.chdir(quality_copy.parent)
    runpy.run_path(os.path.join(SCRIPTS, "violating_cells.py"))
    assert quality_summary.violating_cells(path) + "\n" == capsys.readouterr().out


def test_compare_reads_first_and_last_runs(tmp_path):
    ref, ours = tmp_path / "ref.csv", tmp_path / "ours.csv"
    with open(ref, "w") as f:
        f.write("dist,n,id,alg,obj,seconds\nBA,20,0,sa,10.0,1\nBA,20,1,sa,20.0,1\nBA,20,0,sa,30.0,1\n")
    with open(ours, "w") as f:
        f.write("dist,n,id,alg,obj,seconds\nBA,20,0,sa,9.9,2\nBA,20,1,sa,19.0,4\nBA,20,0,specb,40.0,1\n")
    lines = quality_summary.compare(str(ours), str(ref))
    assert lines[0] == ("BA_20 sa: mean 14.45 over 2 (3.0 s an instance); reference first run 15.00 (-3.67%), "
                        "last run 25.00 (-42.20%); >= first run - 1%: FAILS")
    assert lines[1].endswith("at least every known cut: holds")  # the bound 40 is above every cut, 30


def eco_argv(tmp_path, sizes="100,600"):
    return ["--dists", "BA,ER", "--sizes", sizes, "--ids", "2", "--loop-steps", "1000", "--pool", "3",
            "--segments", "2"]


def test_eco_distribution_protocol_matches(tmp_path, monkeypatch):
    jrec, trec = [], []
    (tmp_path / "results_quality").mkdir()
    with monkeypatch.context() as m:
        stub_package(m, "rlsolver_tpu", jrec)
        ed = run_jax_script(m, "eco_distribution", eco_argv(tmp_path))
        m.chdir(tmp_path)  # no committed network here: the training path
        m.setattr(ed, "OUT", str(tmp_path / "j.csv"))
        m.setattr(ed, "DONE", str(tmp_path / "j_done.txt"))
        ed.main()
    with monkeypatch.context() as m:
        record_port(m, trec)
        eco_distribution.main(eco_argv(tmp_path) + ["--out", str(tmp_path / "t.csv"), "--device", "cpu",
                                                    "--ckpt", str(tmp_path / "t_{dist}.pkl")])
    assert len(jrec) == 2 * (1 + 1 + 2 * (1 + 2))
    assert trec == jrec
    assert open(tmp_path / "t_eco_done.txt").read() == open(tmp_path / "j_done.txt").read() == \
        "BA 100\nBA 600\nER 100\nER 600\n"
    for dist in ("BA", "ER"):  # the networks written load back leaf for leaf
        back = eco_distribution.load_params(str(tmp_path / f"t_{dist}.pkl"), "cpu")
        assert list(back) == ["node_init.kernel"] and torch.equal(back["node_init.kernel"], torch.ones(2, 3))


def test_eco_distribution_infers_with_a_committed_network(tmp_path, monkeypatch):
    from rlsolver_tpu_torch.algos import dqn

    ckpt = tmp_path / "eco_params_BA.pkl"
    shutil.copy(os.path.join(REPO, "results_quality", "eco_params_BA.pkl"), ckpt)

    def no_training(*a, **k):
        raise AssertionError("a present checkpoint must not be trained anew")

    monkeypatch.setattr(dqn.DQNAgent, "train_scan_select", no_training)
    out = tmp_path / "t.csv"
    eco_distribution.main(["--dists", "BA", "--sizes", "20", "--ids", "2", "--out", str(out), "--device", "cpu",
                           "--ckpt", str(tmp_path / "eco_params_{dist}.pkl")])
    rows = list(csv.DictReader(open(out)))
    assert [(r["dist"], r["n"], r["id"], r["alg"]) for r in rows] == [("BA", "20", "0", "eco"), ("BA", "20", "1", "eco")]
    assert all(float(r["obj"]) > 0 for r in rows)
    assert open(tmp_path / "t_eco_done.txt").read() == "BA 20\n"
    # the committed tree, written back by the port, loads leaf for leaf
    params = eco_distribution.load_params(str(ckpt), "cpu")
    eco_distribution.save_params(params, str(tmp_path / "again.pkl"))
    back = eco_distribution.load_params(str(tmp_path / "again.pkl"), "cpu")
    assert list(back) == list(params) and all(torch.equal(back[k], params[k]) for k in params)
    with open(tmp_path / "again.pkl", "rb") as f:
        tree = pickle.load(f)
    assert sorted(tree["params"]) == sorted(convert.load_flax_pickle(str(ckpt))["params"])


def standing_stub(rec):
    def run(alg):
        def fn(dist, n, ids, seed, *args):
            rec.append((alg, dist, n, seed))
            return [float(100 + (seed * 7 + i * 3 + len(alg)) % 5) for i in range(ids)], 2.5
        return fn
    return run


def test_standing_pass_attempts_and_improvements(tmp_path, monkeypatch):
    argv = ["--cells", "BA:20,PL:30", "--ids", "3", "--attempts", "3"]
    for side in ("j", "t"):
        d = tmp_path / side
        d.mkdir()
        with open(d / "dist_table.csv", "w") as f:
            f.write("dist,n,id,alg,obj,seconds\nBA,20,0,l2a,102.0,1.0\nBA,20,1,mcpg,101.0,1.0\n")
    jrec, trec = [], []
    sp = run_jax_script(monkeypatch, "standing_pass", argv)
    monkeypatch.setattr(sp, "OUT", str(tmp_path / "j" / "dist_table.csv"))
    monkeypatch.setattr(sp, "BOOST_LOG", str(tmp_path / "j" / "boost_log.csv"))
    for alg in ("l2a", "mcpg"):
        monkeypatch.setattr(sp, f"run_{alg}", standing_stub(jrec)(alg))
        monkeypatch.setitem(standing_pass.RUNNERS, alg, standing_stub(trec)(alg))
    sp.main()
    standing_pass.main(argv + ["--out", str(tmp_path / "t" / "dist_table.csv"), "--device", "cpu"])
    assert trec == jrec and len(trec) == 2 * 3 * 2
    for f in ("dist_table.csv", "boost_log.csv"):
        assert open(tmp_path / "t" / f).read() == open(tmp_path / "j" / f).read()
    log = list(csv.DictReader(open(tmp_path / "t" / "boost_log.csv")))
    assert len(log) == 12 and {r["alg"] for r in log} == {"l2a", "mcpg"}
    best: dict = {}
    for r in list(csv.reader(open(tmp_path / "t" / "dist_table.csv")))[1:]:
        key = (r[0], r[1], r[2], r[3])
        assert key not in best or float(r[4]) > best[key]  # only improvements are appended
        best[key] = float(r[4])


def test_standing_pass_cells_use_the_quality_protocols(tmp_path, monkeypatch):
    argv = ["--cells", "ER:300", "--ids", "2", "--attempts", "2"]
    jrec, trec = [], []
    with monkeypatch.context() as m:
        stub_package(m, "rlsolver_tpu", jrec)
        sp = run_jax_script(m, "standing_pass", argv)
        m.setattr(sp, "OUT", str(tmp_path / "j.csv"))
        m.setattr(sp, "BOOST_LOG", str(tmp_path / "j_boost.csv"))
        open(tmp_path / "j.csv", "w").close()
        sp.main()
    with monkeypatch.context() as m:
        record_port(m, trec)
        standing_pass.main(argv + ["--out", str(tmp_path / "t.csv"), "--device", "cpu"])
    assert len(jrec) == 6 and trec == jrec


@pytest.mark.parametrize("entry", [
    lambda tmp: quality.main(["--sizes", "20", "--algs", "greedy", "--out", str(tmp / "q.csv")]),
    lambda tmp: eco_distribution.main(["--sizes", "20", "--out", str(tmp / "e.csv")]),
    lambda tmp: standing_pass.main(["--cells", "BA:20", "--out", str(tmp / "s.csv")]),
], ids=["quality", "eco_distribution", "standing_pass"])
def test_entry_points_need_a_card_unless_cpu(entry, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the rule is about its absence")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry(tmp_path)
