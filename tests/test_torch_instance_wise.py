"""The instance-wise runner (`rlsolver_tpu_torch/eval/instance_wise.py`)
against `scripts/instance_wise.py`: the six instances' edges (networkx's
generators there, the port's own here; `core.generate.grid_2d_periodic_edges`
against `grid_2d_graph(periodic=True)` on more shapes), each runner's
config at every instance's N (solvers stubbed to record it; with and
without `IW_SEED`), the curve writer, the summary's text, the child
process's command line, `--inline` with resume and `--redo`, and the device
rule."""

import csv
import importlib.util
import os
import shutil
import sys

import networkx as nx
import numpy as np
import pytest
import torch

from rlsolver_tpu_torch.core.generate import grid_2d_periodic_edges
from rlsolver_tpu_torch.eval import instance_wise, quality

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")


def _load(name):
    if SCRIPTS not in sys.path:
        sys.path.insert(0, SCRIPTS)
    spec = importlib.util.spec_from_file_location(name, os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", sorted(instance_wise.INSTANCES))
def test_instances_equal_the_jax_scripts(name):
    jg, tg = _load("instance_wise").build_instance(name), instance_wise.build_instance(name)
    assert (tg.num_nodes, tg.num_edges) == (jg.num_nodes, jg.num_edges) == instance_wise.INSTANCES[name][:2]
    np.testing.assert_array_equal(tg.edges, jg.edges)  # the same edges in the same order
    np.testing.assert_array_equal(tg.weights, jg.weights)


@pytest.mark.parametrize("rows,cols", [(30, 100), (3, 3), (2, 5), (1, 4), (4, 2), (7, 3)])
def test_grid_edges_equal_networkx(rows, cols):
    gx = nx.grid_2d_graph(rows, cols, periodic=True)
    idx = {v: i for i, v in enumerate(gx.nodes)}
    assert grid_2d_periodic_edges(rows, cols) == [(idx[a], idx[b]) for a, b in gx.edges]


def norm(cfg):
    return {k: getattr(v, "value", v) for k, v in vars(cfg).items()}


class FakeGraph:
    def __init__(self, name, n):
        self.name, self.num_nodes = name, n


class Records:
    records = [(0.0, -np.inf, 0.0), (1.0, 5.0, 0.5)]


def stub(monkeypatch, pkg, rec):
    from importlib import import_module

    def solver(alg, returns):
        def fn(graph, cfg, **kw):
            kw.pop("device", None)
            rec.append((alg, graph.name, norm(cfg), {k: v for k, v in kw.items() if k in ("mode", "time_budget")}))
            if "record" in kw:
                kw["record"](0, 5.0)
            return returns
        return fn

    bits = np.zeros(4, bool)
    monkeypatch.setattr(import_module(f"{pkg}.classical.bls"), "solve_maxcut_bls", solver("bls", (bits, 5.0, [])))
    monkeypatch.setattr(import_module(f"{pkg}.algos.mcpg"), "solve_maxcut_mcpg", solver("mcpg", (bits, 5.0, Records)))
    monkeypatch.setattr(import_module(f"{pkg}.algos.l2a"), "solve_maxcut_l2a", solver("l2a", (bits, 5.0, Records)))
    monkeypatch.setattr(import_module(f"{pkg}.algos.isco"), "solve_maxcut_isco", solver("isco", (bits, 5.0)))


@pytest.mark.parametrize("seed", [None, "3"], ids=["default", "IW_SEED"])
def test_runner_configs_match(seed, tmp_path, monkeypatch):
    if seed is not None:
        monkeypatch.setenv("IW_SEED", seed)
    iw = _load("instance_wise")
    jrec, trec = [], []
    monkeypatch.setattr(iw, "OUT", str(tmp_path / "j.csv"))
    monkeypatch.setattr(quality, "rescored", lambda label, g, bits, v: float(v))
    with monkeypatch.context() as m:
        stub(m, "rlsolver_tpu", jrec)
        for name, (n, *_) in iw.INSTANCES.items():
            for alg in ("bls", "mcpg", "l2a", "isco"):
                getattr(iw, f"run_{alg}")(name, FakeGraph(name, n), 60.0)
    with monkeypatch.context() as m:
        stub(m, "rlsolver_tpu_torch", trec)
        for name, (n, *_) in instance_wise.INSTANCES.items():
            for alg, run in instance_wise.RUNNERS.items():
                run(name, FakeGraph(name, n), 60.0, out=str(tmp_path / "t.csv"), device="cpu")
    assert len(jrec) == 24 and trec == jrec
    assert open(tmp_path / "t.csv").read() == open(tmp_path / "j.csv").read()


def test_curve_writer_and_done_pairs(tmp_path):
    out = str(tmp_path / "iw.csv")
    quality.ensure_csv(out, instance_wise.HEADER)
    w = instance_wise.CurveWriter(out, "G22like", "mcpg")
    w.add(100.0)
    w.add(90.0)  # no better: not recorded
    w.add(120.0, seconds=3.0)
    rows = list(csv.reader(open(out)))
    assert rows[0] == instance_wise.HEADER and [float(r[3]) for r in rows[1:]] == [100.0, 120.0]
    assert instance_wise.done_pairs(out) == {("G22like", "mcpg")}


def test_summary_equals_the_jax_scripts(tmp_path, monkeypatch, capsys):
    path = tmp_path / "iw.csv"
    shutil.copy(os.path.join(REPO, "results_quality", "instance_wise.csv"), path)
    iw = _load("instance_wise")
    monkeypatch.setattr(iw, "OUT", str(path))
    capsys.readouterr()
    iw.summarize()
    jax_text = capsys.readouterr().out
    assert instance_wise.main(["--summarize", "--out", str(path)]) == 0
    assert capsys.readouterr().out == jax_text and "G22like" in jax_text
    instance_wise.summarize(str(path), reference=str(path))  # a curve beside itself
    extra = capsys.readouterr().out[len(jax_text):]
    assert "(final - reference at the same seconds +0.0)" in extra and "parity bar" in extra


def test_default_mode_runs_a_child_per_pair_and_inline_resumes(tmp_path, monkeypatch):
    out = str(tmp_path / "iw.csv")
    cmds = []
    monkeypatch.setattr(instance_wise.subprocess, "run",
                        lambda cmd, env=None: cmds.append((cmd, env)) or type("R", (), {"returncode": 0}))
    instance_wise.main(["--insts", "G14like,G22like", "--algs", "bls,mcpg", "--budget", "7", "--out", out,
                        "--device", "cpu", "--redo", "mcpg"])
    assert len(cmds) == 4
    cmd, env = cmds[1]
    assert cmd[:3] == [sys.executable, "-u", "-c"] and cmd[4:] == [
        "--inline", "--insts", "G14like", "--algs", "mcpg", "--budget", "7.0", "--out", os.path.abspath(out),
        "--device", "cpu", "--redo", "mcpg"]
    assert REPO in env["PYTHONPATH"].split(os.pathsep)

    runs = []

    def fake(name, g, budget, out, device):
        runs.append((name, g.num_nodes, budget, str(device)))
        instance_wise.CurveWriter(out, name, "bls").add(10.0 + len(runs), seconds=1.0)
        return 10.0 + len(runs)

    monkeypatch.setitem(instance_wise.RUNNERS, "bls", fake)
    argv = ["--insts", "G14like", "--algs", "bls", "--budget", "3", "--out", out, "--device", "cpu", "--inline"]
    instance_wise.main(argv)
    instance_wise.main(argv)  # the pair is done: no run
    instance_wise.main(argv + ["--redo", "bls"])
    assert runs == [("G14like", 800, 3.0, "cpu")] * 2
    assert [r[3] for r in csv.reader(open(out))][1:] == ["11.0", "12.0"]


def test_entry_point_needs_a_card_unless_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the rule is about its absence")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        instance_wise.main(["--insts", "G14like", "--algs", "bls", "--out", str(tmp_path / "iw.csv"), "--inline"])
