"""`scripts/learned_gap.py`, the seed-gap runner of the learned cells: its
decision rule, its summary (the port's spread standing for JAX's under four
JAX seeds), its rows and resume, and arm D (the port from JAX's initial
parameters with JAX's draws injected) following JAX's whole RUN-CSP
training run at a small size, cut for cut."""

import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from rlsolver_tpu.algos import runcsp as jcsp
from rlsolver_tpu.core.generate import graph_from_name as j_graph_from_name
from rlsolver_tpu_torch.algos import runcsp as tcsp
from rlsolver_tpu_torch.core.generate import graph_from_name

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_script():
    spec = importlib.util.spec_from_file_location("learned_gap", os.path.join(REPO, "scripts", "learned_gap.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


lg = load_script()


@pytest.mark.parametrize("gap,se,expected", [(2.0, 1.0, "not a fault"), (-2.0, 1.0, "not a fault"),
                                             (2.5, 1.0, "undecided"), (-3.0, 1.0, "fault"), (0.0, 0.0, "not a fault")])
def test_verdict_rule(gap, se, expected):
    assert lg.verdict(gap, se) == expected


def test_summary_gap_and_standard_error():
    jax_means, port_means = [274.0, 276.0, 275.0, 277.0, 273.0], [273.0, 274.0, 272.0]
    r = lg.summary({"jax": jax_means, "port": port_means})
    assert r["gap"] == pytest.approx(np.mean(port_means) - np.mean(jax_means))
    se = np.sqrt(np.var(jax_means, ddof=1) / 5 + np.var(port_means, ddof=1) / 3)
    assert r["se_gap"] == pytest.approx(se) and r["se_from"] == "both"
    assert r["verdict"] == lg.verdict(r["gap"], se)
    # under four JAX seeds the port's spread stands for both sides
    r = lg.summary({"jax": jax_means[:2], "port": port_means})
    sp = np.std(port_means, ddof=1)
    assert r["se_from"] == "port" and r["se_gap"] == pytest.approx(np.sqrt(sp ** 2 / 2 + sp ** 2 / 3))
    # one side alone: no gap
    assert "gap" not in lg.summary({"jax": [], "port": port_means})


def test_rows_resume_and_pool(tmp_path, capsys):
    out = str(tmp_path / "gap.csv")
    cell = lg.cell_name("s2v", "BA", 100, None)
    assert cell == "s2v:BA_100" and lg.cell_name("runcsp", "ER", 7, 20, "D") == "runcsp:BA_100:iters20:armD"
    names = lg.instances("s2v", "BA", 100)
    assert names == [f"BA_100_ID{i}" for i in range(10)]
    for seed, base in ((0, 260.0), (1, 262.0), (2, 258.0), (3, 261.0)):
        lg.append_rows(out, cell, "jax", "cpu", seed, [(nm, base + i % 2, 1.0) for i, nm in enumerate(names)])
    lg.append_rows(out, cell, "port", "cuda", 0, [(nm, 259.0, 2.0) for nm in names])
    lg.append_rows(out, cell, "port", "cuda", 1, [(nm, 261.0, 2.0) for nm in names[:5]])  # an unfinished seed
    done = lg.read_rows(out, cell)
    assert len(done[("jax", 3)]) == 10 and len(done[("port", 1)]) == 5
    lg.main(["--cell", "s2v", "--dist", "BA", "--n", "100", "--pool", "--out", out])
    import json

    r = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert r["jax"]["per_seed"] == [260.5, 262.5, 258.5, 261.5] and r["port"]["per_seed"] == [259.0]
    assert r["cell"] == cell and r["tpu_row"] == pytest.approx(260.6)


def test_runcsp_arm_d_follows_jax_whole_run():
    """Two instances, three epochs: JAX's `RunCspSolver.train` and boosted
    predictions against the port's from the arm's JAX initial parameters and
    h0s (the script's `jax_runcsp_arm`)."""
    cfg = dict(state_size=8, iterations=4, epochs=3)
    names = lg.RUNCSP_INSTANCES[:2]
    jl, tl = jcsp.ConstraintLanguage.maxcut(), tcsp.ConstraintLanguage.maxcut()
    ji = [jcsp.CSPInstance.from_graph(j_graph_from_name(nm), jl, "NEQ") for nm in names]
    ti = [tcsp.CSPInstance.from_graph(graph_from_name(nm), tl, "NEQ") for nm in names]
    for seed in (0, 3):
        js = jcsp.RunCspSolver(jl, jcsp.RunCspConfig(seed=seed, **cfg))
        jparams, jhist = js.train(ji)
        tcfg = tcsp.RunCspConfig(seed=seed, **cfg)
        params, h0s, boost = lg.jax_runcsp_arm(seed, tcfg, "D", [i.num_vars for i in ti])
        assert len(h0s) == cfg["epochs"] * len(ti)
        ts = tcsp.RunCspSolver(tl, tcsp.RunCspConfig(seed=seed, **cfg), device="cpu")
        tparams, thist = ts.train(ti, params=params, h0s=h0s)
        np.testing.assert_allclose(thist, jhist, rtol=1e-4)
        for j_inst, t_inst in zip(ji, ti):
            for i in range(4):
                a_j = js.predict(jparams, j_inst, jax.random.PRNGKey(100 + 1000 * seed + i))
                a_t = ts.predict(tparams, t_inst, h0=boost(i, t_inst.num_vars))
                np.testing.assert_array_equal(a_t, a_j)
