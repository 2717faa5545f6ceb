"""MCPG and L2A on the port's training runtime (`solve_maxcut_mcpg_runner`,
`solve_maxcut_l2a_runner`), on the CPU: a run killed after a checkpoint and
resumed equals the uninterrupted run leaf for leaf, bit for bit (tensors by
value and dtype, generators by state, the rest by ==), in the budgeted and
sequential modes and with `sampler="fused"` / `sweep_mode="packed"` (the
plain versions of K3, K4 and K5 here); the metrics stream and the stop
sentinel behave as the JAX runner's (`tests/test_runner_integration.py`);
over the whole schedule each runner reaches what its solve reaches (the
same generator, drawn from in the same order: equal, not close); and the
MCPG runner's best cut on BA_100_ID0 lies within the spread of JAX's runner
over the same seeds (seeds do not carry across generators)."""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

from rlsolver_tpu.algos import mcpg as jmcpg
from rlsolver_tpu.core.generate import graph_from_name as j_graph_from_name
from rlsolver_tpu_torch.algos import l2a, mcpg
from rlsolver_tpu_torch.core.generate import graph_from_name
from rlsolver_tpu_torch.problems.objectives import obj_maxcut

torch.set_num_threads(1)

GRAPH = graph_from_name("BA_32_ID0")
# the JAX package's runner test config (tests/test_runner_integration.py:17-27)
CFG = mcpg.MCPGConfig(total_mcmc_num=16, repeat_times=4, num_ls=2, max_epoch_num=2, reset_epoch_num=12,
                      sample_epoch_num=4, warmup_ls_rounds=1, seed=3)
FAST = dict(sampler="fused", sweep_mode="packed")
L2A_CFG = l2a.L2AConfig(num_sims=16, num_repeats=2, top_k=4, num_searchers=1, seq_len=3, num_iters=4, embed_dim=16,
                        num_heads=2, pretrain_steps=10, update_times=2, ls_iters=2, ls_num_spin=2, seed=0)


def same_state(a, b):
    """(leaves, unequal leaf paths) of two training states, bit for bit."""
    if isinstance(a, torch.Generator):
        return 1, [] if torch.equal(a.get_state(), b.get_state()) else ["generator"]
    if isinstance(a, torch.Tensor):
        return 1, [] if a.dtype == b.dtype and torch.equal(a, b) else ["tensor"]
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        pairs = [(k, same_state(a[k], b[k])) for k in a]
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        names = getattr(a, "_fields", range(len(a)))
        pairs = list(zip(names, (same_state(x, y) for x, y in zip(a, b))))
    else:
        return 1, [] if a == b else ["value"]
    return sum(n for _, (n, _) in pairs), [f"{k}.{p}" for k, (_, bad) in pairs for p in bad]


def metrics(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def run_mcpg(cfg, run_dir, rounds, resume=False):
    return mcpg.solve_maxcut_mcpg_runner(GRAPH, cfg, run_dir=run_dir, total_rounds=rounds, checkpoint_every=2,
                                         resume=resume, device="cpu")


@pytest.mark.parametrize("mode", ["budgeted", "fused_packed"])
def test_mcpg_runner_kill_and_resume_equals_straight_run(tmp_path, mode):
    import dataclasses

    cfg = dataclasses.replace(CFG, **FAST) if mode == "fused_packed" else CFG
    bx_full, bv_full, full = run_mcpg(cfg, str(tmp_path / "full"), 6)
    run_mcpg(cfg, str(tmp_path / "part"), 3)  # killed after round 3 (its final checkpoint)
    bx_res, bv_res, res = run_mcpg(cfg, str(tmp_path / "part"), 6, resume=True)
    leaves, unequal = same_state(res, full)
    assert leaves == 9 and not unequal, unequal  # logits, count, mu, nu, generator, xs, vs, start rows, round
    assert res.round_idx == 6
    assert bv_res == bv_full
    np.testing.assert_array_equal(bx_res, bx_full)
    assert bv_full == obj_maxcut(bx_full.astype(np.int64), GRAPH)
    rows = metrics(str(tmp_path / "full"))
    best = [r["best_cut"] for r in rows]
    assert [r["step"] for r in rows] == list(range(1, 7)) and best == sorted(best)
    assert all("mean_cut" in r and r["samples_per_second"] > 0 for r in rows)
    # the checkpoint holds the [C, N] restart rows, not R copies of them
    assert res.start_xs.shape == (CFG.total_mcmc_num, GRAPH.num_nodes)


def test_mcpg_runner_stop_sentinel(tmp_path):
    run_dir = tmp_path / "stopped"
    run_dir.mkdir()
    (run_dir / "stop").write_text("")
    _, _, state = mcpg.solve_maxcut_mcpg_runner(GRAPH, CFG, run_dir=str(run_dir), total_rounds=50, device="cpu")
    assert state.round_idx <= 1  # stopped after the first step
    assert len(metrics(str(run_dir))) == 1


@pytest.mark.parametrize("mode", ["sequential", "fused_packed"])
def test_mcpg_runner_whole_schedule_equals_solve(tmp_path, mode):
    import dataclasses

    cfg = dataclasses.replace(CFG, **FAST) if mode == "fused_packed" else CFG
    x_solve, v_solve, ev = mcpg.solve_maxcut_mcpg(GRAPH, cfg, device="cpu")
    x_run, v_run, state = mcpg.solve_maxcut_mcpg_runner(GRAPH, cfg, run_dir=str(tmp_path), device="cpu")
    rounds = cfg.max_epoch_num * (cfg.reset_epoch_num // cfg.sample_epoch_num)
    assert state.round_idx == rounds == len(ev.records) - 1
    assert v_run == v_solve
    # the solve keeps the first best it met, the runner (as JAX's) the
    # archive's first best row at the end: the solve's best bits are among
    # the runner's incumbents, each with the best cut
    rows = [i for i, row in enumerate(state.best_xs.numpy()) if np.array_equal(row, x_solve)]
    assert rows and all(float(state.best_vs[i]) == v_solve for i in rows)
    np.testing.assert_array_equal(x_run, state.best_xs[int(torch.argmax(state.best_vs))].numpy())
    # the solve's per-round best cuts are the runner's metrics
    assert [r["best_cut"] for r in metrics(str(tmp_path))] == [v for _, v, _ in ev.records[1:]]


def test_mcpg_runner_within_jax_runner_spread(tmp_path):
    """BA_100_ID0, 2 epochs of 3 rounds at 32 x 8 chains: the port's mean
    best cut over seeds 0-2 lies within the min and max of JAX's runner
    over the same seeds."""
    cfg = dict(total_mcmc_num=32, repeat_times=8, num_ls=4, max_epoch_num=2, reset_epoch_num=12,
               sample_epoch_num=4, warmup_ls_rounds=1)
    jg, tg = j_graph_from_name("BA_100_ID0"), graph_from_name("BA_100_ID0")
    j_cuts = [jmcpg.solve_maxcut_mcpg_runner(jg, jmcpg.MCPGConfig(seed=s, **cfg), run_dir=str(tmp_path / f"j{s}"))[1]
              for s in range(3)]
    t_cuts = []
    for s in range(3):
        x, v, _ = mcpg.solve_maxcut_mcpg_runner(tg, mcpg.MCPGConfig(seed=s, **cfg), run_dir=str(tmp_path / f"t{s}"),
                                                device="cpu")
        assert v == obj_maxcut(x.astype(np.int64), tg)
        t_cuts.append(v)
    assert min(j_cuts) <= np.mean(t_cuts) <= max(j_cuts), (t_cuts, j_cuts)


def test_l2a_runner_logs_rescored_cut_and_resumes(tmp_path):
    """The JAX runner test's L2A config (tests/test_runner_integration.py:75-79):
    4 metrics rows with ppo_loss, the best cut equal to its host re-score;
    2 iterations, then a resume from the straight run's checkpoint of
    iteration 2 to 4, equal leaf for leaf."""
    import dataclasses

    full_dir = str(tmp_path / "full")
    bx, bv, full = l2a.solve_maxcut_l2a_runner(GRAPH, L2A_CFG, run_dir=full_dir, checkpoint_every=1, device="cpu")
    assert bv == obj_maxcut(bx.astype(np.int64), GRAPH)
    rows = metrics(full_dir)
    assert len(rows) == 4 and all(np.isfinite(r["ppo_loss"]) for r in rows)
    assert [r["best_cut"] for r in rows] == sorted(r["best_cut"] for r in rows)
    # killed after iteration 2: a run of 2, resumed to 4
    part_dir = str(tmp_path / "part")
    l2a.solve_maxcut_l2a_runner(GRAPH, dataclasses.replace(L2A_CFG, num_iters=2), run_dir=part_dir,
                                checkpoint_every=1, device="cpu")
    _, _, res = l2a.solve_maxcut_l2a_runner(GRAPH, L2A_CFG, run_dir=part_dir, checkpoint_every=1, resume=True,
                                            device="cpu")
    leaves, unequal = same_state(res, full)
    assert leaves > 10 and not unequal, unequal
    # and resumed from a copy of the straight run's own checkpoint of iteration 2
    copy_dir = tmp_path / "copy" / "checkpoints"
    shutil.copytree(os.path.join(full_dir, "checkpoints", "step_2"), copy_dir / "step_2")
    _, _, res2 = l2a.solve_maxcut_l2a_runner(GRAPH, L2A_CFG, run_dir=str(tmp_path / "copy"), checkpoint_every=1,
                                             resume=True, device="cpu")
    assert not same_state(res2, full)[1]
    assert [r["step"] for r in metrics(str(tmp_path / "copy"))] == [3, 4]


def test_l2a_runner_equals_solve(tmp_path):
    timings = {}
    x_solve, v_solve, ev = l2a.solve_maxcut_l2a(GRAPH, L2A_CFG, device="cpu")
    x_run, v_run, state = l2a.solve_maxcut_l2a_runner(GRAPH, L2A_CFG, run_dir=str(tmp_path), device="cpu",
                                                      timings=timings)
    assert v_run == v_solve
    np.testing.assert_array_equal(x_run, x_solve)
    assert [r["best_cut"] for r in metrics(str(tmp_path))] == [v for _, v, _ in ev.records[1:]]
    assert [len(timings[k]) for k in ("pretrain", "rollout", "ppo")] == [1, 12, 4]


RUNNERS = {
    "solve_maxcut_mcpg_runner": lambda run_dir, dev: mcpg.solve_maxcut_mcpg_runner(GRAPH, CFG, run_dir, total_rounds=1,
                                                                                   device=dev)[1],
    "solve_maxcut_l2a_runner": lambda run_dir, dev: l2a.solve_maxcut_l2a_runner(
        GRAPH, dataclasses.replace(L2A_CFG, num_iters=1, pretrain_steps=1, seq_len=1), run_dir, device=dev)[1],
}


@pytest.mark.parametrize("name", sorted(RUNNERS))
def test_runners_need_a_card_unless_cpu(tmp_path, name):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    assert RUNNERS[name](str(tmp_path / "cpu"), "cpu") is not None
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RUNNERS[name](str(tmp_path / "card"), None)
