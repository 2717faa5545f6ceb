"""The port's training runtime (`train/`) and autotuner (`eval/autotune.py`):
`torch.save` checkpoints of tensors, ints, NamedTuples and generator states
that `torch.load(weights_only=True)` reads, `keep` pruning and
`select_best`, TrainLoop's metrics.jsonl, resume and stop sentinel (as the
JAX package's `tests/test_train_runtime.py` checks them), a DQN
`train_runner` killed after a checkpoint and resumed, bit for bit equal to
the straight run, and `find_best_num_sims` scoring out-of-memory as 0 and
raising on any other error."""

import json
import os
from typing import NamedTuple

import pytest
import torch

from rlsolver_tpu_torch.algos import dqn
from rlsolver_tpu_torch.config import GraphType
from rlsolver_tpu_torch.core.generate import generate_graph
from rlsolver_tpu_torch.envs.spin_system import SpinSystemConfig, SpinSystemEnv
from rlsolver_tpu_torch.eval import autotune
from rlsolver_tpu_torch.train import (CheckpointManager, LoopConfig, MetricsLogger, TrainLoop, restore_checkpoint,
                                      save_checkpoint)
from rlsolver_tpu_torch.train.checkpoint import latest_step_dir

torch.set_num_threads(1)


class Pair(NamedTuple):
    w: torch.Tensor
    count: int


def quadratic_step():
    """SGD on |w|^2; the state holds a tensor, an int, a NamedTuple and a
    generator whose draw perturbs the step."""

    def step_fn(state):
        gen = state["gen"]
        w = state["opt"].w - 0.1 * 2.0 * state["opt"].w + 1e-3 * torch.rand(3, generator=gen)
        new = {"opt": Pair(w, state["opt"].count + 1), "gen": gen, "steps": state["steps"] + [len(state["steps"])]}
        return new, {"loss": torch.sum(w * w)}

    state = {"opt": Pair(torch.tensor([1.0, -2.0, 3.0]), 0), "gen": torch.Generator().manual_seed(0), "steps": []}
    return step_fn, state


def assert_same(a, b):
    if isinstance(a, torch.Generator):
        assert isinstance(b, torch.Generator) and torch.equal(a.get_state(), b.get_state())
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    else:
        assert a == b


def test_checkpoint_roundtrip_weights_only(tmp_path):
    step_fn, state = quadratic_step()
    state, _ = step_fn(state)
    state["h"] = torch.arange(5, dtype=torch.int64)
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, state)
    raw = torch.load(os.path.join(path, "state.pt"), weights_only=True)  # plain containers only
    assert isinstance(raw["opt"], tuple) and torch.equal(raw["gen"]["__generator__"], state["gen"].get_state())
    restored = restore_checkpoint(path, like=state)
    assert_same(restored, state)
    assert isinstance(restored["opt"], Pair) and restored["gen"] is not state["gen"]
    # the restored generator continues the same stream
    assert torch.equal(torch.rand(4, generator=restored["gen"]), torch.rand(4, generator=state["gen"]))
    # dtypes and devices follow `like`
    like = dict(state, h=torch.zeros(5, dtype=torch.float32))
    assert restore_checkpoint(path, like=like)["h"].dtype == torch.float32
    plain = restore_checkpoint(path)
    assert isinstance(plain["opt"], tuple) and isinstance(plain["gen"], torch.Generator)


def test_checkpoint_refuses_unknown_types(tmp_path):
    with pytest.raises(TypeError, match="checkpoint"):
        save_checkpoint(str(tmp_path / "c"), {"x": object()})


def test_manager_retention_latest_and_select_best(tmp_path):
    _, state = quadratic_step()
    mgr = CheckpointManager(str(tmp_path / "ckpts"), save_every=2, keep=2)
    for step in (1, 2, 3, 4):
        mgr.maybe_save(step, dict(state, score=float(10 - (step - 3) ** 2)))
    assert sorted(os.listdir(tmp_path / "ckpts")) == ["step_2", "step_4"]
    for step in (3, 5):
        mgr.save(step, dict(state, score=float(10 - (step - 3) ** 2)))
    assert sorted(os.listdir(tmp_path / "ckpts")) == ["step_4", "step_5"]  # the two latest steps
    restored, step = mgr.restore_latest(like=dict(state, score=0.0))
    assert step == 5 and restored["score"] == 6.0
    best_state, best_step, score = mgr.select_best(lambda s: s["score"], like=dict(state, score=0.0))
    assert (best_step, score) == (4, 9.0) and best_state["score"] == 9.0
    assert mgr.select_best(lambda s: s["score"], maximize=False)[1] == 5
    assert latest_step_dir(str(tmp_path / "none")) is None
    assert CheckpointManager(str(tmp_path / "empty")).restore_latest() == (None, 0)


def test_loop_trains_logs_and_resumes(tmp_path):
    step_fn, state = quadratic_step()
    run_dir = str(tmp_path / "run")
    final = TrainLoop(LoopConfig(run_dir=run_dir, total_steps=5, log_every=1, checkpoint_every=2,
                                 samples_per_step=4), step_fn).run(state)
    assert (final["opt"].w.abs() < state["opt"].w.abs()).all() and final["opt"].count == 5
    lines = [json.loads(line) for line in open(os.path.join(run_dir, "metrics.jsonl"))]
    assert len(lines) == 5 and lines[-1]["step"] == 5 and lines[-1]["loss"] < lines[0]["loss"]
    assert all(line["samples_per_second"] > 0 for line in lines)
    assert sorted(os.listdir(os.path.join(run_dir, "checkpoints"))) == ["step_2", "step_4", "step_5"]

    # resume continues from the persisted step (the final save at step 5)
    final2 = TrainLoop(LoopConfig(run_dir=run_dir, total_steps=8, log_every=1, checkpoint_every=2, resume=True),
                       step_fn).run(state)
    assert final2["opt"].count == 8 and final2["steps"] == list(range(8))
    lines2 = [json.loads(line) for line in open(os.path.join(run_dir, "metrics.jsonl"))]
    assert [line["step"] for line in lines2[5:]] == [6, 7, 8]
    # the straight 8-step run is the same, draw for draw
    straight = TrainLoop(LoopConfig(run_dir=str(tmp_path / "straight"), total_steps=8, log_every=0), step_fn).run(
        quadratic_step()[1])
    assert_same(straight, final2)


def test_loop_eval_and_stop_sentinel(tmp_path):
    step_fn, state = quadratic_step()
    run_dir = str(tmp_path / "run")
    seen = []
    TrainLoop(LoopConfig(run_dir=run_dir, total_steps=4, log_every=0, eval_every=2), step_fn,
              eval_fn=lambda s, step: seen.append(step) or {"w0": s["opt"].w[0]}).run(state)
    lines = [json.loads(line) for line in open(os.path.join(run_dir, "metrics.jsonl"))]
    assert seen == [2, 4] and [line["step"] for line in lines] == [2, 4] and "eval/w0" in lines[0]

    run_dir = str(tmp_path / "stopped")
    os.makedirs(run_dir)
    open(os.path.join(run_dir, "stop"), "w").close()
    TrainLoop(LoopConfig(run_dir=run_dir, total_steps=100, log_every=1), step_fn).run(state)
    lines = [json.loads(line) for line in open(os.path.join(run_dir, "metrics.jsonl"))]
    assert len(lines) == 1  # stopped after the first step


def test_metrics_logger_print(tmp_path, capsys):
    log = MetricsLogger(str(tmp_path / "m" / "metrics.jsonl"), print_every=2)
    log.log(1, a=torch.tensor(1.5))
    log.log(2, a=2)
    log.close()
    assert "step=2" in capsys.readouterr().out
    assert [json.loads(line)["a"] for line in open(tmp_path / "m" / "metrics.jsonl")] == [1.5, 2.0]


class Killed(Exception):
    pass


def test_dqn_train_runner_resume_is_bit_exact(tmp_path):
    """Killed two steps after the checkpoint at step 6 and resumed: the
    final state equals the straight run's, params, Adam state, replay ring,
    env state and generator state included."""
    n = 20
    graph = generate_graph(GraphType.BA, n, seed=3)

    def agent():
        env = SpinSystemEnv(n, SpinSystemConfig(num_envs=4, max_steps=5, basin_reward=1 / n, stag_punishment=0.01))
        return dqn.DQNAgent(env, dqn.DQNConfig(features=8, n_layers=1, buffer_capacity=32, batch_size=8,
                                               learning_starts=8, update_frequency=2, target_update_frequency=4,
                                               eps_decay_steps=10), device="cpu")

    _, straight = agent().train_runner(graph, 12, run_dir=str(tmp_path / "straight"), log_every=4)

    crashing = agent()
    build = crashing._build_loop_step

    def build_crashing(g):
        step_fn, state = build(g)

        def crash_at_8(s, draws=None):
            if s.step_idx == 8:
                raise Killed
            return step_fn(s, draws)

        return crash_at_8, state

    crashing._build_loop_step = build_crashing
    run_dir = str(tmp_path / "run")
    with pytest.raises(Killed):
        crashing.train_runner(graph, 12, run_dir=run_dir, checkpoint_every=6, log_every=4)
    assert os.listdir(os.path.join(run_dir, "checkpoints")) == ["step_6"]
    _, resumed = agent().train_runner(graph, 12, run_dir=run_dir, checkpoint_every=6, resume=True, log_every=4)
    assert resumed.step_idx == 12 and resumed.train_steps == straight.train_steps > 0
    assert_same(resumed, straight)
    assert [json.loads(line)["step"] for line in open(os.path.join(run_dir, "metrics.jsonl"))] == [4, 8, 8, 12]


# -------------------------------------------------------------- autotune
def test_find_best_num_sims_skips_oom_and_raises_otherwise():
    import time

    def run(n):
        if n >= 256:
            raise torch.OutOfMemoryError("CUDA out of memory at this size")
        time.sleep(0.002 if n == 64 else 0.02)

    best, results = autotune.find_best_num_sims(run, candidates=(32, 64, 128, 256), reps=2)
    assert best == 64 and [n for n, _ in results] == [32, 64, 128, 256]
    assert results[3][1] == 0.0 and all(tp > 0 for _, tp in results[:3])
    assert autotune.measure_throughput(lambda n: None, 10, reps=2) > 0

    def broken(n):
        if n == 64:
            raise ValueError("not an out-of-memory error")

    with pytest.raises(ValueError, match="out-of-memory"):
        autotune.find_best_num_sims(broken, candidates=(32, 64), reps=1)
