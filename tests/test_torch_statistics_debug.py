"""The port's result aggregation (`eval/statistics.py`, without pandas) and
debugging helpers (`utils/debug.py`, on torch). The rows of
`collect_results` and `comparison_table` must equal the JAX package's
pandas frames value for value and NaN for NaN (best and mean runs,
maximized and minimized, gap-to-baseline and gap-to-bound columns), and
`write_comparison_csv` must write the text pandas writes. pandas is
imported by this test only."""

import math
import os

import numpy as np
import pandas as pd
import pytest
import torch

from rlsolver_tpu.eval import statistics as jstats
from rlsolver_tpu_torch.core.result import write_graph_result
from rlsolver_tpu_torch.eval import statistics as stats
from rlsolver_tpu_torch.utils import debug


def _write(path, obj, alg, duration=10.0, bound=None, gap=None):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(f"// obj: {obj}\n// running_duration: {duration}\n// alg_name: {alg}\n")
        if bound is not None:
            f.write(f"// obj_bound: {bound}\n")
        if gap is not None:
            f.write(f"// gap: {gap}\n")
        for i in range(4):
            f.write(f"{i + 1} 1\n")


@pytest.fixture
def result_root(tmp_path):
    root = str(tmp_path / "result")
    _write(f"{root}/maxcut_greedy/BA_100_ID0_10.txt", 120, "greedy")
    _write(f"{root}/maxcut_greedy/BA_200_ID0_10.txt", 260, "greedy", duration="None")
    _write(f"{root}/maxcut_mcpg/BA_100_ID0_10.txt", 131, "mcpg")
    _write(f"{root}/maxcut_mcpg/BA_100_ID0_12.txt", 133, "mcpg")  # a second run
    _write(f"{root}/maxcut_mcpg/BA_200_ID0_10.txt", 271, "mcpg")
    _write(f"{root}/maxcut_mcpg/BA_300_ID0_10ab.txt", 0, "mcpg")  # a zero baseline-free row
    _write(f"{root}/maxcut_gurobi/BA_100_ID0_3600.txt", 132, "gurobi", bound=135, gap=0.02)
    _write(f"{root}/maxcut_gurobi/BA_200_ID0_3600.txt", 270, "gurobi", bound=280)
    _write(f"{root}/maxcut_milp/BA_100_ID0_60.txt", 128, "milp", bound=140)
    # what the port's CLI writes (an info header)
    write_graph_result(125.0, 3.0, 4, "sa", np.array([0, 1, 1, 0]), os.path.join(root, "maxcut_sa", "BA_100_ID0.txt"),
                       info={"obj_bound": 150.0, "gap": 0.2})
    os.makedirs(f"{root}/maxcut_empty")
    with open(f"{root}/maxcut_mcpg/_skipped.txt", "w") as f:
        f.write("x")
    with open(f"{root}/maxcut_mcpg/broken.txt", "w") as f:
        f.write("not a result\n")
    return root


def same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    return a == b


def frame_rows(frame: pd.DataFrame):
    """A pivoted frame as the port's rows: `instance` first, then its columns."""
    out = []
    for instance, row in frame.iterrows():
        out.append({"instance": instance, **{str(c): float(v) for c, v in row.items()}})
    return out


def assert_rows_equal(rows, want):
    assert len(rows) == len(want)
    for r, w in zip(rows, want):
        assert list(r) == list(w)
        assert all(same(r[k], w[k]) for k in w), (r, w)


def test_parse_result_filename_matches_jax():
    for name in ("BA_100_ID0_3600.txt", "gset_14_60.txt", "gset_14_60ab.txt", "plain.txt", "x_"):
        assert stats.parse_result_filename(name) == jstats.parse_result_filename(name)


def test_collect_results_rows_equal_jax_frame(result_root):
    rows = stats.collect_results(result_root)
    want = jstats.collect_results(result_root).to_dict("records")
    assert len(rows) == len(want) == 10
    for r, w in zip(rows, want):
        assert list(r) == list(w)
        assert all(same(r[k], w[k]) for k in w), (r, w)


@pytest.mark.parametrize("maximize", [True, False])
@pytest.mark.parametrize("agg", ["best", "mean"])
@pytest.mark.parametrize("baseline,bound", [(None, None), ("gurobi", None), ("gurobi", "milp"), (None, "gurobi"),
                                            ("absent", "absent")])
def test_comparison_table_equals_jax_frame(result_root, maximize, agg, baseline, bound):
    table = stats.comparison_table(stats.collect_results(result_root), baseline, maximize, agg, bound)
    want = jstats.comparison_table(jstats.collect_results(result_root), baseline, maximize, agg, bound)
    assert_rows_equal(table, frame_rows(want))
    if baseline == "gurobi" and maximize and agg == "best":
        row = table[0]
        assert row["mcpg"] == 133 and row["gap_vs_gurobi:mcpg"] < 0  # mcpg beat gurobi on BA_100
        assert table[1]["gap_vs_gurobi:greedy"] > 0


def test_comparison_table_edges():
    assert stats.comparison_table([]) == []
    with pytest.raises(ValueError, match="unknown agg"):
        stats.comparison_table([], agg="median")


def test_write_comparison_csv_writes_pandas_text(result_root, tmp_path):
    out, ref = str(tmp_path / "out" / "cmp.csv"), str(tmp_path / "ref.csv")
    rows = stats.write_comparison_csv(result_root, out, baseline_method="gurobi")
    jstats.write_comparison_csv(result_root, ref, baseline_method="gurobi")
    with open(out) as a, open(ref) as b:
        assert a.read() == b.read()
    assert_rows_equal(rows, stats.comparison_table(stats.collect_results(result_root), "gurobi"))


def test_assert_finite_walks_a_tree():
    from typing import NamedTuple

    class State(NamedTuple):
        xs: torch.Tensor
        extra: dict

    good = State(torch.ones(3), {"a": [np.zeros(2), torch.zeros(2, dtype=torch.int64)], "n": 4})
    debug.assert_finite(good)
    bad = State(torch.ones(3), {"a": [np.zeros(2), torch.tensor([0.0, float("nan")])]})
    with pytest.raises(FloatingPointError, match=r"state\.extra\['a'\]\[1\]"):
        debug.assert_finite(bad, "state")
    with pytest.raises(FloatingPointError):
        debug.assert_finite({"w": np.array([np.inf])})


def test_device_memory_str_and_profile_trace_on_cpu(tmp_path):
    assert debug.device_memory_str("cpu") == "cpu: memory stats unavailable"
    with debug.profile_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None and os.path.getsize(tmp_path / "trace" / "trace.json") > 0


def test_nan_guard_restores_anomaly_mode():
    before = torch.is_anomaly_enabled()
    with debug.nan_guard():
        assert torch.is_anomaly_enabled()
        x = torch.tensor([-1.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"), pytest.warns(UserWarning, match="Error detected"):
            torch.sqrt(x).sum().backward()
    assert torch.is_anomaly_enabled() == before
