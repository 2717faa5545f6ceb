"""Each driver at a small size on the CPU: the reference agrees with the
port's plain path (`correct`), the control (the reference at bfloat16 in
the program's place) does not, and every fault planted underneath the
timed path turns `correct` false."""

import pytest
import torch

from benchmark import control, faults, harness
from benchmark.tests import tiny

CELLS = sorted(tiny.TINY)


def _driver(cell):
    spec = harness.load_spec()
    return harness.load_json("traffic", harness.cell_entry(spec, cell)["traffic"])["driver"]


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_port(tmp_path, cell):
    out = tiny.run_tiny(tmp_path, cell)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert set(out) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert "setup_s" in out["metrics"] and len(out["metrics"]) >= 2


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(tmp_path, cell):
    spec, bench = tiny.tiny_bench(tmp_path, cell)
    r = control.readings(spec, cell, 2**31 + 13, 1.0, torch.bfloat16, "cpu", bench)
    limits = harness.load_json("workloads", cell, bench)
    assert all(v <= limits.get(k, 0) for k, v in r["program"].items()), r["program"]
    assert any(v > limits.get(k, 0) for k, v in r["control"].items()), r["control"]


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS
                                        for f in harness.load_module("drivers", _driver(c)).FAULTS])
def test_a_planted_fault_fails(tmp_path, cell, fault):
    with faults.plant(_driver(cell), fault):
        out = tiny.run_tiny(tmp_path, cell)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reads_its_stretch(tmp_path, cell):
    """A traced run opens and closes its fixed stretch inside the window and
    reports the device's busy time and the stretch's length."""
    out = tiny.run_tiny(tmp_path, cell, seconds=3.0, trace=True)
    assert out["correct"], out["checks"]
    assert out["device"]["window_s"] > 0 and out["device"]["busy_s"] >= 0
    names = {m["name"] for m in harness.cell_metrics(harness.load_spec(), cell, True)}
    assert {k for k in names if k.startswith("idle_pct")} <= set(out["metrics"]) <= names
