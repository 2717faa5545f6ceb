"""The harness: finds a cell's files by name, runs its driver through set-up,
the measured window and the output check, and computes the metrics.

Everything that belongs to one cell, configuration, traffic mix, metric or
solver entry sits in a file of its own under `benchmark/`, found by name:

  BENCHMARK.json             the cells, metrics, bounds and `run_seconds`
  configs/<config>.json      a configuration: the instance and its source
  traffic/<traffic>.json     a traffic mix: its driver and the solver's knobs
  workloads/<cell>.json      a cell: the check's sample sizes and limits
  metrics/<metric>.py        a metric's reader (`read(readings)`); its unit,
                             layer, cells and what it moves are BENCHMARK.json's
  drivers/<driver>.py        `setup`, `window`, `check` around one entry point

so that a later cell, configuration or metric is added as new files.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import re
import sys
import time
from typing import Callable, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "rlsolver_tpu")


@dataclasses.dataclass
class Check:
    """One number the output check compares, with its limit: the run is
    correct only while value <= limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclasses.dataclass
class Context:
    workload: str
    seed: int
    seconds: float
    trace: bool
    device: str
    config: dict
    traffic: dict
    checks: dict  # the cell's workloads/<cell>.json
    t0: float  # process start on the host clock (time.perf_counter)
    root: str = BENCH_DIR


def load_spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def load_json(kind: str, name: str, bench_dir: str = BENCH_DIR) -> dict:
    with open(os.path.join(bench_dir, kind, f"{name}.json")) as f:
        return json.load(f)


def load_module(kind: str, name: str, bench_dir: str = BENCH_DIR):
    """benchmark/<kind>/<name>.py, imported by path (names may hold dots)."""
    path = os.path.join(bench_dir, kind, f"{name}.py")
    mod_name = f"benchmark._{kind}_" + re.sub(r"[^0-9A-Za-z_]", "_", name)
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def cell_entry(spec: dict, workload: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no cell named {workload!r} in BENCHMARK.json")


def listed(bench_dir: str = BENCH_DIR) -> Dict[str, List[str]]:
    """The names of every file the harness can find, by kind."""
    out = {}
    for kind, ext in (("configs", ".json"), ("traffic", ".json"), ("workloads", ".json"), ("metrics", ".py"),
                      ("drivers", ".py")):
        d = os.path.join(bench_dir, kind)
        out[kind] = sorted(f[: -len(ext)] for f in os.listdir(d) if f.endswith(ext) and not f.startswith("_"))
    return out


def cell_metrics(spec: dict, workload: str, trace: bool) -> List[dict]:
    """The metrics a run of the cell reports: with trace, the per-layer
    metrics listing the cell (or, without a `workloads` key, moving an
    end-to-end metric the cell reports); else its end-to-end metrics."""
    e2e = [m for m in spec["end_to_end"] if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)]


def forbidden_modules() -> List[str]:
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def make_context(spec: dict, workload: str, seed: int, seconds: float, trace: bool, device: str, t0: float,
                 bench_dir: str = BENCH_DIR) -> Context:
    entry = cell_entry(spec, workload)
    checks = load_json("workloads", workload, bench_dir)
    for key in ("config", "traffic"):
        if checks[key] != entry[key]:
            raise ValueError(f"workloads/{workload}.json names {key} {checks[key]!r}, BENCHMARK.json {entry[key]!r}")
    return Context(workload, seed, seconds, trace, device, load_json("configs", entry["config"], bench_dir),
                   load_json("traffic", entry["traffic"], bench_dir), checks, t0, bench_dir)


def execute(spec: dict, ctx: Context, device_info: Optional[Callable[[], dict]] = None) -> dict:
    """One run of a cell: set-up, the window (traced with ctx.trace), the
    check; returns the result line's object (with "checks" last)."""
    import torch

    from benchmark.trace import Tracer

    driver = load_module("drivers", ctx.traffic["driver"], ctx.root)
    state = driver.setup(ctx)
    if ctx.device == "cuda":
        torch.cuda.synchronize()
    readings = {"setup_s": time.perf_counter() - ctx.t0}
    if ctx.device == "cuda":
        readings["sm_count"] = torch.cuda.get_device_properties(0).multi_processor_count
    with Tracer(ctx.trace) as tracer:
        win = driver.window(state, ctx, tracer)
    readings.update(win.pop("readings"))
    readings.update(tracer.readings())
    device = device_info() if device_info is not None else {"platform": ctx.device, "count": 1}
    if ctx.device == "cuda":
        device["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())
    if ctx.trace:
        if "busy_s" not in readings:
            raise RuntimeError(f"the window of {ctx.workload} ended before its traced stretch")
        device["busy_s"], device["window_s"] = readings["busy_s"], readings["trace_window_s"]
    breakdown = readings.pop("breakdown", None)
    state.clear()  # the program's objects go before the reference runs
    del state, tracer
    gc.collect()
    if ctx.device == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = driver.check(win, ctx)
    readings["check_s"] = time.perf_counter() - t_check
    metrics = {}
    for m in cell_metrics(spec, ctx.workload, ctx.trace):
        value = load_module("metrics", m["name"], ctx.root).read(readings)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {
        "correct": bool(checks) and all(c.ok for c in checks),
        "attempted": int(readings["attempted"]),
        "failed": int(readings.get("failed", 0)),
        "metrics": metrics,
        "device": device,
    }
    if ctx.trace and breakdown is not None:
        out["breakdown"] = breakdown
    out["timing"] = {k: readings[k] for k in ("setup_s", "window_s", "check_s")}
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return out
