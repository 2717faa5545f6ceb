"""The harness finds cells, configurations, traffic mixes and metrics by
name, and a new one is added by adding files: no file that is there changes."""

import hashlib
import json
import os
import shutil

import pytest

from benchmark import harness


def _digests(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if "__pycache__" not in d:
                p = os.path.join(d, f)
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_every_name_in_the_spec_has_its_file():
    spec = harness.load_spec()
    have = harness.listed()
    for c in spec["configs"]:
        assert c["name"] in have["configs"]
        assert os.path.exists(os.path.join(harness.ROOT, c["file"]))
    for w in spec["workloads"]:
        ctx = harness.make_context(spec, w["name"], 1, 1.0, False, "cpu", 0.0)
        assert ctx.traffic["driver"] in have["drivers"]
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert m["name"] in have["metrics"]


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metric_modules_hold_only_a_reader(kind):
    """A metric's unit, layer, cells and what it moves are BENCHMARK.json's
    alone: its module holds its reader and nothing the spec says."""
    spec = harness.load_spec()
    for m in spec[kind]:
        mod = harness.load_module("metrics", m["name"])
        assert callable(mod.read)
        assert not {"UNIT", "BETTER", "SOURCE", "LAYER", "MOVES", "WORKLOADS"} & set(vars(mod))


def test_per_layer_metrics_move_a_metric_that_their_cells_report():
    spec = harness.load_spec()
    cells = {w["name"] for w in spec["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells)) for m in spec["end_to_end"]}
    layers = {}
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= e2e[m["moves"]]
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_every_cell_reports_setup_an_end_to_end_and_a_per_layer_metric():
    spec = harness.load_spec()
    for w in spec["workloads"]:
        e2e = {m["name"] for m in harness.cell_metrics(spec, w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.cell_metrics(spec, w["name"], True)


@pytest.mark.parametrize("kind", ["workloads", "configs", "traffic", "metrics"])
def test_a_new_file_is_listed_and_nothing_else_changes(tmp_path, kind):
    bench = str(tmp_path / "benchmark")
    shutil.copytree(harness.BENCH_DIR, bench, ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(bench)
    name = "new-one"
    if kind == "metrics":
        with open(os.path.join(bench, kind, f"{name}.py"), "w") as f:
            f.write('def read(r):\n    return 1.5\n')
    else:
        src = {"workloads": "g22-mcpg-fast", "configs": "gset-g22", "traffic": "mcpg-fast"}[kind]
        shutil.copy(os.path.join(bench, kind, f"{src}.json"), os.path.join(bench, kind, f"{name}.json"))
    assert name in harness.listed(bench)[kind]
    after = _digests(bench)
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {os.path.join(kind, f"{name}.json" if kind != "metrics" else f"{name}.py")}
    if kind == "metrics":
        spec = harness.load_spec()
        spec["per_layer"].append({"name": name, "unit": "%", "better": "lower", "source": "device_trace",
                                  "layer": "device", "moves": "samples_per_s", "workloads": ["g22-mcpg-fast"]})
        assert name in [m["name"] for m in harness.cell_metrics(spec, "g22-mcpg-fast", True)]
        assert harness.load_module("metrics", name, bench).read({}) == 1.5


def test_a_new_cell_is_run_from_its_files(tmp_path):
    """A cell named in a spec, with its workload file added, gets its
    context from files alone."""
    bench = str(tmp_path / "benchmark")
    shutil.copytree(harness.BENCH_DIR, bench, ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(bench, "workloads", "g22-mcpg-fast.json")) as f:
        w = json.load(f)
    with open(os.path.join(bench, "workloads", "g22-mcpg-other.json"), "w") as f:
        json.dump(w, f)
    spec = harness.load_spec()
    spec["workloads"].append({"name": "g22-mcpg-other", "config": "gset-g22", "traffic": "mcpg-fast", "chips": 1,
                              "why": "a test"})
    spec["end_to_end"][0]["workloads"].append("g22-mcpg-other")
    ctx = harness.make_context(spec, "g22-mcpg-other", 3, 1.0, False, "cpu", 0.0, bench)
    assert ctx.config["name"] == "gset-g22" and ctx.traffic["driver"] == "mcpg"
    assert [m["name"] for m in harness.cell_metrics(spec, "g22-mcpg-other", False)] == ["samples_per_s", "setup_s"]
