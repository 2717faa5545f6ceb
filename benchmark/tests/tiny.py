"""Small stand-ins of the benchmark's cells, for the tests on the CPU."""

import json
import os
import shutil
import time

# Per cell: (config, traffic, workload) keys replaced; the cell's own limits kept.
TINY = {
    "g22-mcpg-fast": (
        {"graph": {"generator": "gnm", "num_nodes": 64, "num_edges": 256, "seed": 1}},
        {"overrides": {"total_mcmc_num": 16, "repeat_times": 4, "num_ls": 2}},
        {"sampled_rows": 8}),
    "ba1000-mcpg-batch": (
        {"graph": {"generator": "ba", "num_nodes": 48, "m": 4}, "instances": [0, 1, 2]},
        {"overrides": {"total_mcmc_num": 8, "repeat_times": 4, "num_ls": 2, "max_epoch_num": 2, "reset_epoch_num": 16}},
        {}),
    "ba1000-l2a-train": (
        {"graph": {"generator": "ba", "num_nodes": 40, "m": 4}},
        {"overrides": {"num_sims": 16, "pretrain_steps": 5}},
        {}),
}


def tiny_bench(tmp_path, cell: str):
    """A copy of benchmark/ whose files for `cell` are its small stand-in;
    returns (spec, bench_dir)."""
    from benchmark import harness

    bench = str(tmp_path / "benchmark")
    shutil.copytree(harness.BENCH_DIR, bench, ignore=shutil.ignore_patterns("__pycache__"))
    spec = harness.load_spec()
    entry = harness.cell_entry(spec, cell)
    cfg_over, traffic_over, work_over = TINY[cell]
    for kind, name, over in (("configs", entry["config"], cfg_over), ("traffic", entry["traffic"], traffic_over),
                             ("workloads", cell, work_over)):
        path = os.path.join(bench, kind, f"{name}.json")
        with open(path) as f:
            d = json.load(f)
        for k, v in over.items():  # a dict (a graph, the solver's overrides) is merged into the file's
            d[k] = {**d[k], **v} if isinstance(v, dict) and k in d else v
        with open(path, "w") as f:
            json.dump(d, f)
    return spec, bench


def run_tiny(tmp_path, cell: str, seed: int = 2**31 + 11, seconds: float = 1.0, trace: bool = False):
    from benchmark import harness

    spec, bench = tiny_bench(tmp_path, cell)
    ctx = harness.make_context(spec, cell, seed, seconds, trace, "cpu", time.perf_counter(), bench)
    return harness.execute(spec, ctx)
