"""Readings that the check's limits are set from: for each seed, one run of
the cell's window and its check, then the control, the reference computed
at a lower precision and put in the program's place, judged by the same
comparison. Prints one JSON line a seed.

    python3 benchmark/control.py --workload <cell> --seeds 11 12 13 --seconds 4 [--dtype bfloat16]
        [--fault <name>]

The program's numbers over a dozen seeds or more give each limit's lower
reading, the control's its upper one (PERF.md lists both). With --fault,
the program runs with that fault planted (`faults.py`) and its numbers are
the fault's readings. The benchmark's own runs never run either.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def readings(spec: dict, workload: str, seed: int, seconds: float, dtype, device: str = "cuda",
             bench_dir: str = None, fault: str = None) -> dict:
    """{"program": {name: value}, "control": {name: value}} of one seed
    (no control with a fault)."""
    import contextlib

    import torch

    from benchmark import faults, harness
    from benchmark.trace import Tracer

    kw = {} if bench_dir is None else {"bench_dir": bench_dir}
    ctx = harness.make_context(spec, workload, seed, seconds, False, device, time.perf_counter(), **kw)
    driver = harness.load_module("drivers", ctx.traffic["driver"], ctx.root)
    state = driver.setup(ctx)
    planted = faults.plant(ctx.traffic["driver"], fault) if fault else contextlib.nullcontext()
    with planted, Tracer(False) as tracer:
        win = driver.window(state, ctx, tracer)
    state.clear()
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    program = {c.name: c.value for c in driver.check(win, ctx)}
    if fault:
        return {"seed": seed, "fault": fault, "program": program}
    control = {c.name: c.value for c in driver.check(win, ctx, control_dtype=dtype)}
    return {"seed": seed, "program": program, "control": control}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    spec = harness.load_spec()
    for seed in args.seeds:
        print(json.dumps(readings(spec, args.workload, seed, args.seconds, getattr(torch, args.dtype),
                                  fault=args.fault)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
