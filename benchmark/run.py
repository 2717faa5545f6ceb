"""Runs one cell of the benchmark once and prints its result line last.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, the CUDA context, the kernels' libraries, the instance, a
warm call of the cell's entry point at the cell's shapes), then the
measured window, then the check of what the window produced against the
plain reference. With `--trace 0` the line holds the cell's end-to-end
metrics, with `--trace 1` its per-layer metrics from the traced window.
The card is required: without one, or with fewer than the cell asks for,
the run exits 3 and prints no result. It exits 4, printing no result, if
JAX, flax or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _power_limit_w():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import harness

    spec = harness.load_spec()
    chips = harness.cell_entry(spec, args.workload)["chips"]

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: cell {args.workload} needs {chips} CUDA device(s), found {have}", file=sys.stderr)
        return 3
    ctx = harness.make_context(spec, args.workload, args.seed, args.seconds, bool(args.trace), "cuda", T0)

    def device_info():
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
                "power_limit_w": _power_limit_w()}

    result = harness.execute(spec, ctx, device_info)
    found = harness.forbidden_modules()
    if found:
        print(f"benchmark: loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
