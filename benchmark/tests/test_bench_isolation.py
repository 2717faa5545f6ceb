"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the port. Module names are compared by their
top-level name (the part before the first dot) as a whole: the port's name
begins with the JAX package's."""

import ast
import os
import subprocess
import sys
import textwrap

from benchmark import harness

REFERENCE = os.path.join(harness.BENCH_DIR, "reference")
FORBIDDEN = ("jax", "jaxlib", "flax", "rlsolver_tpu")


def _run(code: str) -> str:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=harness.ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout.strip().splitlines()[-1]


def test_harness_drivers_metrics_and_a_run_load_no_jax():
    """Imports the harness, every driver, metric and helper, then runs each
    cell's small stand-in on the CPU (the port's modules that the drivers
    load with it) in a fresh process."""
    seen = _run(f"""
        import sys, tempfile, pathlib
        sys.path.insert(0, {harness.ROOT!r})
        from benchmark import harness, counts, trace, faults, control, run
        from benchmark.tests import tiny
        names = harness.listed()
        for d in names["drivers"]:
            harness.load_module("drivers", d)
        for m in names["metrics"]:
            harness.load_module("metrics", m)
        for cell in sorted(tiny.TINY):
            tiny.run_tiny(pathlib.Path(tempfile.mkdtemp()), cell)
        print(sorted({{m.split(".")[0] for m in sys.modules}}))
    """)
    top = set(eval(seen))
    assert not top & set(FORBIDDEN), top & set(FORBIDDEN)
    assert "rlsolver_tpu_torch" in top  # the port was driven


def test_reference_imports_nothing_of_the_port():
    for name in sorted(os.listdir(REFERENCE)):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(REFERENCE, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                    else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for m in mods:
                assert m.split(".")[0] not in FORBIDDEN + ("rlsolver_tpu_torch",), (name, m)
    seen = _run(f"""
        import sys, os
        sys.path.insert(0, {harness.ROOT!r})
        import importlib
        for f in sorted(os.listdir({REFERENCE!r})):
            if f.endswith(".py") and f != "__init__.py":
                importlib.import_module("benchmark.reference." + f[:-3])
        print(sorted({{m.split(".")[0] for m in sys.modules}}))
    """)
    top = set(eval(seen))
    assert not top & set(FORBIDDEN + ("rlsolver_tpu_torch",)), top
