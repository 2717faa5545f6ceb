"""The port stands alone: importing every module of `rlsolver_tpu_torch`
loads no JAX, no pandas and no networkx (the card's machine has neither)
and nothing of `rlsolver_tpu`, and no source of the port (nor
`chip_smoke.py`) names them."""

import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "rlsolver_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "networkx", "pandas", "rlsolver_tpu")

_PROBE = r"""
import importlib, pkgutil, sys
before = set(sys.modules)
import rlsolver_tpu_torch
names = [m.name for m in pkgutil.walk_packages(rlsolver_tpu_torch.__path__, "rlsolver_tpu_torch.")
         if not m.name.endswith("__main__")]
for name in names:
    importlib.import_module(name)
added = sorted(set(sys.modules) - before)
print(len(names))
print("\n".join(added))
"""


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith((".py", ".cu", ".cuh"))]
    return [p for p in out if os.path.exists(p)]


def test_importing_the_port_loads_no_jax():
    path = os.pathsep.join(p for p in (REPO, os.environ.get("PYTHONPATH")) if p)
    proc = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True, text=True,
                          cwd=REPO, env=dict(os.environ, PYTHONPATH=path), timeout=300)
    assert proc.returncode == 0, proc.stderr
    count, *added = proc.stdout.split("\n")
    assert int(count) >= 20  # every module of the slice was imported
    bad = [m for m in added if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_sources_name_no_jax(path):
    with open(path) as f:
        text = f.read()
    imports = re.findall(r"^\s*(?:import|from)\s+([\w.]+)", text, flags=re.M)
    assert not [m for m in imports if m.split(".")[0] in FORBIDDEN], imports
    assert not re.search(r"\brlsolver_tpu\.", text)
