"""Build and bind the CUDA kernels in `rlsolver_tpu_torch/csrc/`.

Each `csrc/<name>.cu` compiles with nvcc for `sm_90a` into its own shared
library with a plain C interface, loaded with ctypes (no PyTorch headers, so
a build takes seconds). Libraries go to `rlsolver_tpu_torch/build/`, named
by a hash of the sources and flags, and are built at first use; `build_all`
starts one nvcc per source at once.

Every C entry point launches on the stream it is given (PyTorch's current
stream), allocates nothing, and returns `cudaGetLastError()` as an int; a
non-zero code raises here. A `Kernel` counts its launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from typing import Dict, List, NamedTuple, Optional, Sequence

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(__file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(CSRC), "build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no FMA contraction: the sweep's f32 compare must round like torch/XLA
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LIBS: Dict[str, ctypes.CDLL] = {}


def header_constant(name: str, header: str = "common.cuh") -> int:
    """The integer literal of `constexpr <type> <name> = <literal>;` in a
    csrc header, so that Python sizing and the kernels share one value."""
    with open(os.path.join(CSRC, header)) as f:
        m = re.search(rf"constexpr\s+\w+\s+{name}\s*=\s*(\d+)\s*;", f.read())
    if m is None:
        raise KeyError(f"{name} is not an integer constexpr in {header}")
    return int(m.group(1))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _lib_path(source: str) -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        if name == source or name.endswith(".cuh"):
            with open(os.path.join(CSRC, name), "rb") as f:
                h.update(name.encode() + f.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{h.hexdigest()[:12]}.so")


class _Build(NamedTuple):
    proc: subprocess.Popen
    tmp: str  # nvcc writes here; renamed to `out` once it succeeds
    out: str
    source: str


def _start_build(source: str) -> Optional[_Build]:
    out = _lib_path(source)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", CSRC, "-o", tmp, os.path.join(CSRC, source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return _Build(proc, tmp, out, source)


def _finish_build(b: _Build) -> str:
    log, _ = b.proc.communicate()
    if b.proc.returncode != 0:
        os.unlink(b.tmp)
        raise RuntimeError(f"nvcc failed on {b.source}:\n{log}")
    os.replace(b.tmp, b.out)  # atomic: a reader never sees half a file
    with open(b.out + ".log", "w") as f:
        f.write(log)
    return log


def build_all(sources: Optional[Sequence[str]] = None) -> Dict[str, str]:
    """Build every kernel source, one nvcc per source, all started together.
    Returns {source: compiler log} for the sources built by this call."""
    if sources is None:
        sources = sorted(s for s in os.listdir(CSRC) if s.endswith(".cu"))
    builds = [b for b in (_start_build(s) for s in sources) if b is not None]
    try:
        return {b.source: _finish_build(b) for b in builds}
    finally:
        for b in builds:
            if b.proc.poll() is None:
                b.proc.kill()
                b.proc.wait()


def _library(source: str) -> ctypes.CDLL:
    if source not in _LIBS:
        build_all([source])
        lib = ctypes.CDLL(_lib_path(source))
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _LIBS[source] = lib
    return _LIBS[source]


class Kernel:
    """One C entry point of one kernel source, with its launch count.

    `argtypes` uses "p" for a device pointer, "i" for int, "u" for uint32,
    "f" for float; the stream is appended."""

    _CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "u": ctypes.c_uint32, "f": ctypes.c_float}

    def __init__(self, name: str, source: str, symbol: str, argtypes: str, replaces: str):
        self.name, self.source, self.symbol = name, source, symbol
        self.argtypes, self.replaces = argtypes, replaces
        self.launches = 0
        self._fn = None

    def _bind(self):
        if self._fn is None:
            lib = _library(self.source)
            fn = getattr(lib, self.symbol)
            fn.argtypes = [self._CTYPES[c] for c in self.argtypes] + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn, self._lib = fn, lib
        return self._fn

    def launch(self, *args) -> None:
        fn = self._bind()
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        device = tensors[0].device
        if any(t.device != device for t in tensors):
            raise ValueError(f"kernel {self.name}: all tensors must be on one device")
        conv: List[object] = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
        with torch.cuda.device(device):
            code = fn(*conv, torch.cuda.current_stream(device).cuda_stream)
        if code != 0:
            msg = self._lib.kernel_error_string(code).decode()
            raise RuntimeError(f"kernel {self.name} failed to launch: CUDA error {code} ({msg})")
        self.launches += 1


KERNELS: List[Kernel] = []


def register(kernel: Kernel) -> Kernel:
    KERNELS.append(kernel)
    return kernel


def reset_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def check_cuda_tensor(t: torch.Tensor, name: str, dtype, shape) -> None:
    """The wrapper-side contract of every kernel argument."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be on a CUDA device")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
