"""Debugging and observability helpers (counterpart of
`rlsolver_tpu/utils/debug.py`; RLSolver's `show_gpu_memory` and
`check_tensor`): a profiler trace, a device-memory gauge, a finiteness
check over a tree of tensors and an anomaly guard for autograd."""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

import numpy as np
import torch


@contextlib.contextmanager
def profile_trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block (the host, and the card when CUDA is in use) and
    write a Chrome trace to `log_dir/trace.json`."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_memory_str(device: Optional[torch.device] = None) -> str:
    """Live and peak memory allocated on a CUDA device and its size; a CPU
    device has no such statistics."""
    device = torch.device(device) if device is not None else (
        torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu"))
    if device.type != "cuda":
        return f"{device}: memory stats unavailable"
    stats = torch.cuda.memory_stats(device)
    gb = 1024**3
    live = stats.get("allocated_bytes.all.current", 0) / gb
    peak = stats.get("allocated_bytes.all.peak", 0) / gb
    limit = torch.cuda.get_device_properties(device).total_memory / gb
    return f"{device}: live {live:.2f} GiB, peak {peak:.2f} GiB, limit {limit:.2f} GiB"


def _leaves(tree, path: str = ""):
    """(path, leaf) of a nesting of dicts, lists and tuples (NamedTuples by
    field name)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        names = getattr(tree, "_fields", None)
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}.{names[i]}" if names else f"{path}[{i}]")
    else:
        yield path, tree


def assert_finite(tree, name: str = "tree") -> None:
    """Raise FloatingPointError at the first floating tensor or array of
    the tree that holds a NaN or an infinity."""
    for path, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            bad = leaf.is_floating_point() and not bool(torch.isfinite(leaf).all())
        else:
            arr = np.asarray(leaf)
            bad = np.issubdtype(arr.dtype, np.floating) and not np.isfinite(arr).all()
        if bad:
            raise FloatingPointError(f"non-finite values in {name}{path}")


@contextlib.contextmanager
def nan_guard() -> Iterator[None]:
    """Autograd's anomaly detection inside the block: a backward pass that
    makes a NaN raises at the forward operation that led to it (slow)."""
    prev = torch.is_anomaly_enabled()
    torch.autograd.set_detect_anomaly(True)
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(prev)
