"""The traced window: `torch.profiler` over the window, and the arithmetic
that turns its device intervals into busy time, idle gaps and a breakdown.

Busy time is the length of the union of the device's activity intervals
(kernels, copies, sets) inside the traced stretch, never their sum: two
kernels that overlap on two streams are busy once. The traced stretch is a
fixed part of the measured window that the driver names and opens
(`Tracer.begin`) and closes (`Tracer.end`): the profiler runs only there,
so that its cost does not grow with the window and the rest of the window
runs as an untraced one does. Its span is taken in the profiler's own clock. An idle gap is a stretch of the window with no device
interval; it is labelled by the innermost host range (a torch operator or a
benchmark range) open at its start, "host" where none is.
"""

from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, Sequence, Tuple

Interval = Tuple[float, float]


def union_length(intervals: Iterable[Interval], lo: float, hi: float) -> float:
    """Length of the union of [start, end) intervals, clipped to [lo, hi)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: Iterable[Interval], lo: float, hi: float) -> List[Interval]:
    """The stretches of [lo, hi) that no interval covers, in order."""
    out, t = [], lo
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if t < hi:
        out.append((t, hi))
    return out


def label_gaps(gap_list: Sequence[Interval], host: Sequence[Tuple[float, float, str]],
               lookback: int = 4096) -> Dict[str, float]:
    """Seconds of idle gap by what the host was doing at each gap's start:
    the innermost host range open there (the open range that started last,
    searched back up to `lookback` ranges), else "after <name>" of the range
    that ended last before it, else "host" (times in seconds)."""
    by_start = sorted(host)
    starts = [s for s, _, _ in by_start]
    by_end = sorted((e, name) for _, e, name in host)
    ends = [e for e, _ in by_end]
    out: Dict[str, float] = {}
    for gs, ge in gap_list:
        label = None
        i = bisect.bisect_right(starts, gs) - 1
        for j in range(i, max(-1, i - lookback), -1):
            if by_start[j][1] > gs:
                label = by_start[j][2]
                break
        if label is None:
            k = bisect.bisect_right(ends, gs) - 1
            label = f"after {by_end[k][1]}" if k >= 0 else "host"
        out[label] = out.get(label, 0.0) + (ge - gs)
    return out


def idle_pct(r: dict):
    """The device's idle share of the traced stretch, 100 (1 - busy /
    stretch); None where no stretch was traced."""
    if "busy_s" not in r:
        return None
    return 100.0 * (1.0 - r["busy_s"] / r["trace_window_s"])


def top(d: Dict[str, float], k: int = 10) -> List[list]:
    return [[name, secs] for name, secs in sorted(d.items(), key=lambda kv: -kv[1])[:k]]


class Tracer:
    """The Kineto profiler that `torch.profiler` drives (the device's activity
    where a card is, and the host's ranges of user scope: `record_function`
    ranges, not every operator), over the stretch between `begin` and `end`;
    with `enabled` false both do nothing. It keeps the profiler's raw events:
    `torch.profiler.profile` would turn each into a Python event object as
    it stops, which takes minutes for the millions of kernels of CUDA-graph
    replays."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.name = None
        self._result = None
        self._range = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.end()
        return False

    def begin(self, name: str) -> None:
        """Starts the profiler and opens the stretch's range `name`; only the
        first call does anything."""
        import torch
        from torch._C._profiler import RecordScope
        from torch.autograd import ProfilerActivity, ProfilerConfig, ProfilerState

        if not self.enabled or self.name is not None:
            return
        self.name = name
        config = ProfilerConfig(ProfilerState.KINETO, False, False, False, False, False,
                                torch._C._profiler._ExperimentalConfig())
        acts = {ProfilerActivity.CPU} | ({ProfilerActivity.CUDA} if torch.cuda.is_available() else set())
        torch.autograd._prepare_profiler(config, acts)
        # Host ranges of user scope only: recording every aten operator slows the
        # host's launches enough to idle the device, and the idle share would
        # read the profiler.
        torch.autograd._enable_profiler(config, acts, {RecordScope.USER_SCOPE})
        self._range = torch.profiler.record_function(name)
        self._range.__enter__()

    def end(self) -> None:
        """Closes the stretch and stops the profiler; later calls do nothing."""
        import torch

        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
            self._result = torch.autograd._disable_profiler()

    def events(self):
        """(device intervals [(s, e, name)], host ranges [(s, e, name)]) in
        seconds, from the profiler's results. A host range's projection on
        the device's timeline (a record_function range shown on the GPU row)
        is no device work and is dropped: its name is a host event's."""
        import torch

        dev, host = [], []
        for e in self._result.events():
            s = e.start_ns() / 1e9
            iv = (s, s + e.duration_ns() / 1e9, e.name())
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                dev.append(iv)
            elif e.device_type() == torch.autograd.DeviceType.CPU:
                host.append(iv)
        host_names = {name for _, _, name in host}
        return [d for d in dev if d[2] not in host_names], host

    def readings(self) -> dict:
        """busy_s, trace_window_s and the breakdown of the traced stretch;
        nothing where no stretch was traced."""
        if self._result is None:
            return {}
        dev, host = self.events()
        spans = [(s, e) for s, e, name in host if name == self.name]
        if not spans:
            raise RuntimeError(f"the trace holds no {self.name} range")
        lo, hi = spans[0]
        ivs = [(s, e) for s, e, _ in dev]
        by_op: Dict[str, float] = {}
        for s, e, name in dev:
            d = min(e, hi) - max(s, lo)
            if d > 0:
                by_op[name] = by_op.get(name, 0.0) + d
        host_ops = [h for h in host if h[2] != self.name]
        return {
            "busy_s": union_length(ivs, lo, hi),
            "trace_window_s": hi - lo,
            "breakdown": {"device_ops": top(by_op), "idle_gaps": top(label_gaps(gaps(ivs, lo, hi), host_ops))},
        }
