"""CUDA graphs for launch-bound loops: a step of a few thousand small
kernels, captured once and replayed, costs the card's time instead of the
host's launch time.

`CapturedCall(fn)` calls `fn(*inputs)` eagerly unless its first input lies
on the card; there the first call captures `fn` as a CUDA graph on static
copies of the inputs, and every call copies its inputs into them, replays,
and returns the captured outputs (overwritten by the next call). The graph
runs the eager call's kernels on the same inputs, so it follows the eager
run bit for bit.

Capture needs warm-up calls before it, on the stream that then captures:
a library's first call on a stream (cuBLAS's) sets it up, which a capture
cannot hold. `fn` may write tensors in place (a chain's state, a model's
parameters and Adam's moments): those it names in `restore` are put back
after the warm-up, so that the warm-up leaves no trace. A training step takes Adam's bias
corrections as an input (`ClippedAdam.corrections()`), so that its count
stays on the host.

`Graphs` keeps one `CapturedCall` per loop name and input shapes, for a loop
called again with other shapes (a solve's warm start and its rounds).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

WARMUP_CALLS = 2


class CapturedCall:
    def __init__(self, fn: Callable, enabled: bool = True, restore: Sequence[torch.Tensor] = ()):
        self.fn, self.enabled, self.restore = fn, enabled, list(restore)
        self.graph = None

    def __call__(self, *inputs: torch.Tensor):
        if not (self.enabled and inputs[0].is_cuda):
            return self.fn(*inputs)
        if self.graph is None:
            self._capture(inputs)
        for buf, x in zip(self.inputs, inputs):
            buf.copy_(x)
        self.graph.replay()
        return self.outputs

    def _capture(self, inputs) -> None:
        dev = inputs[0].device
        self.inputs = [x.detach().to(dev, copy=True) for x in inputs]
        saved = [t.detach().clone() for t in self.restore]
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_CALLS):
                self.fn(*self.inputs)
        torch.cuda.current_stream(dev).wait_stream(side)
        with torch.no_grad():
            for dst, src in zip(self.restore, saved):
                dst.copy_(src)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=side):
            self.outputs = self.fn(*self.inputs)


class Graphs:
    """Captured loops, one CUDA graph per loop `name` and input shapes (none
    when `enabled` is False, or off the card). A name's `fn` must be the
    same computation at every call."""

    def __init__(self, enabled: bool = True):
        self.enabled, self.calls = enabled, {}

    def __call__(self, name: str, fn: Callable, *inputs: torch.Tensor):
        if not self.enabled:
            return fn(*inputs)
        key = (name, *(tuple(x.shape) for x in inputs))
        if key not in self.calls:
            self.calls[key] = CapturedCall(fn)
        return self.calls[key](*inputs)


EAGER = Graphs(enabled=False)
