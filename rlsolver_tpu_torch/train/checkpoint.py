"""Checkpoint and resume of the full training state (counterpart of
`rlsolver_tpu/train/checkpoint.py`, with `torch.save` in place of orbax).

A state is any nesting of dicts, lists, tuples (NamedTuples included),
tensors, `torch.Generator`s and Python scalars. On disk it is laid out as
dicts, lists and tuples of CPU tensors and Python scalars only, so that
`torch.load(..., weights_only=True)` reads it: a generator becomes
`{"__generator__": get_state(), "device": ...}` (its state is a CPU byte
tensor, for a CPU and a CUDA generator alike) and a NamedTuple a plain
tuple. `restore_checkpoint(path, like)` rebuilds `like`'s structure, with
each tensor on `like`'s device and in its dtype and each generator a new
one on `like`'s device in the saved state, so a resumed run continues the
same trajectory draw for draw.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Optional

import torch

_GEN = "__generator__"
_FILE = "state.pt"


def _pack(obj: Any) -> Any:
    if isinstance(obj, torch.Generator):
        return {_GEN: obj.get_state(), "device": str(obj.device)}
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        items = [_pack(v) for v in obj]
        return items if isinstance(obj, list) else tuple(items)
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    raise TypeError(f"cannot checkpoint a {type(obj).__name__}")


def _new_generator(saved: dict, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.set_state(saved[_GEN])
    return gen


def _unpack(saved: Any, like: Any = None) -> Any:
    if isinstance(saved, dict) and _GEN in saved:
        return _new_generator(saved, like.device if like is not None else saved["device"])
    if isinstance(like, torch.Tensor):
        return saved.to(device=like.device, dtype=like.dtype)
    if isinstance(saved, dict):
        return {k: _unpack(v, None if like is None else like[k]) for k, v in saved.items()}
    if isinstance(saved, (list, tuple)):
        likes = [] if like is None else list(like)[: len(saved)]
        likes += [None] * (len(saved) - len(likes))  # a list may have grown since `like`
        items = [_unpack(v, l) for v, l in zip(saved, likes)]
        if like is not None and hasattr(like, "_fields"):  # a NamedTuple
            return type(like)(*items)
        return items if isinstance(saved, list) else tuple(items)
    return saved


def save_checkpoint(path: str, state: Any) -> None:
    """Persist a state (params, optimizer state, generators, step counters,
    incumbents). `path` is a directory; an existing checkpoint there is
    replaced (written to a temporary file first, then renamed)."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, _FILE + ".tmp")
    torch.save(_pack(state), tmp)
    os.replace(tmp, os.path.join(path, _FILE))


def restore_checkpoint(path: str, like: Optional[Any] = None) -> Any:
    """Restore a state saved by `save_checkpoint` with `weights_only=True`.

    With `like` (recommended: the freshly initialised training state) the
    result takes its structure, devices and dtypes; without it, tensors
    stay on the CPU, generators return on their saved device and
    NamedTuples as plain tuples."""
    saved = torch.load(os.path.join(os.path.abspath(path), _FILE), map_location="cpu", weights_only=True)
    return _unpack(saved, like)


def latest_step_dir(root: str) -> Optional[str]:
    """Of `root/step_*` directories, the one with the largest step."""
    if not os.path.isdir(root):
        return None
    steps = []
    for name in os.listdir(root):
        if name.startswith("step_"):
            try:
                steps.append((int(name[5:]), name))
            except ValueError:
                continue
    if not steps:
        return None
    return os.path.join(root, max(steps)[1])


class CheckpointManager:
    """Periodic `step_N` checkpoints with retention, plus resume."""

    def __init__(self, root: str, save_every: int = 1000, keep: int = 3):
        self.root = os.path.abspath(root)
        self.save_every = max(1, save_every)
        self.keep = max(1, keep)

    def maybe_save(self, step: int, state: Any) -> bool:
        if step % self.save_every != 0:
            return False
        self.save(step, state)
        return True

    def save(self, step: int, state: Any) -> None:
        os.makedirs(self.root, exist_ok=True)
        save_checkpoint(os.path.join(self.root, f"step_{step}"), state)
        self._prune()

    def restore_latest(self, like: Optional[Any] = None):
        """Returns (state, step) or (None, 0) when no checkpoint exists."""
        path = latest_step_dir(self.root)
        if path is None:
            return None, 0
        step = int(os.path.basename(path)[5:])
        return restore_checkpoint(path, like), step

    def _prune(self) -> None:
        dirs = sorted((int(n[5:]), n) for n in os.listdir(self.root) if n.startswith("step_"))
        for _, name in dirs[: -self.keep]:
            shutil.rmtree(os.path.join(self.root, name), ignore_errors=True)

    def select_best(self, eval_fn, like: Optional[Any] = None, maximize: bool = True):
        """Evaluate every retained checkpoint and return the best
        (state, step, score). `eval_fn(state) -> float`."""
        best = None
        if not os.path.isdir(self.root):
            return None
        for name in sorted(os.listdir(self.root)):
            if not name.startswith("step_"):
                continue
            step = int(name[5:])
            state = restore_checkpoint(os.path.join(self.root, name), like)
            score = float(eval_fn(state))
            key = score if maximize else -score
            if best is None or key > best[0]:
                best = (key, state, step, score)
        if best is None:
            return None
        _, state, step, score = best
        return state, step, score
