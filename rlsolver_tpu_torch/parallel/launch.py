"""Spawn data-parallel ranks on one host (no JAX counterpart: JAX runs one
SPMD program in one process; RLSolver's `mp.spawn` launchers,
`S2V_PPO/train_ddp.py:240-258`).

`launch(fn, n, args)` starts n processes (the `spawn` method: CUDA cannot
fork), each of which sets one thread, picks its device, joins a process
group through a `file://` store and calls `fn(*args)`; the ranks' return
values come back in rank order. The backend is chosen by where the ranks
live, and printed (`choose_backend`): NCCL where each rank has a card of its
own, gloo otherwise (ranks sharing one card, or the CPU). NCCL refuses two
ranks on one device; gloo takes CUDA tensors for `all_reduce`, `broadcast`
and `all_gather`. A failure of NCCL is an error, never a reason to take
gloo.

A rank that raises fails the launch: its traceback is raised in the caller
and the other ranks are stopped. The process group's `timeout_s` bounds a
collective that waits for a dead rank, and `join_timeout_s` the whole
launch, so a hung rank fails one call instead of hanging its caller. Run
from a script, the caller's module is imported anew by every rank (a
`__main__` guard keeps its work out), and `fn` must be a module-level
function.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import pickle
import queue as queue_lib
import shutil
import tempfile
import time
import traceback
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist


def choose_backend(ranks_per_host: int, device_type: str) -> str:
    """NCCL when every rank on this host has a card of its own, else gloo."""
    if device_type == "cuda" and torch.cuda.device_count() >= ranks_per_host:
        return "nccl"
    return "gloo"


def rank_device(local_rank: int, device_type: str) -> torch.device:
    """Rank r's device: card r modulo the cards present (so ranks share a
    card when there are more ranks than cards), or the CPU."""
    if device_type == "cuda":
        return torch.device("cuda", local_rank % torch.cuda.device_count())
    return torch.device("cpu")


def _worker(rank: int, world: int, fn: Callable, args: Sequence, device_type: str, backend: str, store: str,
            timeout_s: float, results) -> None:
    try:
        torch.set_num_threads(1)
        if device_type == "cuda":
            torch.cuda.set_device(rank_device(rank, device_type))
        dist.init_process_group(backend, init_method=f"file://{store}", world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=timeout_s))
        # plain pickle: tensors travel by value (multiprocessing's pickler
        # would share their storage with a process that is about to exit)
        results.put((rank, True, pickle.dumps(fn(*args))))
    except BaseException:  # noqa: B902 - every failure goes back to the caller
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn: Callable, world_size: int, args: Sequence = (), device: Optional[str] = None,
           timeout_s: float = 120.0, join_timeout_s: float = 600.0, store_dir: Optional[str] = None) -> List[object]:
    """Run `fn(*args)` on `world_size` spawned ranks on `cuda` (unless
    `device="cpu"`), over the backend `choose_backend` picks, printed. The
    `file://` store lives in a fresh directory under `store_dir` (the
    system's temporary directory by default). Returns the ranks' results in
    rank order (each must pickle: CPU tensors, numbers, dicts). Raises
    RuntimeError with the first failing rank's traceback, TimeoutError when
    the ranks have not all returned within `join_timeout_s`."""
    device_type = "cpu" if device == "cpu" else "cuda"
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu'")
    backend = choose_backend(world_size, device_type)
    print(f"parallel.launch: {world_size} ranks, backend {backend}, devices "
          f"{[str(rank_device(r, device_type)) for r in range(world_size)]}", flush=True)
    tmp = tempfile.mkdtemp(prefix="rlsolver_launch_", dir=store_dir)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_worker, daemon=True,
                         args=(r, world_size, fn, tuple(args), device_type, backend, os.path.join(tmp, "store"),
                               timeout_s, results))
             for r in range(world_size)]
    out = {}
    try:
        for p in procs:
            p.start()
        deadline = time.time() + join_timeout_s
        while len(out) < world_size:
            if time.time() > deadline:
                raise TimeoutError(f"ranks {sorted(set(range(world_size)) - set(out))} did not return within "
                                   f"{join_timeout_s} s")
            try:
                r, ok, payload = results.get(timeout=1.0)
            except queue_lib.Empty:
                dead = [r for r, p in enumerate(procs) if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} exited with code {procs[dead[0]].exitcode} and no result")
                continue
            if not ok:
                raise RuntimeError(f"rank {r} of {world_size} failed:\n{payload}")
            out[r] = pickle.loads(payload)
        for p in procs:
            p.join(timeout=30)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(world_size)]
