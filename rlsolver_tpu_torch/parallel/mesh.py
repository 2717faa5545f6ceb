"""The 1-D env mesh and its collectives (counterpart of
`rlsolver_tpu/parallel/mesh.py`; RLSolver's only multi-GPU path is S2V_PPO's
DDP, `S2V_PPO/train_ddp.py:16-61`: per-rank env shards, replicated
parameters, all-reduced gradients and metrics).

  * `make_mesh(n)`: a 1-D `DeviceMesh` named "env" over the first n ranks
    of the process group (None without one);
  * `shard_env_batch`: this rank's rows of a [B, ...] batch, B divisible by
    the world size; `replicated`: a broadcast from rank 0, in place;
  * `shard_rollout(mesh, fn, replicated_args=...)`: `fn` on the local
    shard, its sharded outputs all-gathered (JAX's global arrays);
  * `psum`, `pmean`, `pmax`, `pmin` (and `psum_metric`, `pmax_metric`) on a
    tensor, and `pmean_grads`, which all-reduces a list of parameters'
    gradients as one flat buffer.

Every function takes a `DeviceMesh`, a process group, or None; on None or a
group of one rank it is the identity. Gloo has no `ReduceOp.AVG`, so a mean
is a SUM divided by the world size, as `jax.lax.pmean` is. Collectives run
on uint8 in place of bool (gloo takes no bool).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

ENV_AXIS = "env"


def group_of(mesh):
    """A 1-D DeviceMesh's process group (the world's for a mesh of more
    dimensions, which spans it: `distributed.make_host_device_mesh`), or
    the group as given."""
    if mesh is None:
        return None
    if hasattr(mesh, "get_group"):
        return mesh.get_group() if mesh.ndim == 1 else dist.group.WORLD
    return mesh


def world_size(mesh=None) -> int:
    """Ranks along the mesh or group (1 for None)."""
    group = group_of(mesh)
    return 1 if group is None else dist.get_world_size(group)


def rank(mesh=None) -> int:
    """This process's index along the mesh or group (0 for None): the shard
    it holds."""
    group = group_of(mesh)
    return 0 if group is None else dist.get_rank(group)


def make_mesh(num_devices: Optional[int] = None, axis_name: str = ENV_AXIS, device_type: Optional[str] = None):
    """A 1-D `DeviceMesh` named `axis_name` over ranks 0 .. num_devices - 1
    of the process group (all of them by default), on `device_type` ("cuda"
    where CUDA is set up in this process, else "cpu"). None when no process
    group exists (one process: every collective is the identity)."""
    if not dist.is_initialized():
        if num_devices not in (None, 1):
            raise RuntimeError(f"a mesh of {num_devices} ranks needs a process group "
                               f"(parallel.distributed.initialize_multihost or parallel.launch)")
        return None
    from torch.distributed.device_mesh import DeviceMesh

    n = dist.get_world_size() if num_devices is None else num_devices
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() and torch.cuda.is_initialized() else "cpu"
    return DeviceMesh(device_type, torch.arange(n), mesh_dim_names=(axis_name,))


def shard_bounds(total: int, mesh=None) -> tuple:
    """This rank's rows [lo, hi) of `total`, which must divide evenly."""
    n = world_size(mesh)
    if total % n:
        raise ValueError(f"a batch of {total} does not divide over {n} ranks")
    per = total // n
    return rank(mesh) * per, (rank(mesh) + 1) * per


def shard_env_batch(mesh, xs: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a [B, ...] batch (JAX's `P("env")` placement)."""
    lo, hi = shard_bounds(xs.shape[0], mesh)
    return xs[lo:hi]


def replicated(obj, mesh=None):
    """Broadcast from the group's rank 0, in place, and return `obj`: a
    tensor, a module (parameters and buffers), or a list or tuple of those."""
    group = group_of(mesh)
    if world_size(group) == 1:
        return obj
    if isinstance(obj, torch.Tensor):
        tensors = [obj]
    elif isinstance(obj, torch.nn.Module):
        tensors = list(obj.parameters()) + list(obj.buffers())
    elif isinstance(obj, (list, tuple)):
        for item in obj:
            replicated(item, group)
        return obj
    else:
        raise TypeError(f"cannot replicate {type(obj).__name__}")
    src = dist.get_global_rank(group, 0)
    with torch.no_grad():
        for t in tensors:
            buf = t.to(torch.uint8) if t.dtype == torch.bool else t
            dist.broadcast(buf, src=src, group=group)
            if buf is not t:
                t.copy_(buf.bool())
    return obj


def _reduce(x: torch.Tensor, op, group) -> torch.Tensor:
    if world_size(group) == 1:
        return x
    y = x.detach().reshape(-1).clone()
    if y.dtype == torch.bool:
        y = y.to(torch.uint8)
    dist.all_reduce(y, op=op, group=group)
    return y.to(x.dtype).reshape(x.shape)


def psum(x: torch.Tensor, mesh=None) -> torch.Tensor:
    return _reduce(x, dist.ReduceOp.SUM, group_of(mesh))


def pmean(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """The SUM over the ranks divided by their number (`jax.lax.pmean`)."""
    n = world_size(mesh)
    return x if n == 1 else psum(x, mesh) / n


def pmax(x: torch.Tensor, mesh=None) -> torch.Tensor:
    return _reduce(x, dist.ReduceOp.MAX, group_of(mesh))


def pmin(x: torch.Tensor, mesh=None) -> torch.Tensor:
    return _reduce(x, dist.ReduceOp.MIN, group_of(mesh))


psum_metric, pmax_metric = psum, pmax


def flat_grads(params: Sequence[torch.Tensor]) -> torch.Tensor:
    """The parameters' gradients (zero where none) as one flat f32 buffer."""
    return torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1) for p in params])


def pmean_grads(params: Sequence[torch.Tensor], mesh=None, mean: bool = True) -> None:
    """All-reduce the gradients of `params` as one flat buffer, one call a
    step, and write them back (the mean over the ranks, or the sum with
    `mean=False`). The optimizer's clip then sees the reduced gradient, as
    optax's chain does after a `pmean`."""
    group = group_of(mesh)
    n = world_size(group)
    if n == 1:
        return
    flat = flat_grads(params)
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    if mean:
        flat = flat / n
    at = 0
    for p in params:
        p.grad = flat[at : at + p.numel()].view_as(p).clone()
        at += p.numel()


def all_gather_rows(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """The ranks' [b, ...] shards concatenated in rank order: [n * b, ...]."""
    group = group_of(mesh)
    n = world_size(group)
    if n == 1:
        return x
    src = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts)
    return out.bool() if x.dtype == torch.bool else out


def shard_generator(seed: int, mesh, device) -> Optional[torch.Generator]:
    """A generator of this rank's own draws (JAX's `fold_in` of the shard
    index), seeded from (seed, rank); None on one rank, where the caller's
    replicated generator draws them, so that a world of one follows the
    unsharded run draw for draw."""
    if world_size(mesh) == 1:
        return None
    state = np.random.SeedSequence([seed, rank(mesh)]).generate_state(1, np.uint64)[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state) & 0x7FFFFFFFFFFFFFFF)
    return gen


def shard_rollout(mesh, fn: Callable, replicated_args: Sequence[int] = ()):
    """Wrap a per-shard `fn(*args) -> tensor or tuple of tensors`: each
    argument not in `replicated_args` is a global [B, ...] tensor whose
    rank's rows `fn` gets, and each output is all-gathered into the global
    [B, ...] tensor (JAX's default out spec, `P("env")`). Collectives inside
    `fn` take the same mesh."""

    def wrapped(*args):
        local = [a if i in replicated_args else shard_env_batch(mesh, a) for i, a in enumerate(args)]
        out = fn(*local)
        if isinstance(out, torch.Tensor):
            return all_gather_rows(out, mesh)
        return tuple(all_gather_rows(o, mesh) for o in out)

    return wrapped
