"""Multi-host set-up, the 2-D ("host", "device") mesh and collectives over
both of its axes (counterpart of `rlsolver_tpu/parallel/distributed.py`;
RLSolver's NCCL process groups and `mp.spawn` launchers,
`S2V_PPO/train_ddp.py:16-61`).

`initialize_multihost` starts the default process group from `torchrun`'s
environment or from explicit arguments, with the backend chosen by where
the ranks live (`launch.choose_backend`: NCCL where each rank has a card of
its own, gloo otherwise); in a single process it does nothing. The 2-D mesh
puts hosts on its rows; a collective over both axes runs along "device"
first (within a host: NVLink) and then along "host" (across hosts), as
JAX's reduction over ("host", "device") rides ICI and then DCN. Env batches
shard over both axes in row-major order, rank = host * devices + device.
"""

from __future__ import annotations

import datetime
import os
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from rlsolver_tpu_torch.parallel import mesh as mesh_lib

HOST_AXIS = "host"
DEVICE_AXIS = "device"
DEFAULT_TIMEOUT_S = 300


def initialize_multihost(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    device: Optional[str] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> bool:
    """Start the default process group; a no-op in a single process.

    Reads `torchrun`'s `WORLD_SIZE`/`RANK` (and its `MASTER_ADDR` rendezvous,
    `env://`) unless `init_method` (`tcp://host:port` or `file://path`),
    `world_size` and `rank` are given. `device` ("cuda" unless "cpu") and
    the cards on this host choose the backend.
    Returns True if a group of more than one rank is active after the
    call."""
    from rlsolver_tpu_torch.parallel.launch import choose_backend, rank_device

    if dist.is_initialized():
        return dist.get_world_size() > 1
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if init_method is None and world_size == 1:
        return False  # one process: nothing to do
    if rank is None:
        rank = int(os.environ["RANK"])
    device_type = "cpu" if device == "cpu" else "cuda"
    local_ranks = int(os.environ.get("LOCAL_WORLD_SIZE", str(world_size)))
    backend = choose_backend(local_ranks, device_type)
    if device_type == "cuda":
        local_rank = int(os.environ.get("LOCAL_RANK", str(rank)))
        torch.cuda.set_device(rank_device(local_rank, device_type))
    dist.init_process_group(backend, init_method=init_method or "env://", world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dist.get_world_size() > 1


def make_host_device_mesh(num_hosts: Optional[int] = None, axis_names=(HOST_AXIS, DEVICE_AXIS),
                          device_type: Optional[str] = None):
    """A 2-D `DeviceMesh` [hosts, ranks per host] over the whole process
    group. The host count is `num_hosts`, or the world size over torchrun's
    `LOCAL_WORLD_SIZE` (one host without it); a single process may pass
    `num_hosts` to simulate hosts with its ranks."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("a host x device mesh needs a process group")
    n = dist.get_world_size()
    hosts = num_hosts or max(1, n // int(os.environ.get("LOCAL_WORLD_SIZE", str(n))))
    if n % hosts:
        raise ValueError(f"{n} ranks not divisible into {hosts} hosts")
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() and torch.cuda.is_initialized() else "cpu"
    return DeviceMesh(device_type, torch.arange(n).reshape(hosts, n // hosts), mesh_dim_names=tuple(axis_names))


def _flat_rank(mesh) -> int:
    return dist.get_rank(mesh.get_group(HOST_AXIS)) * mesh.size(1) + dist.get_rank(mesh.get_group(DEVICE_AXIS))


def env_sharding_2d(mesh, xs: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a [B, ...] batch sharded over both axes (B =
    hosts * devices * local)."""
    n = mesh.size()
    if xs.shape[0] % n:
        raise ValueError(f"a batch of {xs.shape[0]} does not divide over {n} ranks")
    per = xs.shape[0] // n
    r = _flat_rank(mesh)
    return xs[r * per : (r + 1) * per]


def replicated_2d(obj, mesh):
    """Broadcast from the mesh's first rank, in place (`mesh.replicated`
    over the world, which the mesh spans)."""
    return mesh_lib.replicated(obj, dist.group.WORLD)


def _both(x: torch.Tensor, reduce: Callable, mesh) -> torch.Tensor:
    return reduce(reduce(x, mesh.get_group(DEVICE_AXIS)), mesh.get_group(HOST_AXIS))


def psum_all(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum over the whole mesh: along "device", then along "host"."""
    return _both(x, mesh_lib.psum, mesh)


def pmean_all(x: torch.Tensor, mesh) -> torch.Tensor:
    return psum_all(x, mesh) / mesh.size()


def pmax_all(x: torch.Tensor, mesh) -> torch.Tensor:
    return _both(x, mesh_lib.pmax, mesh)


def shard_rollout_2d(mesh, fn: Callable, replicated_args: Sequence[int] = ()):
    """`fn` on this rank's rows over both axes (arguments in
    `replicated_args` whole); every output all-gathered along "device",
    then along "host", into the global [B, ...] tensor."""

    def gather(o):
        return mesh_lib.all_gather_rows(mesh_lib.all_gather_rows(o, mesh.get_group(DEVICE_AXIS)),
                                        mesh.get_group(HOST_AXIS))

    def wrapped(*args):
        local = [a if i in replicated_args else env_sharding_2d(mesh, a) for i, a in enumerate(args)]
        out = fn(*local)
        if isinstance(out, torch.Tensor):
            return gather(out)
        return tuple(gather(o) for o in out)

    return wrapped
