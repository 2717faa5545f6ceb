"""The data-parallel layer over `torch.distributed` (counterpart of
`rlsolver_tpu/parallel/`): a 1-D mesh of ranks named "env" (`mesh.py`), the
2-D ("host", "device") mesh and its collectives (`distributed.py`), and a
launcher that spawns ranks with an explicit backend and device each
(`launch.py`).

JAX runs one SPMD program over a device mesh under `shard_map`; here every
rank is a process that holds one shard of the env axis and a replica of the
parameters, and the collectives are `torch.distributed` calls on the mesh's
process group. With no process group, or a group of one rank, every
collective is the identity.
"""
