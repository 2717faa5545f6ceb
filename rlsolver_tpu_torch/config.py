"""The problem and graph-type axes and the typed run configuration
(counterpart of `rlsolver_tpu/config.py`; RLSolver keeps them as module
constants, `rlsolver/methods/config.py:9-83`).

`MeshConfig.num_devices` reads as the world size of the data-parallel
layer (`parallel/`): the number of ranks, each holding one shard of the env
axis. None means every rank of the process group (one rank without one).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class Problem(enum.Enum):
    """Problem axis (RLSolver `config.py:18-32`)."""

    maxcut = "maxcut"
    graph_partitioning = "graph_partitioning"
    number_partitioning = "number_partitioning"
    minimum_vertex_cover = "minimum_vertex_cover"
    bilp = "bilp"
    maximum_independent_set = "maximum_independent_set"
    knapsack = "knapsack"
    set_cover = "set_cover"
    graph_coloring = "graph_coloring"
    portfolio_allocation = "portfolio_allocation"
    tnco = "tnco"
    vrp = "vrp"
    tsp = "tsp"


class GraphType(enum.Enum):
    """Synthetic graph distributions."""

    BA = "BA"  # Barabasi-Albert, m=4
    ER = "ER"  # Erdos-Renyi, p=0.15
    PL = "PL"  # powerlaw cluster, m=4, p=0.05


# Problems whose objective is maximized (RLSolver's per-method `if_maximize`,
# e.g. `envs/env_L2A.py:30`).
MAXIMIZE_PROBLEMS = frozenset(
    {
        Problem.maxcut,
        Problem.maximum_independent_set,
        Problem.knapsack,
        Problem.graph_partitioning,
        Problem.portfolio_allocation,
    }
)


def is_maximize(problem: Problem) -> bool:
    return problem in MAXIMIZE_PROBLEMS


@dataclasses.dataclass(frozen=True)
class GraphConfig:
    """Which instances to run on: a seeded synthetic instance (`BA_100_ID7`
    is `random.seed(7)` then generate, RLSolver `util_read_data.py:103-113`)
    or an explicit gset/syn file."""

    graph_type: Optional[GraphType] = GraphType.BA
    num_nodes: int = 100
    instance_id: Optional[int] = None
    path: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """The vectorized-env axis. `dtype` is the dense objective's storage
    type; `objective_mode` "dense" (a matmul), "sparse" (edge gathers) or
    "auto" (by density)."""

    num_sims: int = 1024
    dtype: str = "bfloat16"
    objective_mode: str = "auto"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """The data-parallel layer: `num_devices` ranks (None: the process
    group's world size) along the mesh axis `axis_name`."""

    num_devices: Optional[int] = None
    axis_name: str = "env"


@dataclasses.dataclass(frozen=True)
class RunConfig:
    problem: Problem = Problem.maxcut
    graph: GraphConfig = dataclasses.field(default_factory=GraphConfig)
    sim: SimConfig = dataclasses.field(default_factory=SimConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    seed: int = 0
    result_dir: str = "result"


# Data directory conventions of RLSolver's `data/` tree.
DATA_SUBDIR_BY_GRAPH_TYPE = {
    GraphType.BA: "syn_BA",
    GraphType.ER: "syn_ER",
    GraphType.PL: "syn_PL",
}
