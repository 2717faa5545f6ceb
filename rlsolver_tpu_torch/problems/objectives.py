"""Host-side maxcut objective (counterpart of
`rlsolver_tpu/problems/objectives.py:obj_maxcut`): the golden twin that the
CLI re-scores every returned solution with."""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np

from rlsolver_tpu_torch.core.graph import Graph

Labels = Union[Sequence[int], np.ndarray]


def obj_maxcut(solution: Labels, graph: Graph) -> float:
    """Sum of the weights of the edges whose endpoints differ. 0/1 labels."""
    x = np.asarray(solution).astype(np.int64)
    n0, n1, w = graph.edge_arrays()
    return float(w[x[n0] != x[n1]].sum())
