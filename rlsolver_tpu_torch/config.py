"""Graph-type axis of the synthetic generators (counterpart of
`rlsolver_tpu/config.py:GraphType`)."""

from __future__ import annotations

import enum


class GraphType(enum.Enum):
    """Synthetic graph distributions."""

    BA = "BA"  # Barabasi-Albert, m=4
    ER = "ER"  # Erdos-Renyi, p=0.15
    PL = "PL"  # powerlaw cluster, m=4, p=0.05
