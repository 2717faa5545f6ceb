"""Gset/syn graph files (counterpart of `rlsolver_tpu/core/io.py`).

Format: first non-comment line "N M", then M lines "n0 n1 w" with 1-indexed
nodes; lines containing "//" are comments.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

from rlsolver_tpu_torch.core.graph import Graph


def read_graph(filename: str) -> Graph:
    """Read a gset/syn txt graph (1-indexed nodes -> 0-indexed)."""
    num_nodes = None
    edges: List[Tuple[int, int, float]] = []
    with open(filename, "r") as f:
        for line in f:
            if "//" in line or not line.strip():
                continue
            parts = line.split()
            if num_nodes is None:
                num_nodes = int(parts[0])
                continue
            n0, n1 = int(parts[0]) - 1, int(parts[1]) - 1
            w = float(parts[2]) if len(parts) > 2 else 1.0
            edges.append((n0, n1, w))
    if num_nodes is None:
        raise ValueError(f"empty graph file: {filename}")
    name = os.path.splitext(os.path.basename(filename))[0]
    return Graph.from_edge_list(num_nodes, edges, name=name)


def list_graph_files(directory: str, prefixes: Sequence[str]) -> List[str]:
    """All .txt files in `directory` whose basename starts with any prefix."""
    out = []
    for fn in sorted(os.listdir(directory)):
        if fn.endswith(".txt") and any(fn.startswith(p) for p in prefixes):
            out.append(os.path.join(directory, fn))
    return out
