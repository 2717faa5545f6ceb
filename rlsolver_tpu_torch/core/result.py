"""Result files (counterpart of `rlsolver_tpu/core/result.py`, same bytes).

Format (`rlsolver/methods/util_write_read_result.py:39-82`,
`docs/source/helloworld/quickstart.rst:30-50`):

    // obj: <value>
    // running_duration: <seconds>
    // num_nodes: <n>            (optional)
    // alg_name: <name>
    <node_index_1based> <label_plus1>
    ...

Path mapping (`rlsolver/methods/util.py:200-211`): 'data' in the instance
path is replaced by 'result'; an optional duration tail is appended; name
collisions are resolved by appending a random lowercase letter.
"""

from __future__ import annotations

import os
import random
import string
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np


def result_file_name(instance_file: str, add_tail: str = "") -> str:
    """Map a data path to its result path (`util.py:200-211` convention).

    Replaces the LAST `data` path segment (or `data` filename prefix) so an
    unrelated `data` substring elsewhere in the absolute path is untouched.
    """
    new_file = instance_file
    parts = new_file.split(os.sep)
    for i in range(len(parts) - 1, -1, -1):
        if parts[i] == "data" or (i < len(parts) - 1 and parts[i].startswith("data")):
            parts[i] = parts[i].replace("data", "result", 1)
            new_file = os.sep.join(parts)
            break
    result_dir = os.path.dirname(new_file) or "."
    os.makedirs(result_dir, exist_ok=True)
    if add_tail is not None:
        new_file = new_file.replace(".txt", "") + add_tail + ".txt"
    return new_file


def write_graph_result(
    obj: Union[float, int],
    running_duration: Optional[float],
    num_nodes: Optional[int],
    alg_name: str,
    solution: Union[Sequence[int], np.ndarray],
    instance_file: str,
    plus1: bool = True,
    info: Optional[Dict[str, object]] = None,
) -> str:
    """Write a result file next to the instance; returns the path written."""
    solution = np.asarray(solution)
    if solution.dtype == bool:
        solution = solution.astype(np.int64)
    add_tail = (
        ("_" if running_duration is None else "_" + str(int(running_duration)))
        if "data" in instance_file
        else None
    )
    path = result_file_name(instance_file, add_tail)
    while os.path.exists(path):
        stem, _, _ = path.rpartition(".txt")
        path = stem + random.choice(string.ascii_lowercase) + ".txt"
    with open(path, "w", encoding="UTF-8") as f:
        f.write(f"// obj: {obj}\n")
        f.write(f"// running_duration: {running_duration}\n")
        if num_nodes is not None:
            f.write(f"// num_nodes: {num_nodes}\n")
        f.write(f"// alg_name: {alg_name}\n")
        for key, value in (info or {}).items():
            f.write(f"// {key}: {value}\n")
        for i, label in enumerate(solution.tolist()):
            f.write(f"{i + 1} {label + 1 if plus1 else label}\n")
    return path


def read_graph_result(path: str) -> Tuple[Dict[str, str], np.ndarray]:
    """Read back a result file -> (header dict, 0-indexed labels array)."""
    header: Dict[str, str] = {}
    labels: List[int] = []
    with open(path, "r", encoding="UTF-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith("//"):
                key, _, value = line[2:].strip().partition(":")
                header[key.strip()] = value.strip()
            else:
                _, label = line.split()
                labels.append(int(label) - 1)
    return header, np.asarray(labels, np.int64)
