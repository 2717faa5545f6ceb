"""Result aggregation across methods: per-instance comparison tables
(counterpart of `rlsolver_tpu/eval/statistics.py`; RLSolver's
`util_statistics.py:6-244`). Scans result trees laid out as
`<result_root>/<problem>_<method>/<instance>_<duration>.txt`, reads their
`// obj`, `// obj_bound` and `// gap` headers, and pivots them into an
instance x method table with gap columns.

The JAX package builds pandas frames; the port works without pandas and
returns rows, lists of dicts whose keys are the frame's columns in its
order (`instance` first), with NaN where the frame has NaN, and writes the
same CSV with the `csv` module.
"""

from __future__ import annotations

import csv
import math
import os
import re
from typing import Dict, List, Optional

from rlsolver_tpu_torch.core.result import read_graph_result

_TRAILING_RUN = re.compile(r"_(\d+)[a-z]*$")
NAN = float("nan")
Row = Dict[str, object]


def parse_result_filename(name: str) -> Dict[str, Optional[str]]:
    """`BA_100_ID0_3600.txt` -> {instance: BA_100_ID0, duration_tag: 3600}.
    The tail is the duration `write_graph_result` appends, with the letters
    of its collision-safe renaming."""
    stem = name[:-4] if name.endswith(".txt") else name
    m = _TRAILING_RUN.search(stem)
    if m:
        return {"instance": stem[: m.start()], "duration_tag": m.group(1)}
    return {"instance": stem, "duration_tag": None}


def _header_float(header: Dict[str, str], key: str) -> float:
    value = header.get(key, "None")
    return NAN if value == "None" else float(value)


def collect_results(result_root: str) -> List[Row]:
    """Every result file of `<result_root>/<problem>_<method>/*.txt` as a
    row {problem, method, instance, obj, running_duration, obj_bound, gap,
    path}; every run of an instance keeps its row; a missing header is NaN."""
    rows: List[Row] = []
    for d in sorted(os.listdir(result_root)):
        dir_path = os.path.join(result_root, d)
        if not os.path.isdir(dir_path):
            continue
        problem, _, method = d.partition("_")
        method = method or d
        for fname in sorted(os.listdir(dir_path)):
            if not fname.endswith(".txt") or fname.startswith((".", "_")):
                continue
            path = os.path.join(dir_path, fname)
            try:
                header, _ = read_graph_result(path)
            except (OSError, ValueError):  # not a result file
                continue
            rows.append({
                "problem": problem,
                "method": method,
                "instance": parse_result_filename(fname)["instance"],
                "obj": _header_float(header, "obj"),
                "running_duration": _header_float(header, "running_duration"),
                "obj_bound": _header_float(header, "obj_bound"),
                "gap": _header_float(header, "gap"),
                "path": path,
            })
    return rows


def _agg(values: List[float], how: str) -> float:
    """pandas' groupby max / min / mean: NaN skipped, NaN if nothing is left."""
    vals = [v for v in values if not math.isnan(v)]
    if not vals:
        return NAN
    if how == "max":
        return max(vals)
    if how == "min":
        return min(vals)
    return sum(vals) / len(vals)


def _gap(sign: float, ref: float, value: float) -> float:
    """sign (ref - value) / |ref|, NaN where ref is 0 or either is NaN."""
    if ref == 0 or math.isnan(ref) or math.isnan(value):
        return NAN
    return sign * (ref - value) / abs(ref)


def comparison_table(
    rows: List[Row],
    baseline_method: Optional[str] = None,
    maximize: bool = True,
    agg: str = "best",
    bound_method: Optional[str] = None,
) -> List[Row]:
    """Pivot to one row per instance (sorted) and one column per method
    (sorted). `agg="best"` keeps each method's best run (max when
    maximizing), `"mean"` averages its runs. With `baseline_method`, adds
    `gap_vs_<baseline>:<method>` = (baseline - obj) / |baseline|, signed so
    that positive is worse than the baseline; with `bound_method`, the
    column `obj_bound` (that method's best dual bound per instance, as the
    reference tables' "obj bound") and `gap_to_bound:<method>`."""
    if agg == "best":
        how = "max" if maximize else "min"
    elif agg == "mean":
        how = "mean"
    else:
        raise ValueError(f"unknown agg {agg}")
    if not rows:
        return []
    runs: Dict[tuple, List[float]] = {}
    for r in rows:
        runs.setdefault((r["instance"], r["method"]), []).append(r["obj"])
    instances = sorted({i for i, _ in runs})
    methods = sorted({m for _, m in runs})
    table = [{"instance": i, **{m: _agg(runs[(i, m)], how) if (i, m) in runs else NAN for m in methods}}
             for i in instances]
    sign = 1.0 if maximize else -1.0
    if baseline_method is not None and baseline_method in methods:
        for row in table:
            for m in methods:
                if m != baseline_method:
                    row[f"gap_vs_{baseline_method}:{m}"] = _gap(sign, row[baseline_method], row[m])
    if bound_method is not None:
        bounds = {i: _agg([r["obj_bound"] for r in rows if r["method"] == bound_method and r["instance"] == i], "max")
                  for i in instances}
        if any(not math.isnan(b) for b in bounds.values()):
            columns = [c for c in table[0] if c not in ("instance", "obj_bound") and not c.startswith("gap")]
            for row in table:
                row["obj_bound"] = bounds[row["instance"]]
                for m in columns:
                    row[f"gap_to_bound:{m}"] = _gap(sign, row["obj_bound"], row[m])
    return table


def _cell(value) -> str:
    """pandas' CSV text of a cell: floats by repr, NaN empty."""
    if isinstance(value, float):
        return "" if math.isnan(value) else repr(value)
    return str(value)


def write_comparison_csv(result_root: str, out_path: str, baseline_method: Optional[str] = None,
                         maximize: bool = True) -> List[Row]:
    """Scan, pivot and write the table as CSV (RLSolver's `process_folder`
    flow). Returns the rows."""
    table = comparison_table(collect_results(result_root), baseline_method, maximize)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        if table:
            writer.writerow(list(table[0]))
            writer.writerows([_cell(v) for v in row.values()] for row in table)
    return table
