"""The distribution table and its standing checks (counterpart of
`scripts/summarize_quality.py`, `scripts/check_standing.py` and
`scripts/violating_cells.py`).

`render(csv_path)` turns a `dist,n,id,alg,obj,seconds` CSV into the
Markdown table: per (distribution, N) the average over the seeded instances
of each method's best cut (an instance's best row wins; a bound's tightest),
the `bound` column (per instance the least of the HiGHS dual bound and the
spectral bound), the best learned method's gap to it, the per-column
budgets, the convergence passes of the `boost_log.csv` beside the CSV, and
the standing checks. With `device_line=None` the text is the JAX script's,
character for character; the card's runs pass the `nvidia-smi` name and
power limit. `compare` prints each cell's mean beside a reference CSV's.

    python scripts/torch_summarize_quality.py [--csv results_quality/torch/dist_table.csv]
        [--device-line "NVIDIA H100 80GB HBM3, 700.00 W"] [--compare results_quality/dist_table.csv]
"""

from __future__ import annotations

import argparse
import collections
import csv
import os
from typing import List, Optional

from rlsolver_tpu_torch.eval.quality import OUT

ALGS = [
    "rw", "greedy", "sdp", "sa", "ga", "s2v", "eco", "pignn", "jumanji",
    "isco", "mcpg", "l2a", "milp", "bound",
]
LABEL = {
    "rw": "RandomWalk", "greedy": "Greedy", "sdp": "SDP-GW", "sa": "SA",
    "ga": "GA+tabu", "s2v": "S2V-DQN", "eco": "ECO-DQN", "pignn": "PI-GNN",
    "jumanji": "Jumanji", "isco": "ISCO", "mcpg": "MCPG", "l2a": "L2A",
    "milp": "HiGHS-60s", "bound": "bound",
}
BOUND_ALGS = ("specb", "milp_bound")
BUDGETS = [
    "- RandomWalk/Greedy/SDP-GW/SA/GA+tabu: one run per instance at the"
    " `quality_table.py` classical budgets (SA 256 chains x 12N steps;"
    " GA 40-64 generations).",
    "- S2V-DQN: per-cell training, 6144/3072 loop steps x 32 envs,"
    " greedy eval over 32 random inits.",
    "- ECO-DQN: ONE network per distribution trained at N=200"
    " (`eco_distribution.py`: 32768 loop steps x 64 envs = 2.1M"
    " transitions, 48-graph rotating pool, bf16 MPNN,"
    " validation-selected checkpoint), inferred across all sizes with"
    " 50/32 greedy rollouts — the reference train-once/infer-across"
    " protocol (`ECO_S2V/config.py:33-83`).",
    "- PI-GNN / Jumanji / ISCO: per-cell runs at the `quality_table.py`"
    " budgets (jumanji 100/80 PPO iters; isco 256/96 chains x"
    " max(600, 2N) segmented annealed steps).",
    "- MCPG: 256 chains x 32 repeats, 6 epochs (plus symmetric"
    " convergence passes below).",
    "- L2A: distribution-trained policy (60 iters) + packed-sweep"
    " guided search, 128/256 rounds x 512 sims x 16 repeats (plus"
    " symmetric convergence passes below).",
    "- bound: HiGHS 60s MILP dual min'd with the certified"
    " Poljak-Rendl spectral bound (4k-12k subgradient iters).",
]
HOLDS = "- holds at every (distribution, N) recorded so far"


def _avg(v):
    return sum(v) / len(v)


def best_by_instance(csv_path: str) -> dict:
    """{(dist, n): {alg: {gid: obj}}}: each instance's best cut, or for a
    bound (`specb`, `milp_bound`: every recorded bound is certified) its least."""
    by_gid = collections.defaultdict(dict)
    with open(csv_path) as f:
        for r in csv.reader(f):
            if not r or r[0] == "dist":
                continue
            dist, n, gid, alg, obj = r[0], int(r[1]), int(r[2]), r[3], float(r[4])
            cell = by_gid[(dist, n)].setdefault(alg, {})
            pick = min if alg in BOUND_ALGS else max
            cell[gid] = pick(cell.get(gid, obj), obj)
    return by_gid


def render(csv_path: str, device_line: Optional[str] = None, boost_path: Optional[str] = None) -> str:
    """The Markdown table of `csv_path`; `boost_path` defaults to the
    `boost_log.csv` beside it."""
    by_gid = best_by_instance(csv_path)
    rows = {k: {alg: list(d.values()) for alg, d in cell.items()} for k, cell in by_gid.items()}
    for key, cell_g in by_gid.items():
        parts = [p for p in (cell_g.get("milp_bound"), cell_g.get("specb")) if p]
        if parts:
            gids = set.intersection(*(set(p) for p in parts))
            if gids:
                rows[key]["bound"] = [min(p[g] for p in parts) for g in sorted(gids)]

    lines = ["# Distribution-wise maxcut benchmark (10 seeded instances per cell)", ""]
    if device_line is not None:
        lines += [f"Device: {device_line}.", ""]
    lines += [
        "Average best cut per method; reference protocol `README.md:356-371`.",
        "Instances are the seeded `{dist}_{N}_ID{i}` generator contract",
        "(`core/generate.py`), identical to the reference's `load_mygraph2`",
        "seeding. `bound` is the per-instance min of the HiGHS time-limited",
        "MILP dual bound and the certified Poljak-Rendl spectral bound",
        "(`classical/spectral_bound.py`) — the license-free analogue of the",
        "reference's Gurobi-1h 'obj bound' column (`README.md:335`); `gap%` =",
        "(bound - alg) / bound for the best learned method.",
        "",
    ]
    for dist in ("BA", "ER", "PL"):
        ns = sorted(n for (d, n) in rows if d == dist)
        if not ns:
            continue
        lines += [f"## {dist}", ""]
        lines.append("| N | " + " | ".join(LABEL[a] for a in ALGS) + " | best-RL gap% |")
        lines.append("|" + "---|" * (len(ALGS) + 2))
        for n in ns:
            cell = rows[(dist, n)]
            vals = []
            for a in ALGS:
                if a in cell and len(cell[a]) > 0:
                    vals.append(f"{_avg(cell[a]):.1f}" + ("*" if len(cell[a]) < 10 else ""))
                else:
                    vals.append("—")
            rl = max((_avg(cell[a]) for a in ("mcpg", "l2a") if a in cell), default=None)
            if rl is not None and "bound" in cell:
                gap_s = f"{(_avg(cell['bound']) - rl) / _avg(cell['bound']) * 100:+.2f}"
            else:
                gap_s = "—"
            lines.append(f"| {n} | " + " | ".join(vals) + f" | {gap_s} |")
        lines.append("")
    lines += ["`*` = fewer than 10 instances recorded yet (run in progress).", ""]
    lines += ["## Per-column compute budgets", ""] + BUDGETS + [""]

    boost_path = boost_path or os.path.join(os.path.dirname(csv_path), "boost_log.csv")
    if os.path.exists(boost_path):
        per_cell = collections.defaultdict(lambda: collections.defaultdict(lambda: [0, 0.0]))
        with open(boost_path) as f:
            for r in csv.reader(f):
                if r and r[0] != "dist":
                    c = per_cell[(r[0], int(r[1]))][r[2]]
                    c[0] += 1
                    c[1] += float(r[5])
        lines += ["## Convergence-pass protocol", "",
                  "Cells below received extra best-of-k attempts beyond the single",
                  "campaign run; attempts and budgets are applied symmetrically to",
                  "the methods being compared (`scripts/standing_pass.py`):", ""]
        for (dist, n) in sorted(per_cell):
            parts = ", ".join(f"{alg}: +{cnt} attempts ({sec:.0f}s total)"
                              for alg, (cnt, sec) in sorted(per_cell[(dist, n)].items()))
            lines.append(f"- {dist}_{n}: {parts}")
        lines.append("")

    def section(title, viol):
        lines.extend([title, ""] + ([f"- VIOLATION {v}" for v in viol] or [HOLDS]) + [""])

    viol = []
    for (dist, n), cell in sorted(rows.items()):
        if "ga" in cell and ("mcpg" in cell or "l2a" in cell):
            rl = max(_avg(cell[a]) for a in ("mcpg", "l2a") if a in cell)
            if rl < _avg(cell["ga"]) - 1e-9:
                viol.append(f"{dist}_{n}: best RL {rl:.1f} < GA {_avg(cell['ga']):.1f}")
    section("## MCPG/L2A >= GA check", viol)

    viol = []
    for (dist, n), cell in sorted(rows.items()):
        if "l2a" not in cell:
            continue
        l2a = _avg(cell["l2a"])
        if "ga" in cell and l2a < _avg(cell["ga"]) - 1e-9:
            viol.append(f"{dist}_{n}: L2A {l2a:.1f} < GA {_avg(cell['ga']):.1f}")
        if dist == "BA" and "mcpg" in cell and l2a < _avg(cell["mcpg"]) - 1e-9:
            viol.append(f"{dist}_{n}: L2A {l2a:.1f} < MCPG {_avg(cell['mcpg']):.1f}")
    section("## L2A flagship check (>= GA everywhere, >= MCPG on BA)", viol)

    viol = []
    learned = ("s2v", "eco", "pignn", "jumanji", "isco", "mcpg", "l2a")
    for (dist, n), cell in sorted(rows.items()):
        if "eco" in cell and "greedy" in cell and _avg(cell["eco"]) < _avg(cell["greedy"]) - 1e-9:
            viol.append(f"{dist}_{n}: ECO {_avg(cell['eco']):.1f} < greedy {_avg(cell['greedy']):.1f}")
        if n <= 500 and "eco" in cell and "s2v" in cell and _avg(cell["eco"]) < _avg(cell["s2v"]) - 1e-9:
            viol.append(f"{dist}_{n}: ECO {_avg(cell['eco']):.1f} < S2V {_avg(cell['s2v']):.1f}")
        for a in learned:
            if a in cell and "rw" in cell and _avg(cell[a]) < _avg(cell["rw"]) - 1e-9:
                viol.append(f"{dist}_{n}: {LABEL[a]} {_avg(cell[a]):.1f} < RandomWalk {_avg(cell['rw']):.1f}")
    section("## Learned-method checks (ECO >= greedy; ECO >= S2V at N<=500; no learned column < RandomWalk)",
            viol)
    return "\n".join(lines)


def check_standing(csv_path: str) -> int:
    """Prints per (dist, N) the GA / MCPG / L2A averages and flags cells
    where L2A < GA (everywhere) or L2A < MCPG (BA rows), over the instances
    both recorded; returns 1 if any complete cell fails, else 0."""
    cells = collections.defaultdict(lambda: collections.defaultdict(dict))
    with open(csv_path) as f:
        for r in csv.reader(f):
            if r and r[0] != "dist":
                d = cells[(r[0], int(r[1]))][r[3]]
                g = int(r[2])
                d[g] = max(d.get(g, float("-inf")), float(r[4]))
    bad = incomplete = 0
    for (dist, n) in sorted(cells):
        algs = cells[(dist, n)]
        if "l2a" not in algs:
            continue

        def avg(a, gids=None):
            v = algs.get(a)
            if not v:
                return None
            if gids is not None:
                v = {g: v[g] for g in gids}
            return sum(v.values()) / len(v) if v else None

        flags, note = [], ""
        for rival, label, active in (("ga", "L2A<GA", True), ("mcpg", "L2A<MCPG", dist == "BA")):
            if not active or rival not in algs:
                continue
            common = sorted(set(algs["l2a"]) & set(algs[rival]))
            if len(common) < 10:
                note = f" incomplete({len(common)}/10)"
            if not common:
                continue
            if avg("l2a", common) < avg(rival, common) - 1e-9:
                flags.append(label)
        if note and not flags:
            incomplete += 1
        else:
            bad += bool(flags)

        def s(a):
            v = avg(a)
            return f"{v:7.1f}" if v is not None else "    nan"

        print(f"{dist}_{n:<5d} GA {s('ga')}  MCPG {s('mcpg')}  L2A {s('l2a')}  {' '.join(flags) or 'ok'}{note}")
    print(f"{bad} failing cells ({incomplete} incomplete cells excluded)")
    return 1 if bad else 0


def violating_cells(csv_path: str) -> str:
    """The BA cells where L2A < MCPG over the instances both recorded, as
    `standing_pass --cells`' comma list."""
    v = collections.defaultdict(lambda: collections.defaultdict(dict))
    with open(csv_path) as f:
        for r in csv.reader(f):
            if r and r[0] == "BA" and r[3] in ("l2a", "mcpg"):
                d = v[int(r[1])][r[3]]
                g = int(r[2])
                d[g] = max(d.get(g, float("-inf")), float(r[4]))
    bad = []
    for n in sorted(v):
        c = v[n]
        if "l2a" in c and "mcpg" in c:
            common = set(c["l2a"]) & set(c["mcpg"])
            if sum(c["l2a"][g] for g in common) < sum(c["mcpg"][g] for g in common) - 1e-9:
                bad.append(f"BA:{n}")
    return ",".join(bad)


def runs_by_instance(csv_path: str) -> dict:
    """{(dist, n, alg): {gid: [obj, ...]}}: each instance's rows in file order
    (the first a campaign's own run, later ones its re-runs)."""
    out: dict = {}
    with open(csv_path) as f:
        for r in csv.DictReader(f):
            out.setdefault((r["dist"], int(r["n"]), r["alg"]), {}).setdefault(int(r["id"]), []).append(float(r["obj"]))
    return out


def compare(csv_path: str, reference: str) -> List[str]:
    """Per (dist, n, alg) of `csv_path`: its mean best cut and mean seconds
    beside the reference's first and last runs over the same instances, and
    whether the mean is at least the first run's less 1% (a bound: at least
    the largest cut of the reference for each instance)."""
    ours = best_by_instance(csv_path)
    secs: dict = collections.defaultdict(list)
    with open(csv_path) as f:
        for r in csv.DictReader(f):
            secs[(r["dist"], int(r["n"]), r["alg"])].append(float(r["seconds"]))
    ref, ref_best = runs_by_instance(reference), best_by_instance(reference)
    lines = []
    for (dist, n), cell in sorted(ours.items()):
        for alg, by_id in sorted(cell.items()):
            gids = sorted(by_id)
            mean = _avg([by_id[g] for g in gids])
            head = f"{dist}_{n} {alg}: mean {mean:.2f} over {len(gids)} ({_avg(secs[(dist, n, alg)]):.1f} s an instance)"
            jax = ref.get((dist, n, alg), {})
            if alg in BOUND_ALGS:
                cuts = ref_best.get((dist, n), {})
                known = [max(v[g] for a, v in cuts.items() if a not in BOUND_ALGS and g in v) for g in gids]
                verdict = "holds" if all(by_id[g] >= k for g, k in zip(gids, known)) else "FAILS"
                lines.append(f"{head}; at least every known cut: {verdict}")
                continue
            if not all(g in jax for g in gids):
                lines.append(f"{head}; no reference run")
                continue
            first, last = _avg([jax[g][0] for g in gids]), _avg([jax[g][-1] for g in gids])
            verdict = "holds" if mean >= 0.99 * first else "FAILS"
            lines.append(f"{head}; reference first run {first:.2f} ({100 * (mean - first) / first:+.2f}%), last run "
                         f"{last:.2f} ({100 * (mean - last) / last:+.2f}%); >= first run - 1%: {verdict}")
    return lines


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--csv", default=OUT)
    p.add_argument("--out", default=None, help="default: DIST_TABLE.md beside --csv")
    p.add_argument("--device-line", default=None, help="the card's name and power limit, printed under the title")
    p.add_argument("--compare", default=None, help="a reference CSV whose first runs to print each cell beside")
    args = p.parse_args(argv)
    text = render(args.csv, args.device_line)
    with open(args.out or os.path.join(os.path.dirname(args.csv), "DIST_TABLE.md"), "w") as f:
        f.write(text)
    print(text)
    if args.compare:
        print("\n".join(compare(args.csv, args.compare)))
    return 0


def check_standing_main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=check_standing.__doc__)
    p.add_argument("--csv", default=OUT)
    return check_standing(p.parse_args(argv).csv)


def violating_cells_main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=violating_cells.__doc__)
    p.add_argument("--csv", default=OUT)
    print(violating_cells(p.parse_args(argv).csv))
    return 0
