"""sweep_roofline: the noisy sweeps' least time over their time through
`FusedSweepEngine.sweep` (CUDA events around each call, the window's calls
summed). The least time counts what the operation must do on the cell's
chains, nodes, edges and sweeps (benchmark/counts.py), whatever kernel
serves the call."""

from benchmark import counts


def read(r):
    calls = r.get("sweep_calls")
    if not calls:
        return None
    least = sum(counts.least_seconds(*counts.noisy_sweep_work(b, n, r["edges"], s), r["sm_count"])
                for _, (b, n, s) in calls)
    return 100.0 * least / sum(t for t, _ in calls)
