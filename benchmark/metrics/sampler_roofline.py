"""sampler_roofline: the MH sampler's least time over its time through
`mh_sample_fused` (CUDA events around each call, the window's calls
summed). The least time counts what the operation must do on the cell's
chains, nodes and proposal rounds (benchmark/counts.py), whatever kernel
serves the call."""

from benchmark import counts


def read(r):
    calls = r.get("sampler_calls")
    if not calls:
        return None
    least = sum(counts.least_seconds(*counts.mh_sampler_work(b, n, rounds), r["sm_count"])
                for _, (b, n, rounds) in calls)
    return 100.0 * least / sum(t for t, _ in calls)
