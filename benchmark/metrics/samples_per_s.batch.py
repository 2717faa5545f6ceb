"""samples_per_s.batch: chain-samples of the whole batched solves completed
in the window over the window's wall time. A sample is one chain of one
graph through one round (MH proposals, sweeps, cut); each solve's own table
build, warm start and graph capture are inside, as users pay them."""


def read(r):
    return r["samples"] / r["window_s"] if "samples" in r else None
