"""samples_per_s: chain-samples completed in the window over the window's
wall time. A sample is one chain through one round (MH proposals, sweeps,
cut); the window includes each call's own table build, warm start and
graph capture, which users pay."""


def read(r):
    return r["samples"] / r["window_s"] if "samples" in r else None
