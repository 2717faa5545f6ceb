"""train_iter_ms: the window's wall time over the training iterations
completed in it (each iteration's span as the trainer's own `timings`
reports it, ending in a wait for the device)."""


def read(r):
    return 1e3 * r["window_s"] / r["iterations"] if r.get("iterations") else None
