"""train_mfu: the network's matmul FLOPs (benchmark/counts.py
l2a_iteration_flops: each unrolled step's forward and twice it for the
backward, the embedding's forward) of the iterations that run after the
traced stretch, over their time on the host clock and the float32 peak,
67 TFLOP/s: the port's matmuls run in float32 with TF32 off
(`device.resolve_device`). Those iterations run unprofiled, as in an
untraced run. The card's power limit is in the result's `device`."""

from benchmark import counts


def read(r):
    if not r.get("untraced_iterations"):
        return None
    flops = r["iteration_flops"] * r["untraced_iterations"]
    return 100.0 * flops / (r["untraced_s"] * counts.FP32_FLOPS_PER_S)
