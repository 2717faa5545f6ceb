"""The yardstick: the H100's peaks and the work that an operation must do,
from which a roofline share is the least time over the measured time.

Every count depends only on the operation's definition and its inputs
(chains, nodes, edges, rounds, sweeps), never on how the program does it,
and counts no more than any correct implementation must do, so that no
reading passes 100%.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W limit):
3.35 TB/s of HBM3, 67 TFLOP/s of float32 outside the tensor cores. The
INT32 issue rate is the SM count x 64 results per clock per SM (the CUDA C++
Programming Guide's throughput table for compute capability 9.0: 32-bit
integer add, logic, shift, compare and multiply) x the 1.98 GHz boost clock,
16.7 TOP/s on 132 SMs.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
BOOST_CLOCK_HZ = 1.98e9
INT32_PER_SM_CLOCK = 64

# One Philox4x32-10 call, four 32-bit draws: ten rounds, each two 32 x 32 ->
# 64-bit multiplies (one wide multiply each) and two three-input XORs (one
# logic op each), the key schedule hoisted out of the loop.
PHILOX_CALL_OPS = 10 * (2 + 2)
DRAWS_PER_CALL = 4


def int32_ops_per_s(sm_count: int) -> float:
    return sm_count * INT32_PER_SM_CLOCK * BOOST_CLOCK_HZ


def least_seconds(ops: float, bytes_moved: float, sm_count: int) -> float:
    """The larger of the integer-issue bound and the HBM bound."""
    return max(ops / int32_ops_per_s(sm_count), bytes_moved / HBM_BYTES_PER_S)


def mh_sampler_work(chains: int, nodes: int, rounds: int):
    """(int32 ops, bytes) of `rounds` Metropolis proposals on each of
    `chains` chains of `nodes` bits given and returned as one byte a bit
    (the interface's bool [B, N]). A proposal needs one Philox draw below
    2^15 nodes (two from there) and one compare; the chains are read and
    written once."""
    draws = 1 if nodes < 1 << 15 else 2
    ops = chains * rounds * (draws * PHILOX_CALL_OPS / DRAWS_PER_CALL + 1)
    return ops, 2.0 * chains * nodes


def noisy_sweep_work(chains: int, nodes: int, edges: int, sweeps: int):
    """(int32 ops, bytes) of `sweeps` noisy degree-ordered sweeps on each of
    `chains` chains given and returned as one byte a bit. A step of a chain
    needs one Philox draw (16 bits used, four steps a call at the least)
    and one compare; its neighbour sum reads each of the 2|E| adjacency
    entries of a sweep once for every 32 chains (one bit-sliced add a
    neighbour for 32 chains at once)."""
    steps = chains * nodes * sweeps
    ops = steps * (PHILOX_CALL_OPS / DRAWS_PER_CALL + 1) + sweeps * 2.0 * edges * chains / 32.0
    return ops, 2.0 * chains * nodes


def _attention_flops(rows: int, n: int, d: int) -> float:
    """Self-attention over n nodes, width d (all heads), `rows` sequences:
    the query, key, value and output projections, the scores, the weighted
    sum."""
    return rows * (4 * 2.0 * n * d * d + 2 * 2.0 * n * n * d)


def l2a_policy_forward_flops(sims: int, n: int, d: int, value_head: bool = True) -> float:
    """Matmul FLOPs of one forward of L2A's policy transformer on `sims`
    solutions of n nodes (models/transformer.py PolicyTrsWithValue)."""
    per_node = 2.0 * (2 * (d // 4) + (d + d // 4) * d + d * d + d * 2)  # prob_embed, mix, mem_out, prob_out
    if value_head:
        per_node += 2.0 * (d * d + d)
    return sims * n * per_node + 2 * _attention_flops(sims, n, d)


def l2a_encoder_forward_flops(n: int, d: int, mlp: int = 256, layers: int = 2) -> float:
    """Matmul FLOPs of the graph encoder's forward on one graph."""
    inp = 2.0 * n * (n * n + n * mlp + mlp * d)
    blocks = layers * (_attention_flops(1, n, d) + 2 * 2.0 * n * d * mlp)
    return inp + blocks + 2 * 2.0 * n * d * d + 2.0 * n * (d * mlp + mlp * n)


def l2a_iteration_flops(sims: int, n: int, d: int, steps: int) -> float:
    """One training iteration: the encoder's embedding of the graph, then
    `steps` unrolled forwards of the policy and their backward, twice the
    forward of what the loss reaches (the value head is not)."""
    fwd = l2a_policy_forward_flops(sims, n, d)
    bwd = 2.0 * l2a_policy_forward_flops(sims, n, d, value_head=False)
    return l2a_encoder_forward_flops(n, d) + steps * (fwd + bwd)
