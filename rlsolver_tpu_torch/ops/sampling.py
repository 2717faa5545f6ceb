"""Sampling primitives of MCPG (counterpart of `rlsolver_tpu/ops/sampling.py`).

  * bernoulli_logp — log P(bits | probs) summed over nodes;
  * metropolis_bitflip_chain — MCPG's budgeted `metro_sampling`
    (`MCPG.py:88-118` in RLSolver): every chain proposes one uniform node per
    round and accepts with min(1, (1-q)/q), until C * max_transfer_time
    accepts in total or round_cap_factor * max_transfer_time rounds. This is
    the default (non `--fast`) sampler; `--fast` uses the packed kernels.
  * metropolis_bitflip_scan — the same proposals for a fixed number of
    rounds, no accept budget: `algos/mcpg_multi.py`'s `sampler="scan"`;
  * gumbel_noise — standard Gumbel noise -log(-log(u)), the draw behind every
    categorical sample of the port;
  * gumbel_topk — ISCO's no-replacement proposal: the top k of logits plus
    Gumbel noise (`methods/util.py:498-555` in RLSolver);
  * mh_accept — the Metropolis-Hastings accept mask u < exp(log_alpha);
  * sub_set_sampling — L2A's uncertainty-guided resampling of the top-k
    least certain bits.

Every drawing function takes its draws from `gen` or, where the caller
passes them, injected, so that the tests can feed it JAX's draws.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


def bernoulli_logp(probs: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Sum over the node axis of log P(bits | probs). [.., N] -> [..]."""
    p = torch.where(bits.bool(), probs, 1.0 - probs)
    return torch.sum(torch.log(p), dim=-1)


def gumbel_noise(shape, gen: Optional[torch.Generator], device=None, dtype=torch.float32) -> torch.Tensor:
    """Gumbel(0, 1) noise of `shape` from `gen`: argmax(logits + noise) is
    a categorical sample, as `jax.random.categorical` draws it."""
    u = torch.rand(shape, generator=gen, device=device, dtype=dtype)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(dtype).tiny)))


def gumbel_topk(gen: Optional[torch.Generator], logits: torch.Tensor, k: int,
                gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Indices [.., k] of a size-k no-replacement sample ~ softmax(logits)
    [.., N]: the top k of logits + Gumbel(0, 1) noise, drawn from `gen`
    unless `gumbel` (shaped like logits) gives it."""
    if gumbel is None:
        gumbel = gumbel_noise(logits.shape, gen, logits.device, logits.dtype)
    return torch.topk(logits + gumbel, k, dim=-1).indices


def mh_accept(gen: Optional[torch.Generator], log_alpha: torch.Tensor,
              u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Metropolis accept mask log(u) < log_alpha, bool shaped like
    log_alpha; the uniforms u come from `gen` unless given."""
    if u is None:
        u = torch.rand(log_alpha.shape, generator=gen, device=log_alpha.device)
    return torch.log(u) < log_alpha


class ChainResult(NamedTuple):
    samples: torch.Tensor  # bool [C, N]
    num_accepted: int
    num_rounds: int


def metropolis_bitflip_chain(
    gen: torch.Generator,
    probs: torch.Tensor,
    samples: torch.Tensor,
    max_transfer_time: int,
    round_cap_factor: int = 5,
) -> ChainResult:
    """Policy-targeted bit-flip MH over bool [C, N] chains (see module doc).
    The stationary law is the Bernoulli(probs) product measure."""
    num_chains, num_nodes = samples.shape
    budget = num_chains * max_transfer_time
    round_cap = round_cap_factor * max_transfer_time
    samples = samples.clone()
    rows = torch.arange(num_chains, device=samples.device)
    count, t = 0, 0
    while count < budget and t < round_cap:
        nodes = torch.randint(0, num_nodes, (num_chains,), generator=gen, device=samples.device)
        p_base = probs[nodes]
        cur = samples[rows, nodes]
        q = torch.where(cur, p_base, 1.0 - p_base)
        accept = torch.rand(num_chains, generator=gen, device=samples.device) < (1.0 - q) / q
        samples[rows, nodes] = cur ^ accept
        count += int(accept.sum())
        t += 1
    return ChainResult(samples, count, t)


def metropolis_bitflip_scan(
    gen: Optional[torch.Generator],
    probs: torch.Tensor,
    samples: torch.Tensor,
    num_rounds: int,
    nodes: Optional[torch.Tensor] = None,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """`num_rounds` rounds of `metropolis_bitflip_chain`'s proposals on bool
    [C, N] chains, with no accept budget. Round r proposes nodes[r] [C] and
    accepts where u[r] < (1 - q) / q, the JAX package's f32 expression (K11
    tests u * q < 1 - q, which can differ on a rounding boundary). The
    draws (nodes int [R, C], u f32 [R, C]) come from `gen` unless given."""
    num_chains, num_nodes = samples.shape
    dev = samples.device
    if nodes is None:
        nodes = torch.randint(0, num_nodes, (num_rounds, num_chains), generator=gen, device=dev)
        u = torch.rand(num_rounds, num_chains, generator=gen, device=dev)
    samples = samples.clone()
    rows = torch.arange(num_chains, device=dev)
    for r in range(num_rounds):
        node = nodes[r].long()
        p_base = probs[node]
        cur = samples[rows, node]
        q = torch.where(cur, p_base, 1.0 - p_base)
        samples[rows, node] = cur ^ (u[r] < (1.0 - q) / q)
    return samples


def sub_set_sampling(
    gen: Optional[torch.Generator],
    probs: torch.Tensor,
    start_xs: torch.Tensor,
    num_repeats: int,
    top_k: int,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """L2A's `sub_set_sampling` (`L2A/transformer.py:335-354` in RLSolver),
    as the JAX package has it: tile start_xs [B, N] into `num_repeats`
    copies, repeat r of sim b at row r * B + b, and redraw only each sim's
    `top_k` least certain bits (smallest |p - 0.5|) from `probs`; the other
    bits keep the incumbent's values. (RLSolver draws those bits against
    the certainty itself, an apparent slip; the JAX package and this port
    draw them from `probs`.) The uniforms [num_repeats * B, k], in the
    order of `torch.topk`, come from `gen` unless `u` gives them. On ties in
    |p - 0.5| the top-k order may differ from `jax.lax.top_k`'s."""
    num_nodes = probs.shape[1]
    k = min(top_k, num_nodes)
    _, ids = torch.topk(-(probs - 0.5).abs(), k, dim=1)  # [B, k], least certain first
    p = torch.gather(probs, 1, ids).repeat(num_repeats, 1)
    if u is None:
        u = torch.rand(p.shape, generator=gen, device=p.device)
    return start_xs.repeat(num_repeats, 1).scatter(1, ids.repeat(num_repeats, 1), u < p)
