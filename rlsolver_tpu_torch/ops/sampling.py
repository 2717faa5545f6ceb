"""Sampling primitives of MCPG (counterpart of `rlsolver_tpu/ops/sampling.py`).

  * bernoulli_logp — log P(bits | probs) summed over nodes;
  * metropolis_bitflip_chain — MCPG's budgeted `metro_sampling`
    (`MCPG.py:88-118` in RLSolver): every chain proposes one uniform node per
    round and accepts with min(1, (1-q)/q), until C * max_transfer_time
    accepts in total or round_cap_factor * max_transfer_time rounds. This is
    the default (non `--fast`) sampler; `--fast` uses the packed kernels.
  * sub_set_sampling — L2A's uncertainty-guided resampling of the top-k
    least certain bits.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


def bernoulli_logp(probs: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Sum over the node axis of log P(bits | probs). [.., N] -> [..]."""
    p = torch.where(bits.bool(), probs, 1.0 - probs)
    return torch.sum(torch.log(p), dim=-1)


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
