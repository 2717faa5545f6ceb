"""Sampling primitives of MCPG (counterpart of `rlsolver_tpu/ops/sampling.py`).

  * bernoulli_logp — log P(bits | probs) summed over nodes;
  * metropolis_bitflip_chain — MCPG's budgeted `metro_sampling`
    (`MCPG.py:88-118` in RLSolver): every chain proposes one uniform node per
    round and accepts with min(1, (1-q)/q), until C * max_transfer_time
    accepts in total or round_cap_factor * max_transfer_time rounds. This is
    the default (non `--fast`) sampler; `--fast` uses the packed kernels.
"""

from __future__ import annotations

from typing import NamedTuple

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
