"""Elitist parallel-solution reductions (counterpart of
`rlsolver_tpu/ops/reductions.py`).

  * update_xs_by_vs: per-sim replace-if-strictly-better;
  * pick_xs_by_vs: best of `num_repeats`, with repeat r of sim b at row
    r * num_sims + b. Ties go to the first repeat, as `jnp.argmax` does.
"""

from __future__ import annotations

from typing import Tuple

import torch


def update_xs_by_vs(
    good_xs: torch.Tensor,
    good_vs: torch.Tensor,
    xs: torch.Tensor,
    vs: torch.Tensor,
    maximize: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep the strictly better of (good_xs, xs) per sim."""
    better = vs > good_vs if maximize else vs < good_vs
    return torch.where(better[:, None], xs, good_xs), torch.where(better, vs, good_vs)


def pick_xs_by_vs(
    xs: torch.Tensor, vs: torch.Tensor, num_repeats: int, maximize: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best-of-repeats: xs [R*B, N], vs [R*B] -> (xs [B, N], vs [B])."""
    num_sims = xs.shape[0] // num_repeats
    vs_r = vs.reshape(num_repeats, num_sims)
    best_r = torch.argmax(vs_r, dim=0) if maximize else torch.argmin(vs_r, dim=0)
    rows = best_r * num_sims + torch.arange(num_sims, device=xs.device)
    return xs[rows], vs[rows]
