"""Elitist parallel-solution reductions (counterpart of
`rlsolver_tpu/ops/reductions.py`).

  * update_xs_by_vs: per-sim replace-if-strictly-better;
  * pick_xs_by_vs: best of `num_repeats`, with repeat r of sim b at row
    r * num_sims + b. Ties go to the first repeat, as `jnp.argmax` does;
  * evolutionary_replacement: the worst sims take copies of random good ones
    (`rlsolver/methods/util.py:87-94` in RLSolver).
"""

from __future__ import annotations

from typing import Optional, Tuple

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


def evolutionary_replacement(
    gen: Optional[torch.Generator],
    xs: torch.Tensor,
    vs: torch.Tensor,
    low_k: int,
    maximize: bool = True,
    donors: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Replace the `low_k` worst sims with copies of sims drawn uniformly
    from the others. The order is a stable sort, best first, as
    `jnp.argsort`; `donors` (ranks in [0, num_sims - low_k)) may be given in
    place of the draw from `gen`."""
    num_sims = vs.shape[0]
    order = torch.argsort(-vs if maximize else vs, stable=True)
    worst = order[num_sims - low_k :]
    if donors is None:
        donors = torch.randint(0, num_sims - low_k, (low_k,), generator=gen, device=vs.device)
    donor_rows = order[donors]
    xs, vs = xs.clone(), vs.clone()
    xs[worst] = xs[donor_rows]
    vs[worst] = vs[donor_rows]
    return xs, vs
