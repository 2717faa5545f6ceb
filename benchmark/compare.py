"""The numbers a check compares, candidate against the reference."""

from __future__ import annotations

import torch


def rows_differ(a: torch.Tensor, b: torch.Tensor) -> int:
    """Rows (along the last axis) of a and b that differ anywhere."""
    return int((a.cpu() != b.cpu()).any(dim=-1).sum())


def diff_gap(cand: torch.Tensor, exp: torch.Tensor) -> float:
    """||cand - exp|| / ||exp||."""
    e = exp.double().cpu()
    return float(torch.linalg.vector_norm(cand.double().cpu() - e)) / max(float(torch.linalg.vector_norm(e)), 1e-30)


def norm_gap(cand: torch.Tensor, exp: torch.Tensor) -> float:
    """| ||cand|| - ||exp|| | / ||exp||: the gap of two norms, not the norm of
    the gap, since Adam turns a gradient that is nought to rounding into a
    full step of either sign."""
    de = float(torch.linalg.vector_norm(exp.double().cpu()))
    return abs(float(torch.linalg.vector_norm(cand.double().cpu())) - de) / max(de, 1e-30)


def first_gradient(mu1: torch.Tensor, mu0: torch.Tensor) -> torch.Tensor:
    """The gradient that Adam's step got, from its first moment before and
    after the step (b1 = 0.9): (mu1 - 0.9 mu0) / 0.1, in float64."""
    return (mu1.double() - 0.9 * mu0.double()) / 0.1
