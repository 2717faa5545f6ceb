"""Carry the JAX package's MCPG state into the port.

The JAX state arrives as numpy arrays (the caller converts with
`np.asarray`; this module imports nothing of JAX):

  * BernoulliPolicy params `{"params": {"logits": [N]}}` become the port's
    `BernoulliPolicy` state dict `{"logits": [N]}`;
  * the optax state of `chain(clip_by_global_norm, adam)` — nested tuples
    holding one `ScaleByAdamState(count, mu, nu)` with mu, nu shaped like
    the params — becomes the state of the port's `ClippedAdam`.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def policy_state_dict(params) -> Dict[str, torch.Tensor]:
    """`{"params": {"logits": arr}}` -> `{"logits": tensor}`."""
    return {"logits": torch.from_numpy(np.array(params["params"]["logits"], np.float32))}


def _find_adam_state(opt_state):
    if all(hasattr(opt_state, a) for a in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for item in opt_state:
            found = _find_adam_state(item)
            if found is not None:
                return found
    return None


def adam_state(opt_state) -> Dict[str, object]:
    """optax state of `chain(clip_by_global_norm, adam)` -> `ClippedAdam`
    state dict `{"count": int, "mu": [tensor], "nu": [tensor]}`."""
    adam = _find_adam_state(opt_state)
    if adam is None:
        raise ValueError("no Adam state (count, mu, nu) found in the optimizer state")
    return {
        "count": int(np.asarray(adam.count)),
        "mu": [policy_state_dict(adam.mu)["logits"]],
        "nu": [policy_state_dict(adam.nu)["logits"]],
    }
