"""Device choice shared by the port's entry points.

Entry points run on the card unless the caller asks for the CPU. With no
card and no such request they raise: a run never drops to the CPU silently.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """`None` means `cuda`. Also pins float32 matmuls to full precision, on
    which the exact dense cut relies."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' (CLI: --device cpu)"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def synchronize() -> None:
    """Wait for the work queued on the card, if CUDA is in use (nothing to
    wait for on the CPU): a host clock or a host read of results needs it."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
