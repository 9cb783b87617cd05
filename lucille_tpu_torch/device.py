"""Explicit device selection.

The port never picks a device behind the caller's back: "cuda" needs a
visible card and raises where there is none, "cpu" runs the plain torch
twins of every kernel.  Nothing silently drops to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(name) -> torch.device:
    """'cuda' / 'cuda:N' / 'cpu' (or a torch.device) -> torch.device."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch sees no CUDA card"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {str(dev)!r}: use 'cuda' or 'cpu'")
