"""Explicit device selection.

The port never picks a device behind the caller's back: "cuda" needs a
visible card and raises where there is none, "cpu" runs the plain torch
twins of every kernel.  Nothing silently drops to the CPU.

`const_vec` keeps the small constants the integrators read (colours,
directions, positions) on the device: a host-to-device copy waits for
the device to drain, so the bounce loops never make one per tile.

`host_sync` is the one door for a call that makes the host wait on the
card (a copy to the host, a blocking copy from it, a result whose size
the device decides): it counts the call in the recording frame's
`host_syncs` (base/timer.py), wherever the tensors lie, so a CPU frame
counts what the same frame waits for on a card.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from lucille_tpu_torch.base.timer import get_timer


def host_sync(op, *args):
    """op(*args), a call that makes the host wait on the card when its
    tensors lie there, counted as one host sync of the frame."""
    get_timer().count("host_syncs")
    return op(*args)


def const_vec(values, device) -> torch.Tensor:
    """values (a sequence of numbers) as an f32 tensor on `device`, copied
    there once per distinct (values, device) and shared after that; treat
    it as read-only.  A tensor passes through (moved to `device` if it
    lies elsewhere), so a differentiable parameter keeps its gradient
    (diff/render.py) where float() of its elements would drop it."""
    if torch.is_tensor(values):
        return values.to(device=device, dtype=torch.float32)
    return _const_vec(tuple(float(v) for v in values), torch.device(device))


@lru_cache(maxsize=None)
def _const_vec(values: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=device)


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
