"""Device-mesh tile sharding.

Counterpart of lucille_tpu/parallel/mesh.py:32-112 (SURVEY.md sections
2.8 and 7):

- the frame's tiles form the one axis of the mesh, "tiles": round r
  gives tile r*D+d to slot d, statically (no queue, no locks; the
  successor of lucille's bucket queue, render.c:582-710);
- the scene is replicated on every slot's device (the Renderer's
  replicas), and each slot renders its tile with the same tile function
  the single-device Renderer runs, so the frames cannot drift apart;
- the slots of the mesh span the processes: process r owns the slots of
  its own devices, laid out in rank order, and enqueues only those;
- a round's tiles and counters come back through one all_gather_host,
  so every process assembles the whole frame; host 0 owns the displays.

`sharded_tile_batch` takes the place of lucille_tpu's shard_map: where
XLA runs one program over the mesh, the port enqueues slot d's tile on
device d from the host, every owned slot of a round before any pull.
"""

from __future__ import annotations

from contextlib import nullcontext

import numpy as np
import torch
import torch.distributed as dist

from lucille_tpu_torch.device import resolve_device
from lucille_tpu_torch.parallel.distributed import (
    all_gather_host,
    local_devices,
    process_count,
    process_index,
)


class Mesh:
    """An ordered tuple of torch devices, the frame's global tile slots,
    on the axis `axis_names[0]`; `owned` are the slots this process
    renders (its own devices' slots, contiguous).  Another process's
    slots carry its device's name as a label."""

    def __init__(self, devices, owned, axis: str = "tiles"):
        self.devices = tuple(torch.device(d) for d in devices)
        self.owned = tuple(owned)
        self.axis_names = (axis,)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def local(self) -> bool:
        """True when this process owns every slot (no collective)."""
        return len(self.owned) == len(self.devices)

    def __repr__(self):
        return (f"Mesh({[str(d) for d in self.devices]}, owned="
                f"{list(self.owned)}, axis={self.axis_names[0]!r})")


def make_mesh(n_devices: int | None = None, axis: str = "tiles",
              devices=None) -> Mesh:
    """A mesh over the first n slots of every process's devices, in rank
    order (all of them when n is None).

    devices: this process's devices; by default its CUDA cards
    (distributed.local_devices).  `devices=["cpu"] * n` is the explicit
    CPU mesh of n replicas.  Where the processes have fewer than n
    devices this raises, naming the shortfall: lucille_tpu falls back
    to the CPU pool when the default backend has too few devices
    (lucille_tpu/parallel/mesh.py:39-47), the port never drops to the
    CPU unless asked.  In a multi-process run every process calls it
    (the devices are gathered), and each must own at least one slot."""
    mine = [resolve_device(d) for d in
            (local_devices() if devices is None else devices)]
    if process_count() > 1:
        names = [None] * process_count()
        dist.all_gather_object(names, [str(d) for d in mine])
    else:
        names = [[str(d) for d in mine]]
    start = sum(len(n) for n in names[:process_index()])
    slots = [d for n in names for d in n]
    if n_devices is not None:
        if len(slots) < n_devices:
            where = (f"torch sees {torch.cuda.device_count()} CUDA card(s)"
                     if devices is None else f"{len(mine)} given")
            raise ValueError(f"a mesh of {n_devices} devices needs "
                             f"{n_devices}, have {len(slots)} ({where}, "
                             f"{process_count()} process(es))")
        slots = slots[:n_devices]
    owned = [s for s in range(start, start + len(mine)) if s < len(slots)]
    if not owned:
        raise ValueError(f"a mesh of {len(slots)} slots leaves process "
                         f"{process_index()} none")
    return Mesh(slots, owned, axis)


def _on(device: torch.device):
    """The device's CUDA context (a no-op on the CPU): every launch and
    allocation of a slot runs on its own card."""
    return torch.cuda.device(device) if device.type == "cuda" else nullcontext()


class _Round:
    """One round of up to D tiles in flight, one a slot.  It pulls to the
    host lazily, once, on the first get(): one all_gather_host of every
    owned slot's image and counters (lucille_tpu/render/renderer.py:
    155-180)."""

    def __init__(self, mesh: Mesh, outs: dict):
        self._mesh = mesh
        self._outs = outs  # {slot: (image, counters)} still on the devices
        self._np = None

    def get(self, slot: int) -> tuple:
        """Slot `slot`'s (image, counters) as numpy."""
        if self._np is None:
            slots = sorted(self._outs)
            local = tuple(
                np.stack([self._outs[s][i].cpu().numpy() for s in slots])
                if slots else np.zeros(0, np.float32) for i in (0, 1))
            if not self._mesh.local:
                local = all_gather_host(local)
            self._np, self._outs = local, None
        return self._np[0][slot], self._np[1][slot]


def sharded_tile_batch(mesh: Mesh, tile_fn):
    """tile_fn(slot, x0, y0) -> (image, counters), tensors on the slot's
    device (the Renderer's tile).  Returns enqueue(origins): given a
    round's D or fewer tile origins, it enqueues slot d's tile on device
    d for the slots this process owns (a short round leaves the slots
    past its end empty) and returns the round; round.get(d) is slot d's
    (image, counters) as numpy, on every process."""

    def enqueue(origins) -> _Round:
        outs = {}
        for slot in mesh.owned:
            if slot < len(origins):
                with _on(mesh.devices[slot]):
                    outs[slot] = tile_fn(slot, *origins[slot])
        return _Round(mesh, outs)

    return enqueue


def render_frame_sharded(desc, mesh: Mesh | None = None, seed: int = 0,
                         tile: int = 64):
    """A full frame with its tiles sharded over the mesh (default: every
    card of every process), through the Renderer (the same tile function,
    displays, checkpoints and statistics as one device).  Returns (image
    (H, W, 3) f32, nrays)."""
    from lucille_tpu_torch.render.renderer import Renderer

    r = Renderer(desc, tile_size=tile, seed=seed,
                 mesh=make_mesh() if mesh is None else mesh)
    image = r.render_frame()
    return image, r.stats.nrays
