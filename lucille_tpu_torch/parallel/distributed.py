"""Multi-process bring-up over torch.distributed.

Counterpart of lucille_tpu/parallel/distributed.py:24-120, the reference's
typed MPI facade (src/base/parallel.c:62-233):

    ri_parallel_init      (parallel.c:62)  -> initialize_distributed()
    ri_parallel_ntasks    (parallel.c:95)  -> process_count()
    ri_parallel_taskid    (parallel.c:106) -> process_index()
    ri_parallel_barrier   (parallel.c:128) -> barrier()
    ri_parallel_gather    (parallel.c:117) -> all_gather_host()
    rank-0 display I/O    (render.c:468-514,1219-1243) -> is_primary_host()

The process group uses the **gloo** backend.  Every collective the
renderer makes is of host data: a round's finished tiles gathered as
numpy (all_gather_host), host 0's recovery state shipped as numpy
(broadcast_from_primary), and barriers, which carry nothing.  NCCL would
add a device copy on each side of every one of them, and it refuses two
ranks on one card, which is how a one-card machine runs two processes.

As in the reference built without WITH_MPI (parallel.c:73-78), a
single-process run brings nothing up, and every query answers for one
task: 1 process, index 0, primary, barriers that return at once.

Differences from lucille_tpu:

- `num_processes > 1` without a coordinator raises.  lucille_tpu hands
  that case to jax.distributed, which detects a cluster from its
  environment (a TPU pod's metadata, SLURM); nothing tells torch of one,
  so the address must be given.
- The process group has a finite timeout (TIMEOUT): a rank that never
  joins, or dies mid-frame, fails the others instead of hanging them.
- Which card a process renders on is decided here (`local_devices`):
  the cards named by `local_device_ids`, else card process_index modulo
  the cards visible, so two processes on a one-card machine share
  cuda:0.  A single process uses every card it sees.
"""

from __future__ import annotations

from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT = timedelta(seconds=300)

_local_device_ids = None  # the cards named at bring-up, if any


def initialize_distributed(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids=None,
) -> bool:
    """Join the process group; returns True when distributed mode is on.
    Call it before anything touches a device (the reference calls
    ri_parallel_init before everything, main.c:119).

    coordinator: "host:port" of process 0's rendezvous.  A single-process
    invocation (no coordinator, num_processes absent or 1) is a no-op
    returning False: the WITH_MPI=undef build."""
    global _local_device_ids
    if coordinator is None and (num_processes is None or int(num_processes) <= 1):
        return False
    if coordinator is None:
        raise ValueError(
            f"{int(num_processes)} processes need --coordinator HOST:PORT "
            "(process 0's address); torch.distributed detects no cluster")
    if num_processes is None or process_id is None:
        raise ValueError(
            f"--coordinator {coordinator} needs --num-processes and "
            "--process-id")
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}",
        world_size=int(num_processes), rank=int(process_id), timeout=TIMEOUT)
    _local_device_ids = (None if local_device_ids is None
                         else [int(i) for i in local_device_ids])
    return True


def finalize_distributed() -> None:
    """ri_parallel_finalize (parallel.c:85): leave the process group."""
    global _local_device_ids
    if dist.is_initialized():
        dist.destroy_process_group()
    _local_device_ids = None


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary_host() -> bool:
    """True on the process that owns display and file output: lucille's
    rank-0-only drv->open/write/close (render.c:468-514)."""
    return process_index() == 0


def local_devices() -> list:
    """The CUDA cards this process renders on (module docstring); raises
    where torch sees none."""
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("torch sees no CUDA card")
    if _local_device_ids is not None:
        return [torch.device("cuda", i) for i in _local_device_ids]
    if dist.is_initialized():
        return [torch.device("cuda", process_index() % n)]
    return [torch.device("cuda", i) for i in range(n)]


def barrier(name: str = "frame") -> None:
    """Cross-process sync point (frame barriers, render.c:342,368); `name`
    labels it for the reader, as lucille_tpu's does."""
    if process_count() > 1:
        dist.barrier()


def broadcast_from_primary(tree):
    """Host 0's tuple of numpy arrays on every process (MPI_Bcast,
    parallel.c:150): the checkpoint's image, alpha and done bitmap under
    --recover, whose file may exist only on host 0, so every process
    skips the same tiles.  Only host 0 need know their shapes and dtypes.
    Single process: the tuple itself."""
    if process_count() == 1:
        return tree
    box = [tuple(np.asarray(a) for a in tree) if is_primary_host() else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def all_gather_host(x):
    """x (a numpy array or tensor, or a tuple of them) as numpy on every
    process, each array concatenated along axis 0 over the processes in
    rank order, as process_allgather(tiled=True) gives it (the
    MPI_Gather of parallel.c:117, every process getting the result).  A
    process with nothing to add passes a zero-length array, whose other
    axes need not match.  Single process: x copied to the host."""
    single = not isinstance(x, tuple)
    local = tuple(_host(a) for a in ((x,) if single else x))
    if process_count() > 1:
        parts = [None] * process_count()
        dist.all_gather_object(parts, local)
        local = tuple(
            np.concatenate([p[i] for p in parts if len(p[i])]
                           or [parts[0][i]])
            for i in range(len(local)))
    return local[0] if single else local
