"""Scale-out: device meshes and sharded tile rendering.

Counterpart of lucille_tpu/parallel/ (SURVEY.md section 2.8): the
reference's pthread bucket queue (render.c:1043-1207) and its MPI
byte-collective layer (src/base/parallel.c:62-233) become static tile
rounds over a mesh of devices (mesh.py), whose slots may span processes
joined by torch.distributed (distributed.py), and host 0 owns the
displays (rank-0 display ownership, render.c:468-514).
"""

from lucille_tpu_torch.parallel.distributed import (
    all_gather_host,
    barrier,
    initialize_distributed,
    is_primary_host,
    process_count,
    process_index,
)
from lucille_tpu_torch.parallel.mesh import (
    make_mesh,
    render_frame_sharded,
    sharded_tile_batch,
)

__all__ = [
    "make_mesh",
    "sharded_tile_batch",
    "render_frame_sharded",
    "initialize_distributed",
    "is_primary_host",
    "process_count",
    "process_index",
    "barrier",
    "all_gather_host",
]
