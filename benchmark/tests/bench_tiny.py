"""A checkout of the benchmark at a size a CPU test holds: BENCHMARK.json
and benchmark/{configs,traffic,metrics} copied into a temporary root,
the configurations cut to 48x36 pixels, 2x2 subsamples, 16 AO rays and
a 40 x 40 terrain, tiles of 16, every pixel of the drawn frames checked.
The terrain's 3,042 triangles stay on the tile BVH, as the full one's
are, with the port's and the reference's switch from dense tiles to the
tile BVH lowered to TINY_DENSE_MAX_TRIS for the test (the bundled
scene's 322 stay on dense tiles): the harness itself leaves the accel to
the port, as a user's RIB does."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = {"xres": 48, "yres": 36, "pixel_samples": 2, "gather_rays": 16}
TERRAIN_N = 40
TINY_DENSE_MAX_TRIS = 1024


def lower_dense_limit() -> None:
    """The tiny terrain on the tile BVH, in the port and the reference."""
    from lucille_tpu_torch.scene import compile as port_compile
    from reference import ao

    port_compile.AUTO_DENSE_MAX_TRIS = TINY_DENSE_MAX_TRIS
    ao.DENSE_MAX_TRIS = TINY_DENSE_MAX_TRIS


def make_root(dst: Path) -> Path:
    lower_dense_limit()
    (dst / "benchmark").mkdir(parents=True)
    for d in ("configs", "traffic", "metrics"):
        shutil.copytree(BENCH / d, dst / "benchmark" / d)
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    for p in (dst / "benchmark" / "configs").glob("*.json"):
        cfg = json.loads(p.read_text())
        cfg.update(TINY)
        if cfg["scene"] == "heightfield":
            cfg.update(n=TERRAIN_N)
        p.write_text(json.dumps(cfg))
    for p in (dst / "benchmark" / "traffic").glob("*.json"):
        tr = json.loads(p.read_text())
        tr["tile"] = 16
        tr["traced_frames"] = 1
        tr["check"]["pixels"] = TINY["xres"] * TINY["yres"]  # all of them
        p.write_text(json.dumps(tr))
    return dst


def run(root: Path, workload: str, seed: int = 3_000_000_017,
        seconds: float = 1.0, trace: int = 0) -> dict:
    """One run of `workload` in the checkout at root, on the CPU."""
    import time

    from harness.cell import parse, run_cell

    args = parse(["--workload", workload, "--seed", str(seed),
                  "--seconds", str(seconds), "--trace", str(trace)])
    return run_cell(args, time.perf_counter(), root, device="cpu")
