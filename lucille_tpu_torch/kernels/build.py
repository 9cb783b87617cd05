"""Build and bind the hand-written CUDA kernels.

The sources under lucille_tpu_torch/csrc/ have a plain C interface.  At
first use each is compiled with nvcc for sm_90a into an object file, all
of them at once in parallel processes, and the objects are linked into
one shared library under lucille_tpu_torch/_build/<source hash>/, loaded
with ctypes; a library already built from the same sources is reused.
Every pointer and the stream cross as c_void_p; every entry point
returns cudaGetLastError() after its launch, and `check` raises on
anything but 0.

`--fmad=false` keeps nvcc from contracting a*b+c into one rounding, so
the kernels round exactly as their plain torch twins do.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR / "_build"
SOURCES = ("isect.cu", "ao.cu", "bvh.cu", "ugrid.cu")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH, "-std=c++17", "-O3", "--fmad=false",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
SIGNATURES = {
    # org, dir, tmax, active, B, tris, npad, n_tris, boxes, n_tiles,
    # sboxes, n_super, sub, chunks, per_chunk, t, u, v, tri, keys, stats,
    # stream
    "lt_closest_hit": (_P, _P, _P, _P, _I, _P, _I, _I, _P, _I, _P, _I, _P,
                       _I, _I, _P, _P, _P, _P, _P, _P, _P),
    # org, dir, tmax, active, B, tris, npad, n_tris, boxes, n_tiles,
    # sboxes, n_super, sub, chunks, per_chunk, occ, stats, stream
    "lt_any_hit": (_P, _P, _P, _P, _I, _P, _I, _I, _P, _I, _P, _I, _P, _I,
                   _I, _P, _P, _P),
    # rays, jitter, B, nact, tris, npad, n_tris, boxes, n_tiles, sboxes,
    # n_super, sub, ntheta, nphi, inv_ntheta, inv_nphi, chunk, tpl, grid,
    # occ, bits, stats, stream
    "lt_ao_occlusion": (_P, _P, _I, _P, _P, _I, _I, _P, _I, _P, _I, _P,
                        _I, _I, _F, _F, _I, _I, _I, _P, _P, _P, _P),
    # rays, jitter, bits, B, nact, ntheta, nphi, inv_ntheta, inv_nphi,
    # params, nparams, col, counters, stream
    "lt_sky_gather": (_P, _P, _P, _I, _P, _I, _I, _F, _F, _P, _I, _P, _P,
                      _P),
    # org, dir, tmax, active, B, tris, npad, nodes, leaf_real, depth, t,
    # u, v, tri, stats, stream
    "lt_bvh_closest_hit": (_P, _P, _P, _P, _I, _P, _I, _P, _P, _I, _P, _P,
                           _P, _P, _P, _P),
    # org, dir, tmax, B, tris, npad, nodes, leaf_real, occ, stats, stream
    "lt_bvh_any_hit": (_P, _P, _P, _I, _P, _I, _P, _P, _P, _P, _P),
    # rays, jitter, B, nact, tris, npad, nodes, leaf_real, perm, S, K,
    # warps, ntheta, inv_ntheta, inv_nphi, occ, stats, stream
    "lt_bvh_ao_fused": (_P, _P, _I, _P, _P, _I, _P, _P, _P, _I, _I, _I,
                        _I, _F, _F, _P, _P, _P),
    # org, dir, tmax, active, B, tris, cell_start, occupied, box, res,
    # lanes, t, u, v, tri, stats, counters, stream
    "lt_grid_closest_hit": (_P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I,
                            _P, _P, _P, _P, _P, _I, _P),
    # org, dir, tmax, active, B, tris, cell_start, occupied, box, res,
    # lanes, occ, stats, counters, stream
    "lt_grid_any_hit": (_P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _P, _P,
                        _I, _P),
}


@dataclass
class LaunchCounts:
    """Launches of a wrapper's kernel, and calls of its plain twin."""

    kernel: int = 0
    plain: int = 0

    def reset(self) -> None:
        self.kernel = 0
        self.plain = 0


@dataclass
class Library:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when a cached build was loaded
    log: str  # nvcc's output (ptxas register and shared-memory report)


_library: Library | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> tuple[Path, float, str]:
    """Compile the sources unless this exact build exists; returns
    (library path, seconds spent compiling and linking, nvcc log)."""
    out_dir = BUILD_ROOT / _source_hash()
    so = out_dir / "liblucille_kernels.so"
    log_path = out_dir / "build.log"
    if so.exists():
        return so, 0.0, log_path.read_text() if log_path.exists() else ""
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f".tmp-{os.getpid()}"
    objs = [out_dir / f"{Path(s).stem}{tag}.o" for s in SOURCES]
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC / s)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for s, o in zip(SOURCES, objs)
    ]
    logs = [p.communicate()[0] for p in procs]
    log = "".join(logs)
    failed = [s for s, p in zip(SOURCES, procs) if p.returncode != 0]
    tmp = out_dir / f"liblucille_kernels{tag}.so"
    if not failed:
        proc = subprocess.run(
            [nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            failed = ["link"]
    seconds = time.perf_counter() - t0
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{log}")
    log_path.write_text(log)
    os.replace(tmp, so)
    return so, seconds, log


def library() -> Library:
    """The loaded kernel library, built on first call in this process."""
    global _library
    if _library is None:
        path, seconds, log = build()
        lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.lt_error_string.argtypes = [ctypes.c_int]
        lib.lt_error_string.restype = ctypes.c_char_p
        _library = Library(lib, path, seconds, log)
    return _library


def check(name: str, err: int) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        text = library().lib.lt_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({text})")
