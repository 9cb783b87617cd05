"""ctypes loader + on-demand g++ compilation for native components.

The port's copy of lucille_tpu/native/loader.py: the same code, with its
imports pointed at lucille_tpu_torch's own host modules, and its build
cache in the port's gitignored lucille_tpu_torch/_build/native/ (the
original builds into $LUCILLE_NATIVE_CACHE or the system temp directory),
each library compiled under a private name and then renamed into place.
The sources are the repository's native/*.cpp, which belong to neither
package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from lucille_tpu_torch.base.log import LOG_INFO, LOG_WARN, log, log_once

_REPO_ROOT = Path(__file__).resolve().parents[2]
_SRC = _REPO_ROOT / "native" / "bvh_builder.cpp"

_lib = None
_lib_tried = False
_libs: dict = {}


def _cache_dir() -> Path:
    d = Path(__file__).resolve().parents[1] / "_build" / "native"
    d.mkdir(parents=True, exist_ok=True)
    return d


def get_lib(name: str):
    """Compile (once, content-hashed cache) and dlopen native/<name>.cpp.
    Returns the ctypes CDLL, or None when the toolchain/source is absent
    — callers fall back to their pure-Python paths (the same graceful
    degradation the reference gets from optional libs like libjpeg)."""
    if name in _libs:
        return _libs[name]
    _libs[name] = None
    src = _REPO_ROOT / "native" / f"{name}.cpp"
    if not src.exists():
        return None
    tag = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    so = _cache_dir() / f"lib{name}_{tag}.so"
    if not so.exists():
        # built under a private name and renamed, so a process that finds
        # the library never finds it half written
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [
            "g++", "-O3", "-shared", "-fPIC", "-std=c++17",
            "-o", str(tmp), str(src),
        ]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)
            log(LOG_INFO, "compiled native %s -> %s", name, so)
        except (subprocess.CalledProcessError, FileNotFoundError,
                subprocess.TimeoutExpired) as e:
            log_once(LOG_WARN, "native %s unavailable (%s); using Python",
                     name, type(e).__name__)
            return None
    try:
        _libs[name] = ctypes.CDLL(str(so))
    except OSError:
        return None
    return _libs[name]


def get_rgbe_lib():
    """Native RGBE RLE codec (native/rgbe_codec.cpp) with argtypes set."""
    lib = get_lib("rgbe_codec")
    if lib is None or hasattr(lib, "_rgbe_ready"):
        return lib
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.rgbe_encode_scanlines.restype = ctypes.c_long
    lib.rgbe_encode_scanlines.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, u8p, ctypes.c_long
    ]
    lib.rgbe_decode_scanlines.restype = ctypes.c_long
    lib.rgbe_decode_scanlines.argtypes = [
        u8p, ctypes.c_long, ctypes.c_int, ctypes.c_int, u8p
    ]
    lib._rgbe_ready = True
    return lib


def get_bvh_lib():
    """Compile (once) and load the native BVH builder; None if unavailable."""
    global _lib, _lib_tried
    if _lib is not None or _lib_tried:
        return _lib
    _lib_tried = True
    lib = get_lib("bvh_builder")
    if lib is None:
        return None
    lib.lucille_build_bvh.restype = ctypes.c_int
    lib.lucille_build_bvh.argtypes = [
        ctypes.POINTER(ctypes.c_float),  # v0
        ctypes.POINTER(ctypes.c_float),  # v1
        ctypes.POINTER(ctypes.c_float),  # v2
        ctypes.c_int64,  # n_tris
        ctypes.c_int,  # leaf_size
        ctypes.POINTER(ctypes.c_float),  # bbmin
        ctypes.POINTER(ctypes.c_float),  # bbmax
        ctypes.POINTER(ctypes.c_int32),  # skip
        ctypes.POINTER(ctypes.c_int32),  # first
        ctypes.POINTER(ctypes.c_int32),  # count
        ctypes.POINTER(ctypes.c_int64),  # order
    ]
    _lib = lib
    return _lib


def native_build_bvh(v0, v1, v2, leaf_size: int = 8):
    """Build a BVH with the C++ builder; returns the same tuple layout as
    accel.bvh.BVH or None when the native path is unavailable."""
    lib = get_bvh_lib()
    if lib is None:
        return None
    n = len(v0)
    v0 = np.ascontiguousarray(v0, dtype=np.float32)
    v1 = np.ascontiguousarray(v1, dtype=np.float32)
    v2 = np.ascontiguousarray(v2, dtype=np.float32)
    max_nodes = max(2 * n, 1)
    bbmin = np.empty((max_nodes, 3), dtype=np.float32)
    bbmax = np.empty((max_nodes, 3), dtype=np.float32)
    skip = np.empty(max_nodes, dtype=np.int32)
    first = np.empty(max_nodes, dtype=np.int32)
    count = np.empty(max_nodes, dtype=np.int32)
    order = np.empty(n, dtype=np.int64)

    fptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    i32ptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    i64ptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))

    m = lib.lucille_build_bvh(
        fptr(v0), fptr(v1), fptr(v2),
        ctypes.c_int64(n), ctypes.c_int(leaf_size),
        fptr(bbmin), fptr(bbmax), i32ptr(skip), i32ptr(first),
        i32ptr(count), i64ptr(order),
    )
    if m <= 0:
        return None
    return (
        bbmin[:m].copy(),
        bbmax[:m].copy(),
        skip[:m].copy(),
        first[:m].copy(),
        count[:m].copy(),
        order,
    )
