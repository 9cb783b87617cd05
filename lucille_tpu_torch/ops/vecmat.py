"""Vector and 4x4-matrix math.

Conventions (identical to the reference so scene ingest is bit-compatible
at the math level):

- Matrices are stored row-major; vectors are ROW vectors; transforming a
  point computes ``p' = p @ M`` (reference src/base/vector.h:182-205).
- ``mat4_mul(a, b)`` returns ``a @ b`` (reference src/base/matrix.c:40-55),
  so a row vector transformed by the product applies ``a`` first, then ``b``.
- RenderMan ``ConcatTransform M`` updates ``CTM = M @ CTM``
  (reference src/ri/transform.c:54-66), i.e. new transforms apply first.

The port's copy of lucille_tpu/ops/vecmat.py, NumPy only: the
original's sniff for JAX arrays (its ``_xp``) is gone, the rest is the
same code.  The port uses it for the host scene graph (float64).
"""

from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# Vectors — shape (..., 3)
# ---------------------------------------------------------------------------


def dot(a, b, keepdims: bool = False):
    return (a * b).sum(axis=-1, keepdims=keepdims)


def cross(a, b):
    return np.cross(a, b)


def normalize(v, eps: float = 1e-20):
    n2 = (v * v).sum(axis=-1, keepdims=True)
    return v * np.where(n2 > eps, 1.0 / np.sqrt(np.maximum(n2, eps)), 0.0)


def length(v):
    return np.sqrt((v * v).sum(axis=-1))


# ---------------------------------------------------------------------------
# 4x4 matrices — host-side NumPy float64 unless noted
# ---------------------------------------------------------------------------


def mat4_identity() -> np.ndarray:
    return np.eye(4, dtype=np.float64)


def mat4_mul(a, b):
    """Return a @ b (row-vector convention: a applies first)."""
    return a @ b


def mat4_inverse(m):
    return np.linalg.inv(m)


def mat4_translate(x: float, y: float, z: float) -> np.ndarray:
    """Row-vector translation matrix: p' = p @ T puts translation in row 3."""
    m = mat4_identity()
    m[3, 0:3] = (x, y, z)
    return m


def mat4_scale(sx: float, sy: float, sz: float) -> np.ndarray:
    m = mat4_identity()
    m[0, 0], m[1, 1], m[2, 2] = sx, sy, sz
    return m


def mat4_rotate(angle_deg: float, ax: float, ay: float, az: float) -> np.ndarray:
    """RenderMan Rotate: rotation about an axis, row-vector convention.

    Mirrors reference src/base/matrix.c:86 (quaternion-based); built here
    from the Rodrigues formula.
    """
    axis = np.array([ax, ay, az], dtype=np.float64)
    n = np.linalg.norm(axis)
    if n == 0.0:
        return mat4_identity()
    x, y, z = axis / n
    th = np.deg2rad(angle_deg)
    c, s = np.cos(th), np.sin(th)
    C = 1.0 - c
    # Column-vector rotation matrix R (p' = R p); transpose for row vectors.
    R = np.array(
        [
            [c + x * x * C, x * y * C - z * s, x * z * C + y * s],
            [y * x * C + z * s, c + y * y * C, y * z * C - x * s],
            [z * x * C - y * s, z * y * C + x * s, c + z * z * C],
        ]
    )
    m = mat4_identity()
    m[:3, :3] = R.T
    return m


def mat4_from_rib(values) -> np.ndarray:
    """RIB Transform/ConcatTransform 16-float list → row-major 4x4.

    RIB serializes matrices row-major in row-vector convention, which is
    exactly our storage: no transpose needed (translation lands in row 3,
    matching e.g. examples/ambient_occlusion/ambient_occlusion.rib).
    """
    m = np.asarray(values, dtype=np.float64).reshape(4, 4)
    return m


# ---------------------------------------------------------------------------
# Point / vector / normal transforms (row-vector: p' = p @ M)
# ---------------------------------------------------------------------------


def transform_point(p, m):
    """Transform points (..., 3) by 4x4 m with translation (w assumed 1)."""
    return p @ m[:3, :3] + m[3, :3]


def transform_vector(v, m):
    """Transform directions (..., 3): rotation/scale only, no translation."""
    return v @ m[:3, :3]


def transform_normal(n, m):
    """Transform normals by the inverse-transpose of the upper-left 3x3.

    Matches the reference's normal path (src/render/polygon.c:183 uses the
    inverse-transpose matrix `itm`).  Callers normalize afterwards.
    """
    inv = np.linalg.inv(np.asarray(m[:3, :3], dtype=np.float64))
    # row vector n' = n @ inv(M)^T  ==  (inv(M) @ n^T)^T
    return n @ np.asarray(inv.T, dtype=n.dtype if hasattr(n, "dtype") else None)
