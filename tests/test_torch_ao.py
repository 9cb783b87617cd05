"""AO gather: lane order, occlusion counts and the shading basis of the
port (plain torch twin on the CPU) against lucille_tpu's Pallas kernel in
interpret mode, fed JAX's own jitter draw.

Tolerances: lane orders are exact (the jitter is indexed by compacted
slot, so any difference would scramble it).  Occlusion counts equal on
>= 99% of lanes and within 1 elsewhere, the bound test_pallas_ao.py uses:
a stratum direction differs by an ulp where XLA's and torch's cos/sin
round differently.  Basis and normals within 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_intersect import _random_soup, _scene_from_tris
from test_torch_scene import one_torch_thread  # noqa: F401


def _soup(n_tris, seed=5):
    v0, v1, v2 = _random_soup(n_tris, seed=seed)
    return _scene_from_tris(v0, v1, v2, "pallas")


def _lanes(B, seed=1, quantize=False):
    """Shading points, unit normals, hit mask.  quantize=True snaps points
    to a coarse grid so many lanes share a Morton cell (exercises the
    stable sort's tie order)."""
    rng = np.random.default_rng(seed)
    P = rng.uniform(-4, 4, (B, 3))
    if quantize:
        P = np.round(P)
    N = rng.normal(size=(B, 3))
    N /= np.linalg.norm(N, axis=-1, keepdims=True)
    hit = rng.uniform(size=B) < 0.8
    return P.astype(np.float32), N.astype(np.float32), hit


# 400 triangles -> 512 padded -> 4 tiles: hit-first partition.
# 1100 -> 1280 -> 10 tiles: octant + Morton sort.
@pytest.mark.parametrize("n_tris,n_tiles", [(400, 4), (1100, 10)])
@pytest.mark.parametrize("quantize", [False, True])
def test_lane_orders_exact(n_tris, n_tiles, quantize):
    from lucille_tpu.accel.pallas_ao import compaction_order as jax_order
    from lucille_tpu.accel.pallas_ao import partition_order as jax_partition
    from lucille_tpu.transport.ao import ortho_basis
    from lucille_tpu_torch.accel.ao import compaction_order, partition_order
    from lucille_tpu_torch.scene.types import from_numpy

    sc = _soup(n_tris)
    assert -(-sc.tri_v0.shape[0] // 128) == n_tiles
    P, N, hit = _lanes(1000, quantize=quantize)
    b2 = np.array(ortho_basis(jnp.asarray(N))[2])
    o_ref, n_ref = jax_order(sc, jnp.asarray(P), jnp.asarray(b2),
                             jnp.asarray(hit), n_tiles)
    scene = from_numpy(sc, "cpu")
    order, nhit = compaction_order(scene.bbox_min, scene.bbox_max,
                                   torch.from_numpy(P), torch.from_numpy(b2),
                                   torch.from_numpy(hit), n_tiles)
    np.testing.assert_array_equal(order.numpy(), np.asarray(o_ref))
    assert int(nhit) == int(n_ref)
    o_ref, n_ref = jax_partition(jnp.asarray(hit))
    order, nhit = partition_order(torch.from_numpy(hit))
    np.testing.assert_array_equal(order.numpy(), np.asarray(o_ref))
    assert int(nhit) == int(n_ref)


@pytest.mark.parametrize(
    "n_tris,ntheta,nphi", [(700, 4, 4), (700, 3, 3), (1100, 4, 4)])
def test_ao_occlusion_matches_pallas(n_tris, ntheta, nphi):
    from lucille_tpu.accel.pallas_ao import pallas_ao_occlusion
    from lucille_tpu.transport.ao import ortho_basis
    from lucille_tpu_torch.accel import ao
    from lucille_tpu_torch.scene.types import from_numpy

    sc = _soup(n_tris)
    B = 256
    P, N, hit = _lanes(B)
    b0, b1, b2 = (np.array(b) for b in ortho_basis(jnp.asarray(N)))
    key = jax.random.key(7)
    ref = np.asarray(pallas_ao_occlusion(
        sc, jnp.asarray(P), jnp.asarray(b0), jnp.asarray(b1),
        jnp.asarray(b2), jnp.asarray(hit), key, ntheta, nphi, interpret=True))
    jitter = torch.from_numpy(
        np.array(jax.random.uniform(key, (2, B), dtype=jnp.float32)))
    ao.COUNTS.reset()
    t = torch.from_numpy
    got = ao.ao_occlusion(from_numpy(sc, "cpu"), t(P), t(b0), t(b1), t(b2),
                          t(hit), jitter, ntheta, nphi).numpy()
    assert (ao.COUNTS.kernel, ao.COUNTS.plain) == (0, 1)
    diff = np.abs(got - ref)
    assert diff.max() <= 1.0
    assert (diff != 0).mean() <= 0.01
    assert np.all(got[~hit] == 0)
    assert ref[hit].mean() > 0.5  # the case exercises occlusion


def test_pack_occ_and_super_boxes_match_jax():
    from lucille_tpu.accel.pallas_ao import _pack_occ
    from lucille_tpu.accel.pallas_isect import _pack_boxes, _pack_super_boxes
    from lucille_tpu_torch.accel.pack import (
        pack_boxes,
        pack_occ,
        pack_super_boxes,
    )
    from lucille_tpu_torch.scene.types import from_numpy

    sc = _soup(2500)  # 20 tiles -> 2 supertiles, the second ragged
    scene = from_numpy(sc, "cpu")
    tris, npad = _pack_occ(sc)
    got, want = pack_occ(scene).numpy(), np.asarray(tris)
    # vertices exact; XLA:CPU contracts the cross product's a*b - c*d into
    # an FMA, so the normal rows agree to one rounding of a product
    np.testing.assert_array_equal(got[:9], want[:9])
    np.testing.assert_array_equal(got[12:], want[12:])
    np.testing.assert_allclose(got[9:12], want[9:12], rtol=0, atol=1e-6)
    boxes = _pack_boxes(sc, npad)
    sboxes, n_super = _pack_super_boxes(boxes, npad // 128)
    assert n_super == 2
    np.testing.assert_array_equal(
        pack_super_boxes(pack_boxes(scene)).numpy(), np.asarray(sboxes))


def test_ortho_basis_and_interp_normal_close():
    from lucille_tpu.transport.ao import _interp_normal as jax_interp
    from lucille_tpu.transport.ao import ortho_basis as jax_basis
    from lucille_tpu_torch.scene.types import from_numpy
    from lucille_tpu_torch.transport.ao import _interp_normal, ortho_basis

    rng = np.random.default_rng(4)
    N = rng.normal(size=(2000, 3))
    N[:5] = [[0, 0, 1], [0, 0, -1], [1, 0, 0], [0, -1, 0], [0, 0, -0.99999]]
    N = (N / np.linalg.norm(N, axis=-1, keepdims=True)).astype(np.float32)
    for a, b in zip(ortho_basis(torch.from_numpy(N)), jax_basis(jnp.asarray(N))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)

    sc = _soup(300)
    res = {
        "tri": rng.integers(-1, 300, 500).astype(np.int32),
        "u": rng.uniform(0, 0.5, 500).astype(np.float32),
        "v": rng.uniform(0, 0.5, 500).astype(np.float32),
    }
    want = np.asarray(jax_interp(sc, {k: jnp.asarray(v) for k, v in res.items()}))
    got = _interp_normal(from_numpy(sc, "cpu"),
                         {k: torch.from_numpy(v) for k, v in res.items()})
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
