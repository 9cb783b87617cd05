"""Dense closest hit: the port (plain torch twin on the CPU) against
lucille_tpu's Pallas kernel in interpret mode.

Tolerances: hit mask and triangle id exact except at near-ties (at most
0.5% of rays), t/u/v within 1e-5 where both agree on the triangle — the
two evaluate the same f32 Moller-Trumbore chain, XLA and torch may still
round a product or a reciprocal differently.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_intersect import _random_soup, _scene_from_tris
from test_torch_scene import bundled_state
from test_torch_scene import one_torch_thread  # noqa: F401


def _soup_scene():
    v0, v1, v2 = _random_soup(700, seed=5)
    return _scene_from_tris(v0, v1, v2, "pallas")


def _soup_rays(B, seed=0):
    """Rays from a shell around the soup aimed into it (most of them hit)."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(B, 3))
    o = 12.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = rng.uniform(-4, 4, (B, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _eye_rays(B):
    """B eye rays of the bundled scene around the image centre, 2x2
    subpixel samples, from the port's ray generator."""
    from lucille_tpu_torch.ri.camera import generate_rays

    cam = bundled_state(640, 480).camera
    rng = np.random.default_rng(1)
    px = rng.uniform(250, 390, B).astype(np.float32)
    py = rng.uniform(180, 300, B).astype(np.float32)
    o, d = generate_rays(cam, torch.from_numpy(px), torch.from_numpy(py))
    return o.numpy(), d.numpy()


CASES = {
    "soup700": lambda: (_soup_scene(), *_soup_rays(512)),
    "bundled_eye": lambda: (
        _scene_from_desc(bundled_state(pkg="jax").scene), *_eye_rays(512)),
}


def _scene_from_desc(desc):
    from lucille_tpu.scene.compile import compile_scene

    return compile_scene(desc).device_put()


def _compare(ref, got, max_tie_frac=0.005, tol=1e-5):
    hit_r = np.asarray(ref["hit"])
    tri_r = np.asarray(ref["tri"])
    hit = got["hit"].numpy()
    tri = got["tri"].numpy()
    differ = (hit != hit_r) | (hit & (tri != tri_r))
    assert differ.mean() <= max_tie_frac, differ.sum()
    same = hit & hit_r & (tri == tri_r)
    for k in ("t", "u", "v"):
        np.testing.assert_allclose(got[k].numpy()[same],
                                   np.asarray(ref[k])[same], rtol=tol, atol=tol)
    return hit_r.mean()


@pytest.mark.parametrize("case", sorted(CASES))
def test_closest_hit_matches_pallas(case):
    from lucille_tpu.accel.pallas_isect import pallas_closest_hit
    from lucille_tpu_torch.accel import isect
    from lucille_tpu_torch.accel.dispatch import closest_hit
    from lucille_tpu_torch.scene.types import from_numpy

    sc, o, d = CASES[case]()
    ref = pallas_closest_hit(sc, jnp.asarray(o), jnp.asarray(d), interpret=True)
    scene = from_numpy(sc, "cpu")
    isect.COUNTS.reset()
    got = closest_hit(scene, torch.from_numpy(o), torch.from_numpy(d))
    assert (isect.COUNTS.kernel, isect.COUNTS.plain) == (0, 1)
    hit_rate = _compare(ref, got)
    assert hit_rate > 0.2  # the case exercises hits, not just misses
    # a ragged wavefront (B not a multiple of any block) gives the same
    # answers for the lanes it has
    part = closest_hit(scene, torch.from_numpy(o[:300]),
                       torch.from_numpy(d[:300]))
    for k in ("t", "u", "v", "tri", "hit"):
        assert torch.equal(part[k], got[k][:300]), k


def test_pack_tris_and_boxes_match_jax():
    from lucille_tpu.accel.pallas_isect import _pack, _pack_boxes
    from lucille_tpu_torch.accel.pack import pack_boxes, pack_tris
    from lucille_tpu_torch.scene.types import from_numpy

    for sc in (_soup_scene(),
               _scene_from_desc(bundled_state(pkg="jax").scene)):
        scene = from_numpy(sc, "cpu")
        tris, npad = _pack(sc)
        np.testing.assert_array_equal(pack_tris(scene).numpy(),
                                      np.asarray(tris))
        np.testing.assert_array_equal(pack_boxes(scene).numpy(),
                                      np.asarray(_pack_boxes(sc, npad)))


def test_tie_goes_to_the_lowest_index():
    """Two identical triangles: the hit reports the lower index, within a
    tile and across tiles."""
    from lucille_tpu_torch.accel.isect import closest_hit_reference
    from lucille_tpu_torch.accel.pack import TC

    tris = torch.zeros((16, 2 * TC))
    tri = [[-1, -1, 5], [2, 0, 0], [0, 2, 0]]  # v0, e1, e2
    for col in (7, 100, TC + 3):
        for r in range(3):
            tris[3 * r : 3 * r + 3, col] = torch.tensor(tri[r], dtype=torch.float32)
    org = torch.tensor([[-0.5, -0.5, 0.0]])
    dirn = torch.tensor([[0.0, 0.0, 1.0]])
    res = closest_hit_reference(tris, org, dirn)
    assert int(res["tri"][0]) == 7 and float(res["t"][0]) == 5.0


def test_kernel_launchers_refuse_cpu_tensors():
    """The CUDA launchers never take host pointers; the wrappers route CPU
    tensors to the plain twins instead."""
    from lucille_tpu_torch.accel.ao import ao_occlusion_kernel
    from lucille_tpu_torch.accel.isect import closest_hit_kernel

    with pytest.raises(ValueError, match="CUDA"):
        closest_hit_kernel(torch.zeros((16, 128)), torch.zeros((8, 1)),
                           torch.zeros((4, 3)), torch.zeros((4, 3)))
    with pytest.raises(ValueError, match="CUDA"):
        # the rays' device is checked before the scene's packs are read
        ao_occlusion_kernel(None, torch.zeros((12, 4)), torch.zeros((2, 4)),
                            torch.tensor(4), 2, 2)
