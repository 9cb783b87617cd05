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
    from lucille_tpu_torch.scene.types import from_numpy

    scene = from_numpy(_soup_scene(), "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        closest_hit_kernel(scene, torch.zeros((4, 3)), torch.zeros((4, 3)))
    with pytest.raises(ValueError, match="CUDA"):
        # the rays' device is checked before the scene's packs are read
        ao_occlusion_kernel(None, torch.zeros((12, 4)), torch.zeros((2, 4)),
                            torch.tensor(4), 2, 2)


@pytest.mark.parametrize("B,n_tris,n_sms,want", [
    (518400, 322, 132, (1, 1)),  # the headline tile: one supertile
    (1048576, 16200, 132, (1, 8)),  # 8,192 blocks: the rays fill the card
    (518400, 16200, 132, (2, 4)),  # 4,050 blocks: two chunks
    (6400, 132098, 132, (65, 1)),  # the dense strata scan's wavefront
    (65536, 16200, 132, (8, 1)),  # a heightfield91 tile, 512 blocks
    (65536, 16200, 64, (4, 2)),  # the same on a card of 64 SMs
    (256, 13000, 132, (7, 1)),  # few rays: a chunk a supertile
    (100, 2048, 132, (1, 1)),  # one supertile: nothing to split
    (0, 0, 132, (1, 1)),
])
def test_split_layout(B, n_tris, n_sms, want):
    """The kernels' split of the triangle range, from shapes alone: every
    real supertile in exactly one chunk, no chunk empty."""
    from lucille_tpu_torch.accel.isect import split_layout
    from lucille_tpu_torch.accel.pack import SUPER, TC

    chunks, per = split_layout(B, n_tris, n_sms)
    assert (chunks, per) == want
    n_super = -(-(-(-n_tris // TC)) // SUPER)
    assert chunks * per >= n_super and (chunks - 1) * per < max(n_super, 1)


def test_empty_boxes_stay_empty():
    """Tiles and 8-triangle groups of padding alone get empty boxes (min
    +inf, max -inf), which the kernels' slab test never reaches; every box
    around a real triangle holds it.  322 triangles padded to 512: tile 2
    is partly padding, tile 3 padding alone."""
    from lucille_tpu_torch.accel.pack import (
        SUB,
        TC,
        pack_boxes,
        pack_super_boxes,
    )
    from lucille_tpu_torch.scene.compile import compile_scene

    scene = compile_scene(bundled_state().scene, "cpu")
    assert (scene.n_tris, scene.n_pad) == (322, 512)
    for tc, boxes in ((TC, scene.boxes), (SUB, scene.sub_boxes)):
        assert torch.equal(boxes, pack_boxes(scene, tc))
        n_real = -(-scene.n_tris // tc)
        empty = (boxes[0:3] > boxes[3:6]).all(dim=0)
        assert not empty[:n_real].any() and empty[n_real:].all()
        assert torch.all(boxes[0:3, n_real:] == float("inf"))
        assert torch.all(boxes[3:6, n_real:] == float("-inf"))
    assert torch.equal(scene.sboxes, pack_super_boxes(scene.boxes))
    # every real triangle inside its group's box
    v = [scene.tri_v0, scene.tri_v0 + scene.tri_e1,
         scene.tri_v0 + scene.tri_e2]
    g = torch.arange(scene.n_tris) // SUB
    for p in v:
        assert torch.all(p[:scene.n_tris] >= scene.sub_boxes[0:3, g].T)
        assert torch.all(p[:scene.n_tris] <= scene.sub_boxes[3:6, g].T)


def test_twins_count_every_live_slot():
    """On the CPU the wrappers run the twins: no group visited, every
    slot tested by every live ray."""
    from lucille_tpu_torch.accel import isect
    from lucille_tpu_torch.scene.types import from_numpy

    scene = from_numpy(_soup_scene(), "cpu")
    o, d = (torch.from_numpy(a) for a in _soup_rays(100))
    active = torch.arange(100) % 3 == 0
    for res in (isect.closest_hit(scene, o, d, active=active),
                isect.any_hit(scene, o, d, None, active, counters=True)):
        assert int(res["ntrav"]) == 0
        assert int(res["ntests"]) == 34 * scene.n_pad
    # the any-hit counts only when asked
    assert set(isect.any_hit(scene, o, d, None, active)) == {"occ"}


def _walk_boxes_one(sc, o, d, tmax):
    """One ray (o, d: (3,) f32) down the dense scene's boxes, every box
    it reaches before tmax opened: (box tests, triangle tests at group
    grain, at tile grain), the counts chip_smoke.dense_need charges."""
    f32 = np.float32
    n_tris = sc.n_tris
    n_tiles, n_groups = -(-n_tris // 128), -(-n_tris // 8)
    inv = f32(1) / np.where(np.abs(d) > f32(1e-20), d, f32(1e-20))

    def reaches(box, k):
        if np.any(box[0:3, k] > box[3:6, k]):
            return False
        t0, t1 = (box[0:3, k] - o) * inv, (box[3:6, k] - o) * inv
        tn, tf = np.minimum(t0, t1).max(), np.maximum(t0, t1).min()
        return bool(tn <= tf and tf > 0 and tn < tmax)

    boxes, sboxes, sub = (b.numpy() for b in (sc.boxes, sc.sboxes,
                                              sc.sub_boxes))
    slabs = groups = tiles = 0
    for s in range(-(-n_tiles // 16)):
        slabs += 1
        if not reaches(sboxes, s):
            continue
        for k in range(16 * s, min(16 * s + 16, n_tiles)):
            slabs += 1
            if not reaches(boxes, k):
                continue
            tiles += min(128, n_tris - 128 * k)
            for g in range(16 * k, min(16 * k + 16, n_groups)):
                slabs += 1
                if reaches(sub, g):
                    groups += min(8, n_tris - 8 * g)
    return slabs, groups, tiles


def test_dense_need_counts_the_box_hierarchy():
    """chip_smoke.dense_need, the work kernels 1 and 2's bound charges,
    equals a walk of one ray at a time down the supertile, tile and
    group boxes (a box test for each real box under a reached one, the
    real triangles of each reached group); an occluded ray costs 3 box
    tests and 1 triangle test, a dead ray nothing."""
    from chip_smoke import dense_need

    from lucille_tpu_torch.scene.types import from_numpy

    v0, v1, v2 = _random_soup(2500, seed=5)  # 20 tiles, 2 supertiles
    scene = from_numpy(_scene_from_tris(v0, v1, v2, "pallas"), "cpu")
    B = 60
    o, d = _soup_rays(B, seed=2)
    rng = np.random.default_rng(4)
    tmax = rng.uniform(6, 30, B).astype(np.float32)
    tmax[:10] = np.inf
    live = rng.uniform(size=B) < 0.8
    occluded = live & (rng.uniform(size=B) < 0.3)
    walks = [(0, 0, 0) if not live[i] else (3, 1, 1) if occluded[i]
             else _walk_boxes_one(scene, o[i], d[i], tmax[i])
             for i in range(B)]
    got = dense_need(scene, torch.from_numpy(o), torch.from_numpy(d),
                     torch.from_numpy(tmax), torch.from_numpy(live),
                     torch.from_numpy(occluded))
    assert (got["slabs"], got["groups"], got["tiles"]) == tuple(
        sum(w[j] for w in walks) for j in range(3))
    # the culls: below every box and every real triangle for every ray
    n_boxes = 2 + 20 + -(-2500 // 8)
    assert 0 < got["slabs"] < 0.8 * n_boxes * live.sum()
    assert 0 < got["groups"] <= got["tiles"] < 0.8 * 2500 * live.sum()
