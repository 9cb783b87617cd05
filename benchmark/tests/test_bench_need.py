"""The frozen roofline yardstick (harness/need.py) against chip_smoke.py's
originals on tiny scenes: the same counts, the same bounds."""

from __future__ import annotations

import pytest
import torch

import bench_tiny  # noqa: F401  (puts the repo and the benchmark on sys.path)
import chip_smoke as cs
from harness import need


@pytest.fixture(scope="module")
def dense_inputs():
    from lucille_tpu_torch.render.renderer import Renderer, tile_eye_rays
    from lucille_tpu_torch.accel.dispatch import closest_hit
    from lucille_tpu_torch.transport.ao import shading_frame

    torch.manual_seed(0)
    r = Renderer(cs.bundled_state(32, 24, 1, 16, sunsky=False).scene,
                 tile_size=16, device="cpu")
    sub = torch.tensor([[0.5, 0.5]], dtype=torch.float32)
    org, dirn = tile_eye_rays(r.camera, 8, 8, 16, 16, sub)
    res = closest_hit(r.scene, org, dirn)
    P_off, b0, b1, b2 = shading_frame(r.scene, org, dirn, res)
    hl = torch.nonzero(res["hit"])[:, 0]
    u01 = torch.rand(2, hl.numel())
    return r.scene, P_off[hl], b0[hl], b1[hl], b2[hl], u01


def test_constants_are_chip_smokes():
    assert (need.PEAK_FLOPS, need.PEAK_BYTES) == (cs.PEAK_FLOPS,
                                                  cs.PEAK_BYTES)
    assert (need.MT_OPS, need.SV_OPS, need.AO_OPS, need.SLAB_OPS,
            need.NODE_OPS) == (cs.MT_OPS, cs.SV_OPS, cs.AO_OPS, cs.SLAB_OPS,
                               cs.NODE_OPS)
    assert need.N_NEED == cs.N_NEED
    for nbytes, ops in ((1e6, 1e9), (1e9, 1e6), (0.0, 0.0)):
        assert need.bound(nbytes, ops) == cs.bound(nbytes, ops)


def test_gather_need_equals_chip_smokes(dense_inputs):
    scene, P_off, b0, b1, b2, u01 = dense_inputs
    ours = need.gather_need(scene, P_off, b0, b1, b2, u01, 4, 4)
    theirs = cs.gather_need(scene, P_off, b0, b1, b2, u01, 4, 4)
    assert ours["tests"] > 0
    for k in ("tiles", "groups", "tests"):
        assert ours[k] == theirs[k]
    assert torch.equal(ours["occluded"], theirs["occluded"])
    far = torch.full((P_off.shape[0],), float("inf"))
    assert torch.equal(need.tiles_reached(scene.boxes, P_off, b2, far),
                       cs.tiles_reached(scene.boxes, P_off, b2, far))


def test_need_walk_equals_chip_smokes():
    from lucille_tpu_torch.render.renderer import Renderer

    r = Renderer(cs.heightfield_state(24, 16, 12, 1, 4, accel="bvh").scene,
                 tile_size=16, device="cpu")
    scene = r.scene
    g = torch.Generator().manual_seed(5)
    org = torch.rand(512, 3, generator=g) * 8.0 - 4.0
    org[:, 1] = 2.0
    dirn = torch.nn.functional.normalize(
        torch.rand(512, 3, generator=g) - torch.tensor([0.5, 1.0, 0.5]),
        dim=1)
    for closest in (True, False):
        ours = need.need_walk(scene.tris, scene.nodes, org, dirn, closest,
                              scene.tree_depth)
        theirs = cs.need_walk(scene.tris, scene.nodes, org, dirn, closest,
                              scene.tree_depth)
        assert ours["tests"] > 0 and ours["hit"].any()
        for k, v in theirs.items():
            if torch.is_tensor(v):
                assert torch.equal(ours[k], v), k
            else:
                assert ours[k] == v, k
        assert need.reached_bytes(ours) == cs.reached_bytes(theirs)
