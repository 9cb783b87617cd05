"""The plain reference: on scenes whose answer is known by hand, and
against the port's CPU frames of both configurations at a tiny size."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from bench_tiny import make_root, run

from harness.scenes import reference_scene
from reference import ao
from reference.rib import read_rib
from reference.streams import stream_seed

BUNDLED_CAMERA = """Projection "perspective" "fov" [45.0]
Orientation "rh"
ConcatTransform [0.994530 0.008385 -0.104111 0.000000 0.052799 0.819679 0.570385 0.000000 0.090120 -0.572762 0.814753 0.000000 -0.000009 -0.000015 -15.529361 1.000000 ]
"""


def quad(y, half, up=True):
    """Two triangles of the square |x|, |z| <= half at height y, their
    face normal +y (up) or -y."""
    a = np.array([[-half, y, -half], [-half, y, half], [half, y, half]],
                 np.float32)
    b = np.array([[-half, y, -half], [half, y, half], [half, y, -half]],
                 np.float32)
    tris = np.stack([a, b])
    if not up:
        tris = tris[:, ::-1]
    return [tris[:, i] for i in range(3)]


def frame_of(width=24, height=18):
    rs = read_rib(BUNDLED_CAMERA)
    cam = ao.Camera.make(rs.fov, rs.rh, rs.world_to_camera, width, height)
    return ao.Frame(cam, 2, 2, 4, 4, 8)


def all_pixels(frame):
    return np.stack(np.meshgrid(np.arange(frame.width),
                                np.arange(frame.height)), -1).reshape(-1, 2)


@pytest.mark.parametrize("half", [1e4, 2.0])
def test_a_lone_floor_is_open_wherever_it_is_seen(half):
    """Every subsample that meets the floor sees all of its strata open
    (1), every other one the background (0): a pixel is the share of its
    4 subsamples on the floor."""
    frame = frame_of()
    scene = ao.Scene(*quad(0.0, half))
    assert np.allclose(scene.normal, [0.0, 1.0, 0.0])
    got = ao.render_pixels(scene, frame, 123, all_pixels(frame), "cpu")
    assert set(np.unique(got)) <= {0.0, 0.25, 0.5, 0.75, 1.0}
    if half > 100:  # the camera looks down: the floor fills the frame
        assert np.array_equal(got, np.ones_like(got))
    else:
        assert (got == 1.0).any() and (got == 0.0).any()


def test_a_floor_under_a_ceiling_is_closed_everywhere():
    frame = frame_of()
    floor = quad(0.0, 1e4)
    ceiling = quad(20.0, 1e4, up=False)
    scene = ao.Scene(*(np.concatenate([f, c]) for f, c in zip(floor,
                                                                ceiling)))
    got = ao.render_pixels(scene, frame, 321, all_pixels(frame), "cpu")
    assert np.array_equal(got, np.zeros_like(got))


def test_streams_seed_as_the_port_does():
    from lucille_tpu_torch.sampling.jitter import TileSampler

    s = TileSampler(2_200_000_001 << 16, "cpu")(240, 0)
    want = s.uniform((), (2, 50))
    gen = torch.Generator().manual_seed(
        stream_seed(2_200_000_001 << 16, 240, 0))
    assert torch.equal(want, torch.rand((2, 50), generator=gen))


def test_camera_and_triangles_are_the_ports(tmp_path):
    """The reference's own reading of each configuration's raw input
    gives the port's triangles and eye rays."""
    from harness import manifest as mf
    from harness.scenes import program_scene
    from lucille_tpu_torch.ri.camera import generate_rays
    from lucille_tpu_torch.scene.compile import compile_arrays

    root = make_root(tmp_path)
    m = mf.load(root)
    for c in m["configs"]:
        cfg = mf.config(m, c["name"], root)
        tr = {"method": "ao", "tile": 16, "light": "none"}
        desc = program_scene(cfg, tr).scene
        arr = compile_arrays(desc)
        scene, frame = reference_scene(cfg, tr)
        key = lambda v: np.unique(np.round(v.astype(np.float64), 6),  # noqa
                                  axis=0)
        ours = np.concatenate([scene.a, scene.b - scene.a, scene.c - scene.a],
                              axis=1)
        theirs = np.concatenate([arr.tri_v0, arr.tri_e1, arr.tri_e2], axis=1)
        theirs = theirs[np.abs(theirs).sum(axis=1) > 0]  # no pad slot
        assert np.array_equal(key(ours), key(theirs))
        assert np.float32(scene.eps) == arr.eps
        px = torch.tensor([0.25, 17.5, 47.9])
        py = torch.tensor([0.5, 20.25, 35.9])
        o1, d1 = generate_rays(desc.camera, px, py)
        o2, d2 = frame.camera.rays(px, py, torch.float32)
        assert torch.equal(o1, o2) and torch.equal(d1, d2)


@pytest.mark.parametrize("cell", ["bundled-ao", "terrain724-ao",
                                  "bundled-sunsky"])
def test_reference_equals_the_ports_cpu_frames(tmp_path, cell):
    got = run(make_root(tmp_path), cell)
    assert got["checks"]["px_off"]["value"] == 0.0
    assert got["correct"]
