"""Tile checkpoints (Renderer.render_frame(checkpoint=..., recover=...)):
an interrupted frame resumed from its checkpoint equals the frame
rendered in one go, exactly; a checkpoint that does not fit the frame is
ignored; the file goes when the frame completes; and the file has
lucille_tpu's layout (tests/test_render.py:147-226 hold lucille_tpu's
own to the same behaviour)."""

import os

import numpy as np
import pytest

from test_torch_scene import front_end
from test_torch_scene import one_torch_thread  # noqa: F401

RIB = """
Display "c.hdr" "file" "rgb"
Format 48 32 1
PixelSamples 2 2
Projection "perspective" "fov" [45]
Orientation "rh"
ConcatTransform [1 0 0 0  0 1 0 0  0 0 1 0  0 -1 -6 1]
WorldBegin
PointsPolygons [4] [0 1 2 3] "P" [-5 0 -5  5 0 -5  5 0 5  -5 0 5]
PointsPolygons [3] [0 1 2] "P" [-1 0 -1  1 0 -1  0 2 0]
WorldEnd
"""
NTILES = 6  # 48x32 in tiles of 16


class Crash(Exception):
    pass


def _state(pkg="torch"):
    RiState, parse_rib = front_end(pkg)
    s = RiState()
    parse_rib(RIB, s)
    s.options.gather_nsamples = 16
    return s


def _renderer(pkg="torch"):
    if pkg == "jax":
        from lucille_tpu.render.renderer import Renderer

        return Renderer(_state("jax").scene, tile_size=16)
    from lucille_tpu_torch.render.renderer import Renderer

    return Renderer(_state().scene, tile_size=16, device="cpu")


def _interrupt(r, ckpt, after=2):
    """render_frame with a tile callback that raises on its `after`-th
    tile (the checkpoint is written before the callback runs)."""
    seen = []

    def crash_cb(x0, y0, tile):
        seen.append((x0, y0))
        if len(seen) >= after:
            raise Crash

    with pytest.raises(Crash):
        r.render_frame(tile_cb=crash_cb, checkpoint=ckpt)
    assert os.path.exists(ckpt)


def _enqueued(r):
    """The tile origins r enqueues from now on."""
    got = []
    tile = r._tile

    def spy(x0, y0, *args):
        got.append((x0, y0))
        return tile(x0, y0, *args)

    r._tile = spy
    return got


def test_recovered_frame_equals_the_uninterrupted_one(tmp_path):
    ckpt = str(tmp_path / "frame.ckpt.npz")
    full = _renderer().render_frame()
    _interrupt(_renderer(), ckpt, after=3)
    with np.load(ckpt) as data:
        done = data["done"].copy()
    assert done.sum() == 3 and done.shape == (NTILES,)

    r = _renderer()
    enqueued = _enqueued(r)
    replayed = []
    img = r.render_frame(tile_cb=lambda x0, y0, t: replayed.append((x0, y0)),
                         checkpoint=ckpt, recover=True)
    np.testing.assert_array_equal(img, full)
    assert len(enqueued) == NTILES - 3  # only the missing tiles
    assert len(replayed) == NTILES  # every tile reached the callbacks
    assert set(enqueued).isdisjoint(
        {xy for xy, d in zip(replayed, done) if d})
    assert not os.path.exists(ckpt)


def test_checkpoint_is_removed_when_the_frame_completes(tmp_path):
    ckpt = str(tmp_path / "frame.ckpt.npz")
    written = []
    r = _renderer()
    img = r.render_frame(
        tile_cb=lambda *a: written.append(os.path.exists(ckpt)),
        checkpoint=ckpt)
    assert written == [True] * NTILES  # saved after every pulled tile
    assert not os.path.exists(ckpt)
    assert not os.path.exists(ckpt + ".tmp.npz")
    np.testing.assert_array_equal(img, _renderer().render_frame())


@pytest.mark.parametrize("bad", ["mismatched", "corrupt"])
def test_unfit_checkpoint_is_ignored(bad, tmp_path):
    """As lucille_tpu's test_mismatched_checkpoint_ignored: a checkpoint
    of another frame (or an unreadable file) is logged and ignored, and
    every tile is rendered."""
    ckpt = str(tmp_path / "frame.ckpt.npz")
    if bad == "mismatched":
        with open(ckpt, "wb") as f:
            np.savez(f, image=np.zeros((8, 8, 3)), done=np.zeros(1, bool),
                     meta=np.asarray([1, 2, 3, 4, 5, 6, 7]))
    else:
        with open(ckpt, "wb") as f:
            f.write(b"not a zip file")
    r = _renderer()
    enqueued = _enqueued(r)
    img = r.render_frame(checkpoint=ckpt, recover=True)
    assert len(enqueued) == NTILES
    assert float(img.max()) > 0.0
    np.testing.assert_array_equal(img, _renderer().render_frame())
    assert not os.path.exists(ckpt)


def test_checkpoint_layout_matches_jax(tmp_path):
    """The same frame interrupted after the same tile in both packages:
    the same npz keys, meta, done bitmap and array shapes."""
    files = {}
    for pkg in ("jax", "torch"):
        ckpt = str(tmp_path / f"{pkg}.ckpt.npz")
        _interrupt(_renderer(pkg), ckpt, after=2)
        with np.load(ckpt) as data:
            files[pkg] = {k: data[k].copy() for k in data.files}
    ref, got = files["jax"], files["torch"]
    assert sorted(got) == sorted(ref) == ["alpha", "done", "image", "meta"]
    for k in ("meta", "done", "alpha"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        assert got[k].dtype == ref[k].dtype, k
    np.testing.assert_array_equal(
        got["meta"], [48, 32, 16, 16, 2, 2, NTILES])
    assert got["image"].shape == ref["image"].shape == (32, 48, 3)
    assert got["image"].dtype == ref["image"].dtype
    # the done tiles hold the frame, the others are still black
    assert (got["image"] > 0).any()


def _imager_renderer(pkg="torch"):
    """The checkpoint frame under the background imager: the tiles carry
    their alpha (subsample coverage) into the checkpoint."""
    s = _state(pkg)
    s.Imager("background", {"bgcolor": [0.1, 0.2, 0.9]})
    if pkg == "jax":
        from lucille_tpu.render.renderer import Renderer

        return Renderer(s.scene, tile_size=16)
    from lucille_tpu_torch.render.renderer import Renderer

    return Renderer(s.scene, tile_size=16, device="cpu")


def test_imager_frame_recovers_with_its_alpha(tmp_path):
    """An imager frame stopped after 3 tiles and recovered equals the
    uninterrupted frame exactly: the checkpoint holds the done tiles'
    real alpha (as lucille_tpu's does for the same tiles) and --recover
    restores it, so the imager sees every tile's coverage."""
    full = _imager_renderer().render_frame()
    files = {}
    for pkg in ("jax", "torch"):
        ckpt = str(tmp_path / f"{pkg}.ckpt.npz")
        _interrupt(_imager_renderer(pkg), ckpt, after=3)
        with np.load(ckpt) as data:
            files[pkg] = {k: data[k].copy() for k in data.files}
    got, ref = files["torch"], files["jax"]
    np.testing.assert_array_equal(got["done"], ref["done"])
    np.testing.assert_array_equal(got["alpha"], ref["alpha"])
    assert 0 < got["alpha"].max() <= 1 and (got["alpha"] < 1).any()
    assert got["alpha"][got["image"].sum(-1) == 0].max() == 0
    r = _imager_renderer()
    img = r.render_frame(checkpoint=str(tmp_path / "torch.ckpt.npz"),
                         recover=True)
    np.testing.assert_array_equal(img, full)
    blue = (full == np.float32([0.1, 0.2, 0.9])).all(-1)
    assert 0.05 < blue.mean() < 0.95  # the imager's colour where all missed
