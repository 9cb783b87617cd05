"""A run with the timed path broken underneath must come out not correct.

Each test drives the whole run but the look for a card (harness.cell.
run_cell on the CPU, at bench_tiny's size) with one fault planted in the
port's renderer: a frame that returns the renderer's state unchanged
(the first frame again, whatever the seed), half of a frame's tiles left
out, and one tile's answer altered where it is produced (its values
1 / S higher, S the gather's strata: about one stratum more open).  The
cells run on one card, so there is no exchange between cards to leave
out."""

from __future__ import annotations

import pytest
import torch

from bench_tiny import make_root, run

CELLS = ["bundled-ao", "terrain724-ao", "bundled-sunsky"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(root, cell):
    got = run(root, cell)
    assert got["correct"] and got["failed"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_state_returned_unchanged(root, cell, monkeypatch):
    from lucille_tpu_torch.render.renderer import Renderer

    orig = Renderer.render_frame
    first = {}

    def stale(self, *a, **kw):
        img = orig(self, *a, **kw)
        return first.setdefault(id(self), img).copy()

    monkeypatch.setattr(Renderer, "render_frame", stale)
    got = run(root, cell)
    assert not got["correct"]
    assert got["checks"]["px_off"]["value"] > got["checks"]["px_off"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_half_the_tiles_left_out(root, cell, monkeypatch):
    from lucille_tpu_torch.render.renderer import Renderer

    orig = Renderer._tile

    def half(self, x0, y0, tile_w, *a):
        img, counters = orig(self, x0, y0, tile_w, *a)
        if (x0 // tile_w + y0 // tile_w) % 2:
            img = torch.zeros_like(img)
        return img, counters

    monkeypatch.setattr(Renderer, "_tile", half)
    got = run(root, cell)
    assert not got["correct"]
    assert got["checks"]["px_off"]["value"] > got["checks"]["px_off"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_one_tiles_answer_altered(root, cell, monkeypatch):
    from lucille_tpu_torch.render.renderer import Renderer

    orig = Renderer._tile

    def altered(self, x0, y0, *a):
        img, counters = orig(self, x0, y0, *a)
        if (x0, y0) == (0, 0):
            S = self.desc.options.gather_nsamples
            img = img * (1.0 + 1.0 / S)
        return img, counters

    monkeypatch.setattr(Renderer, "_tile", altered)
    got = run(root, cell)
    assert not got["correct"]
    assert got["checks"]["px_off"]["value"] > got["checks"]["px_off"]["limit"]


def test_a_frame_that_is_not_finite_fails(root, monkeypatch):
    from lucille_tpu_torch.render.renderer import Renderer

    orig = Renderer.render_frame

    def nan(self, *a, **kw):
        img = orig(self, *a, **kw)
        img[0, 0, 0] = float("nan")
        return img

    monkeypatch.setattr(Renderer, "render_frame", nan)
    got = run(root, "bundled-ao")
    assert not got["correct"] and got["failed"] == got["attempted"] > 0
