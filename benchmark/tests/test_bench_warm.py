"""Set-up renders two warm frames, both with frame 0's seed, before the
window opens (the port captures a tile's graph the second time it sees
it), and the window's first frame still draws with frame_seed(seed, 1)."""

from __future__ import annotations

import pytest

from bench_tiny import make_root, run

from harness.cell import WARM_FRAMES
from harness.check import frame_seed

SEED = 3_000_000_019


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("tiny"))


def test_two_warm_frames_then_the_window_from_frame_1(root, monkeypatch):
    from lucille_tpu_torch.render.renderer import Renderer

    calls = []  # (the sampler's seed, whether a tile_cb was passed)
    render_frame = Renderer.render_frame

    def spy(self, tile_cb=None, *a, **kw):
        calls.append((self.sampler.seed, tile_cb is not None))
        return render_frame(self, tile_cb, *a, **kw)

    monkeypatch.setattr(Renderer, "render_frame", spy)
    got = run(root, "bundled-ao", seed=SEED, seconds=0.5)
    assert got["correct"]
    # set-up's frames pass no tile_cb; every window frame passes one
    opened = next(i for i, (_s, cb) in enumerate(calls) if cb)
    assert opened == WARM_FRAMES == 2
    assert calls[:opened] == [(frame_seed(SEED, 0), False)] * opened
    assert calls[opened:] == [(frame_seed(SEED, k), True)
                              for k in range(1, len(calls) - opened + 1)]
