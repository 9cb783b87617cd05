"""The renderer's spans and its host-sync counter (base/timer.py,
device.host_sync), on the CPU at 32x24 in tiles of 16 (4 tiles): a frame
rendered under torch.profiler records one tree of spans, each also a CPU
event of the profiler's; a frame outside one records nothing; the store
keeps the last MAX_FRAMES frames; an AO frame counts its host syncs; and
`--profile FILE` writes the Chrome trace with the spans in it.

On the card (marker `gpu`, skips without one), a 48x36 frame of each
benchmark cell, its tiles replaying their graphs, counts one host sync a
tile (the wait on the tile's copies' event), and torch warns of no
synchronizing call under torch.cuda.set_sync_debug_mode("warn")."""

import json
import warnings

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from test_torch_scene import one_torch_thread  # noqa: F401

TILES = 4

# span -> (its parent, how many a frame)
TREE = {
    "frame": (None, 1),
    "frame.enqueue": ("frame", 1),
    "tile": ("frame.enqueue", TILES),
    "tile.rays": ("tile", TILES),
    "tile.integrate": ("tile", TILES),
    "accel.closest_hit_reference": ("tile.integrate", TILES),
    "accel.ao_occlusion_reference": ("tile.integrate", TILES),
    "tile.filter": ("tile", TILES),
    "tile.pull": ("frame", TILES),
    "tile.deliver": ("frame", TILES),
}


def _renderer(width=32, height=24, tile=16, device="cpu", **kw):
    from chip_smoke import bundled_state

    from lucille_tpu_torch.render.renderer import Renderer

    kw = {"pixelsamples": 1, "gather": 9, "sunsky": False, **kw}
    state = bundled_state(width, height, **kw)
    return Renderer(state.scene, tile_size=tile, device=device)


@pytest.fixture(scope="module")
def traced():
    """(the recorded frame, the profiler's events) of one AO frame."""
    from lucille_tpu_torch.base.timer import get_timer

    r = _renderer()
    r.render_frame()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r.render_frame()
    return get_timer().recorded_frames(1)[0], prof.events()


@pytest.mark.parametrize("name", sorted(TREE))
def test_a_traced_frame_records_one_tree(traced, name):
    frame, _events = traced
    parent, count = TREE[name]
    spans = [s for s in frame.spans if s.name == name]
    assert len(spans) == count
    for s in spans:
        assert s.start_ns <= s.end_ns
        if parent is None:
            assert s is frame.spans[0] and s.parent == -1
        else:
            up = frame.spans[s.parent]
            assert up.name == parent
            assert up.start_ns <= s.start_ns and s.end_ns <= up.end_ns
    assert {s.name for s in frame.spans} == set(TREE)


def test_tiles_carry_their_origins(traced):
    frame, _events = traced
    origins = {(s.attrs["x0"], s.attrs["y0"]) for s in frame.spans
               if s.name == "tile"}
    assert origins == {(0, 0), (16, 0), (0, 16), (16, 16)}
    assert frame.spans[0].attrs["tiles"] == TILES


@pytest.mark.parametrize("name", sorted(TREE))
def test_each_span_is_a_cpu_event_of_the_profiler(traced, name):
    from torch.autograd import DeviceType

    _frame, events = traced
    mine = [e for e in events if e.name == name]
    assert len(mine) == TREE[name][1]
    for e in mine:
        assert e.device_type == DeviceType.CPU
        assert not e.is_user_annotation


def test_frames_outside_a_profiler_record_nothing():
    from lucille_tpu_torch.base.timer import get_timer

    timer = get_timer()
    r = _renderer()
    before = timer.recorded_frames()
    n = timer._frame_count
    for _ in range(3):
        r.render_frame()
    assert timer._frame_count == n
    assert timer.recorded_frames() == before


def test_the_store_keeps_the_last_frames():
    from lucille_tpu_torch.base.timer import MAX_FRAMES, Timer

    timer = Timer()
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(MAX_FRAMES + 5):
            with timer.frame():
                with timer.span("tile", i=i):
                    timer.count("host_syncs", 2)
    kept = timer.recorded_frames()
    assert len(kept) == MAX_FRAMES
    assert [f.id for f in kept] == list(range(5, MAX_FRAMES + 5))
    assert kept[-1].spans[1].attrs == {"i": MAX_FRAMES + 4}
    assert kept[-1].counters == {"host_syncs": 2}
    assert [f.id for f in timer.recorded_frames(3)] == [
        MAX_FRAMES + 2, MAX_FRAMES + 3, MAX_FRAMES + 4]


def test_an_ao_frame_counts_its_host_syncs(traced, monkeypatch):
    """One wait a pulled tile, and in a Renderer's first frame the
    subpixel table and weights copied to the device (once a replica):
    each through device.host_sync, counted on the root span.  A CPU
    frame replays no tile graph: graph_tiles 0."""
    import sys

    from lucille_tpu_torch import device

    frame, _events = traced
    assert frame.spans[0].attrs["host_syncs"] == TILES
    assert frame.spans[0].attrs["graph_tiles"] == 0
    assert frame.counters == {"host_syncs": TILES, "graph_tiles": 0}

    calls = []

    def counted(op, *args):
        calls.append(op)
        return op(*args)

    r = _renderer()
    helper = device.host_sync
    for name, mod in list(sys.modules.items()):
        if (name.startswith("lucille_tpu_torch.")
                and getattr(mod, "host_sync", None) is helper):
            monkeypatch.setattr(mod, "host_sync", counted)
    r.render_frame()
    assert len(calls) == TILES + 2
    r.render_frame()
    assert len(calls) == 2 * TILES + 2


def test_profile_flag_writes_the_spans(tmp_path, capsys):
    from test_torch_scene import bundled_rib_text

    from lucille_tpu_torch.cli import main

    rib = tmp_path / "ao.rib"
    rib.write_text(bundled_rib_text())
    trace = tmp_path / "frame.json"
    assert main([str(rib), "-o", str(tmp_path / "ao.hdr"), "--device",
                 "cpu", "--width", "32", "--height", "24",
                 "--pixelsamples", "1", "--gather-rays", "4", "--tile", "16",
                 "--stats", "--profile", str(trace)]) == 0
    names = {e.get("name") for e in json.loads(trace.read_text())[
        "traceEvents"]}
    assert {"frame", "frame.enqueue", "tile", "tile.pull",
            "tile.deliver"} <= names
    out = capsys.readouterr().out
    assert "Span self time" in out and "tile.integrate" in out
    assert "host_syncs (count)" in out


CELLS = {  # a 48x36 frame of each benchmark cell, in tiles of 16
    "bundled-ao": ("bundled", {"pixelsamples": 3, "gather": 64,
                               "sunsky": False}),
    "bundled-sunsky": ("bundled", {"pixelsamples": 3, "gather": 64,
                                   "sunsky": True}),
    "terrain724-ao": ("terrain", {"pixelsamples": 2, "gather": 64}),
}


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_host_syncs_are_torchs_synchronizing_calls(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from chip_smoke import heightfield_state

    from lucille_tpu_torch.base.timer import get_timer
    from lucille_tpu_torch.render.renderer import Renderer

    scene, kw = CELLS[cell]
    if scene == "bundled":
        r = _renderer(48, 36, device="cuda", **kw)
    else:
        state = heightfield_state(724, 48, 36, **kw)
        r = Renderer(state.scene, tile_size=16, device="cuda")
    r.render_frame()  # kernels built, constants on the card, tiles seen
    r.render_frame()  # the tiles captured as graphs
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with profile(activities=[ProfilerActivity.CPU]):
            torch.cuda.set_sync_debug_mode("warn")
            try:
                r.render_frame()
            finally:
                torch.cuda.set_sync_debug_mode("default")
    warned = [w for w in caught
              if "called a synchronizing CUDA operation" in str(w.message)]
    frame = get_timer().recorded_frames(1)[0]
    assert frame.spans[0].attrs["tiles"] == 9
    assert frame.spans[0].attrs["graph_tiles"] == 9
    # the frame's one wait a tile is on its copies' event, which torch's
    # sync debug mode does not flag; nothing else in it waits
    assert frame.spans[0].attrs["host_syncs"] == 9
    assert warned == []
