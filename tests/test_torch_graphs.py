"""Tile graphs (render/graphs.py) and the pinned pulls (parallel/mesh.py),
on the CPU: the parts a CUDA graph leans on that run without a card.

- The draw recorder: the draws of a tile noted in its eager run
  (NotingStream), handed back by the capture's DrawRecorder and refilled
  for another seed, are exactly what the tile's own stream draws for that
  seed, path and shape, from TileSampler, HostSampler and the tests'
  JAX-draw streams; with depth of field the lens draw is recorded too; a
  draw the eager run did not make raises (the capture then fails and the
  tile stays eager).
- The tile key: the same inputs give the same key; a change of
  PixelSamples, of the camera or of the render method between frames
  gives another; an integrator that does not declare itself capturable
  gives none.
- The guard: a launch function replaced after the tile's launches were
  recorded stops the replay of the keys that called it, not of others.
- What tile_cb receives and render_frame returns is never a view of a
  buffer that a later frame writes again.

The graphs themselves, their replays against eager frames and the
fallbacks are held on the card (tests/test_torch_gpu.py, marker gpu).
"""

import jax
import numpy as np
import pytest
import torch

from test_torch_scene import one_torch_thread  # noqa: F401

TILES = 4  # a 32x24 frame in tiles of 16

def _renderer(width=32, height=24, tile=16, **kw):
    from chip_smoke import bundled_state

    from lucille_tpu_torch.render.renderer import Renderer

    kw = {"pixelsamples": 1, "gather": 4, "sunsky": False, **kw}
    state = bundled_state(width, height, **kw)
    return Renderer(state.scene, tile_size=tile, device="cpu")


def _samplers():
    from test_torch_render import JaxSampler

    from lucille_tpu_torch.sampling.jitter import HostSampler, TileSampler

    return {"tile": lambda seed: TileSampler(seed, "cpu"),
            "host": lambda seed: HostSampler(seed, "cpu"),
            "jax": lambda seed: JaxSampler(jax.random.key(seed))}


@pytest.mark.parametrize("dof", [False, True])
@pytest.mark.parametrize("sampler", ["tile", "host", "jax"])
def test_recorded_draws_refill_as_the_stream_draws(sampler, dof):
    """The eager run notes the tile's draws; the capture's stream hands
    back a buffer for each (the lens draw first with depth of field);
    refilled for another seed, each buffer holds exactly that seed's
    draw."""
    from lucille_tpu_torch.render.graphs import DrawRecorder, NotingStream

    r = _renderer(tile=16, dof=dof)
    rep = r.replicas[0]
    jitter, weights = r._consts(rep, *r._subsamples()[2:])
    make = _samplers()[sampler]
    noting = NotingStream(make(1)(16, 0))
    r._tile_work(16, 0, 16, 16, jitter, weights, rep, noting)
    want = [((), (2, 16 * 16), None)]
    if dof:
        want.insert(0, ((0x10EF,), (16 * 16, 2), None))
    assert [d[:3] for d in noting.draws] == want
    rec = DrawRecorder(noting.draws, "cpu")
    r._tile_work(16, 0, 16, 16, jitter, weights, rep, rec)
    assert rec._next == len(want)
    for seed in (3, 2**31 + 77):
        rec.refill(make(seed)(16, 0))
        fresh = make(seed)(16, 0)
        for path, shape, _high, buf in rec.draws:
            assert torch.equal(buf, fresh.uniform(path, shape))


@pytest.mark.parametrize("sampler", ["tile", "host", "jax"])
def test_recorded_integers_refill_as_the_stream_draws(sampler):
    from lucille_tpu_torch.render.graphs import DrawRecorder, NotingStream

    make = _samplers()[sampler]
    noting = NotingStream(make(2)(0, 64))
    noting.uniform((7,), (5, 2))
    noting.randint((7, 1), (9,), 11)
    rec = DrawRecorder(noting.draws, "cpu")
    u = rec.uniform((7,), (5, 2))
    i = rec.randint((7, 1), (9,), 11)
    rec.refill(make(12)(0, 64))
    fresh = make(12)(0, 64)
    assert torch.equal(u, fresh.uniform((7,), (5, 2)))
    assert torch.equal(i, fresh.randint((7, 1), (9,), 11))


def test_a_draw_the_eager_run_did_not_make_raises():
    from lucille_tpu_torch.render.graphs import DrawRecorder, NotingStream
    from lucille_tpu_torch.sampling.jitter import TileSampler

    noting = NotingStream(TileSampler(0, "cpu")(0, 0))
    noting.uniform((), (2, 8))
    for draw in (lambda rec: rec.uniform((1,), (2, 8)),
                 lambda rec: rec.uniform((), (2, 9)),
                 lambda rec: rec.randint((), (2, 8), 4)):
        with pytest.raises(ValueError):
            draw(DrawRecorder(noting.draws, "cpu"))
    rec = DrawRecorder(noting.draws, "cpu")
    rec.uniform((), (2, 8))
    with pytest.raises(ValueError):
        rec.uniform((), (2, 8))


def test_the_tile_key_follows_what_the_tile_reads():
    r = _renderer()
    key = r._frame_key(*r._subsamples()[2:])
    assert key is not None
    assert r._frame_key(*r._subsamples()[2:]) == key
    opt = r.desc.options
    opt.current_display().sampling_rates = (2.0, 2.0)  # PixelSamples 2 2
    samples = r._subsamples()[2:]
    assert r._frame_key(*samples) != key
    opt.current_display().sampling_rates = (1.0, 1.0)
    assert r._frame_key(*r._subsamples()[2:]) == key
    c2w = r.camera.camera_to_world.copy()
    moved = c2w.copy()
    moved[3, 0] += 0.5  # the eye half a unit along x
    r.camera.camera_to_world = moved
    assert r._frame_key(*r._subsamples()[2:]) != key
    r.camera.camera_to_world = c2w
    assert r._frame_key(*r._subsamples()[2:]) == key
    opt.render_method = "ambientocclusion"
    assert r._frame_key(*r._subsamples()[2:]) != key


def test_a_replica_keeps_the_graphs_of_one_view():
    """A frame under another key drops the replica's graphs and their
    pool; the same key keeps them."""
    r = _renderer()
    rep = r.replicas[0]
    samples = r._subsamples()[2:]
    assert r._graph_frame(*samples)
    rep.graphs[(0, 0, 16, 16)], rep.graph_pool = None, "pool"
    assert r._graph_frame(*samples)
    assert rep.graphs == {(0, 0, 16, 16): None} and rep.graph_pool == "pool"
    r.camera.camera_to_world = r.camera.camera_to_world * 2.0
    assert r._graph_frame(*samples)
    assert rep.graphs == {} and rep.graph_pool is None
    r.integrator = lambda *a, **k: None  # no graph_key: eager
    assert not r._graph_frame(*samples)


@pytest.mark.parametrize("method", ["whitted", "pathtrace", "dirtmap",
                                    "shader"])
def test_integrators_left_eager_give_no_key(method):
    r = _renderer(method=method)
    assert r._frame_key(*r._subsamples()[2:]) is None


def test_a_replaced_launch_function_stops_the_replay(monkeypatch):
    from lucille_tpu_torch.accel import ao, isect
    from lucille_tpu_torch.base.timer import get_timer
    from lucille_tpu_torch.render.graphs import DrawRecorder, TileGraph

    r = _renderer()
    rep = r.replicas[0]
    jitter, weights = r._consts(rep, *r._subsamples()[2:])
    with get_timer().recording_launches() as tile_calls:
        r._tile_work(0, 0, 16, 16, jitter, weights, rep)
    with get_timer().recording_launches() as hit_calls:
        isect.closest_hit(rep.scene, torch.zeros((4, 3)),
                          torch.tensor([[0.0, 0.0, 1.0]] * 4))
    assert ao.ao_occlusion_reference in tile_calls
    assert ao.ao_occlusion_reference not in hit_calls
    tile = TileGraph(None, DrawRecorder([], "cpu"), None, tile_calls, ())
    other = TileGraph(None, DrawRecorder([], "cpu"), None, hit_calls, ())
    assert tile.replayable() and other.replayable()
    original = ao.ao_occlusion_reference
    monkeypatch.setattr(ao, "ao_occlusion_reference",
                        lambda *a, **k: original(*a, **k))
    assert not tile.replayable()
    assert other.replayable()
    monkeypatch.undo()
    assert tile.replayable()


def test_tiles_and_frames_handed_out_are_not_reused():
    from lucille_tpu_torch.sampling.jitter import TileSampler

    r = _renderer()
    assert isinstance(r.sampler, TileSampler)
    frames, tiles = [], []

    def frame(seed):
        r.sampler.seed = seed
        got = []
        frames.append(r.render_frame(
            tile_cb=lambda x0, y0, t: got.append((x0, y0, t))))
        tiles.append(got)

    frame(5)
    first = [t.copy() for _x, _y, t in tiles[0]]
    image = frames[0].copy()
    frame(6)
    assert not np.array_equal(frames[0], frames[1])
    for (_x, _y, a), kept in zip(tiles[0], first):
        np.testing.assert_array_equal(a, kept)
        for _x2, _y2, b in tiles[1]:
            assert not np.shares_memory(a, b)
        assert not np.shares_memory(a, frames[1])
    np.testing.assert_array_equal(frames[0], image)
    assert not np.shares_memory(frames[0], frames[1])


def test_launch_counts_are_every_wrappers():
    """The counters a capture puts back are every LaunchCounts that a
    module of the package holds, each once."""
    import importlib
    import pkgutil

    import lucille_tpu_torch
    from lucille_tpu_torch.kernels.build import LaunchCounts
    from lucille_tpu_torch.render.graphs import launch_counts

    held = []
    for info in pkgutil.walk_packages(lucille_tpu_torch.__path__,
                                      "lucille_tpu_torch."):
        try:
            mod = importlib.import_module(info.name)
        except Exception:  # noqa: BLE001 - a tool's optional dependency
            continue
        held += [v for k, v in vars(mod).items()
                 if isinstance(v, LaunchCounts) and not k.startswith("__")
                 and all(v is not h for h in held)]
    got = launch_counts()
    assert len({id(c) for c in got}) == len(got)
    assert {id(c) for c in got} == {id(c) for c in held}


class _RerunGraph:
    """A stand-in for a CUDA graph on the CPU: a replay runs the captured
    tile again on its recorder's buffers, into the captured outputs."""

    def __init__(self, run, recorder, outputs):
        self.run, self.recorder, self.outputs = run, recorder, outputs

    def replay(self):
        self.recorder._next = 0
        for out, new in zip(self.outputs, self.run(self.recorder)):
            out.copy_(new)


@pytest.fixture
def rerun_graphs(monkeypatch):
    """Renderer(...) -> the renderer with its replica's tiles run as
    stand-in graphs (_RerunGraph) as on a card; the captures made are
    listed in `captures`."""
    from lucille_tpu_torch.render import renderer
    from lucille_tpu_torch.render.graphs import DrawRecorder, TileGraph

    captures = []

    def capture(run, seen, device, pool):
        captures.append(pool)
        rec = DrawRecorder(seen.draws, device)
        out = run(rec)
        return TileGraph(_RerunGraph(run, rec, out), rec, out,
                         seen.launches, ())

    monkeypatch.setattr(renderer, "capture_tile", capture)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")

    def make(**kw):
        r = _renderer(**kw)
        r.replicas[0].graphs_here = True
        return r

    make.captures = captures
    return make


def _held(r):
    from lucille_tpu_torch.render.graphs import SeenTile, TileGraph

    kinds = {type(v) for v in r.replicas[0].graphs.values()}
    return ({SeenTile: "seen", TileGraph: "graph"}.get(k, k) for k in kinds)


def test_a_tile_is_captured_the_second_time_it_is_seen(rerun_graphs):
    """The first frame renders eagerly and only notes its tiles; the
    second captures each tile and replays it; later frames replay; every
    frame equals the eager renderer's at the same seed."""
    r, eager = rerun_graphs(), _renderer()
    eager.replicas[0].graphs_here = False
    for seed in (1, 2, 3):
        r.sampler.seed = eager.sampler.seed = seed
        np.testing.assert_array_equal(r.render_frame(), eager.render_frame())
        assert len(rerun_graphs.captures) == (0 if seed == 1 else TILES)
        assert set(_held(r)) == {"seen" if seed == 1 else "graph"}


def test_a_frame_rendered_once_captures_nothing(rerun_graphs):
    """A Renderer that renders one frame, and a view that changes every
    frame, capture no tile."""
    r = rerun_graphs()
    r.render_frame()
    for k in range(3):
        r.camera.camera_to_world = r.camera.camera_to_world * 1.25
        r.render_frame()
        assert set(_held(r)) == {"seen"}
    assert rerun_graphs.captures == []


def test_a_replaced_launch_function_defers_the_capture(rerun_graphs,
                                                       monkeypatch):
    """A tile seen once is not captured while a launch function it called
    is replaced (a recorder then sees the frame's launches); it is
    captured once the function is back."""
    from lucille_tpu_torch.accel import ao

    r = rerun_graphs()
    r.render_frame()
    calls = []
    original = ao.ao_occlusion_reference
    monkeypatch.setattr(ao, "ao_occlusion_reference",
                        lambda *a, **k: calls.append(1) or original(*a, **k))
    r.render_frame()
    assert len(calls) == TILES and rerun_graphs.captures == []
    monkeypatch.setattr(ao, "ao_occlusion_reference", original)
    r.render_frame()
    assert len(rerun_graphs.captures) == TILES
