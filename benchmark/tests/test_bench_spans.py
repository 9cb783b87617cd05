"""The per-layer metrics read from the port's own spans and counter
(enqueue_ms, pull_wait_ms, glue_host_ms, host_syncs; base/timer.py): a
traced run of each cell at bench_tiny's size (48x36 in tiles of 16: 9
tiles) reads all four, and against a port without spans (the timer
without `recorded_frames`) the readers read nothing and the run goes
on."""

from __future__ import annotations

import pytest

from bench_tiny import make_root, run

CELLS = ["bundled-ao", "terrain724-ao", "bundled-sunsky"]
SPAN_METRICS = ("enqueue_ms", "pull_wait_ms", "glue_host_ms")
TILES = 9


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reads_the_ports_spans(root, cell):
    got = run(root, cell, seconds=0.5, trace=1)
    assert got["correct"]
    m = got["metrics"]
    for name in SPAN_METRICS:
        assert m[name]["unit"] == "ms/frame" and m[name]["value"] > 0
    # one event wait a pulled tile; the traced frames are not the
    # renderer's first, so its constants are on the device already
    assert m["host_syncs"] == {"value": float(TILES),
                               "unit": "syncs/frame"}


def test_a_port_without_spans_reads_nothing(root, monkeypatch):
    from lucille_tpu_torch.base.timer import Timer

    monkeypatch.delattr(Timer, "recorded_frames")
    got = run(root, "bundled-ao", seconds=0.5, trace=1)
    assert got["correct"]
    assert not set(SPAN_METRICS + ("host_syncs",)) & set(got["metrics"])
    assert "scene_compile_s" in got["metrics"]
