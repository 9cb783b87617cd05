"""The control: the reference computed in bfloat16, the precision below
the configurations' float32, put in the program's place, must fail the
limit the program's sound frames pass, and so must the program's stale
frames (each frame judged by the one before it); calibrate.py, at
bench_tiny's size on the CPU; on the card at the cells' own size,
PERF.md."""

from __future__ import annotations

import pytest

from bench_tiny import make_root

import calibrate


@pytest.mark.parametrize("cell", ["bundled-ao", "terrain724-ao",
                                  "bundled-sunsky"])
def test_control_fails_where_sound_frames_pass(tmp_path, cell):
    got = calibrate.readings(cell, [2_200_000_001, 2_200_007_920],
                             [2_200_104_730], root=make_root(tmp_path),
                             device="cpu", out=lambda _line: None, stale=1)
    assert got["sound_max"] <= got["limit"] < got["control_min"]
    assert got["limit"] < got["stale_min"]
