"""On the card: a short run of each cell through benchmark/run.py, which
must print a correct result line.  Skips without a card:
    python3 -m pytest benchmark/tests -m gpu -q"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from bench_tiny import ROOT


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["bundled-ao", "terrain724-ao",
                                  "bundled-sunsky"])
def test_a_short_run_on_the_card_is_correct(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "2147483659", "--seconds", "3", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"
