#!/usr/bin/env python3
"""The benchmark of lucille_tpu_torch on one NVIDIA card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of BENCHMARK.json (a configuration under a traffic mix)
from the root of a checkout and prints, as the last line of its standard
output, one JSON object: correct, attempted, failed, metrics (the cell's
end-to-end metrics, or with --trace 1 its per-layer ones), device, with
--trace 1 a breakdown, and last the checks that decided `correct`, each
with its limit (also the last lines of standard error).  Exits non-zero
without a result where no CUDA card is visible, where the program cannot
be imported, or where a JAX module was loaded.  See benchmark/README.md.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from harness.cell import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
