#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once on this host's CUDA card(s).

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Prints the result as the last line of standard output (see
``core/harness.py``); exits non-zero with no result on a host without the
card(s) the cell asks for.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.core.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
