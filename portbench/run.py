#!/usr/bin/env python3
"""Run one cell of the benchmark once (see ``portbench/harness.py``).

    python3 portbench/run.py --workload drin-rank-b64 --seed 7 --seconds 10 --trace 0

Run from the root of a checkout: the port (``drin_tpu_torch``) is imported
from there, and the CUDA kernels are built into its ``build/`` directory.
"""

import time

T0 = time.perf_counter()  # set-up is timed from here, before torch is imported

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0, ROOT))
