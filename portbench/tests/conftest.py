"""The benchmark's own tests: ``python -m pytest portbench/tests`` from the
root of the checkout.  They run on the CPU at tiny sizes; the one test that
needs a CUDA device decides inside its fixture and skips without one."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
