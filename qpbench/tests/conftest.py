"""The benchmark's tests run on the CPU (tests that need a CUDA card skip
inside the test).  The harness is imported as ``qpbench/run.py`` imports
it: the benchmark's folder and the checkout's root on ``sys.path``."""
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)
