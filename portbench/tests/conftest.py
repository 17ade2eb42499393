"""Paths for the benchmark's tests: the harness package (`portbench/`) and
the checkout's root (the program)."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (BENCH, BENCH.parent):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
