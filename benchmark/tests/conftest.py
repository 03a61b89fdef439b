"""The benchmark's own tests: the harness and the reference import from
``benchmark/``, the program from the checkout's root."""

import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
for p in (str(BENCH_DIR), str(BENCH_DIR.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)
