"""Run one cell of the port's benchmark (``BENCHMARK.json``) on this
machine's CUDA card and print its result as the last line of standard
output:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Exits with a code other than 0, and prints no
result, where CUDA has fewer cards than the cell asks for, and where a
forbidden module (JAX or the JAX package) was loaded."""

import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH_DIR.parent), str(BENCH_DIR)]

from dirbench.runner import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
