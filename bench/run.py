"""Run one cell of the benchmark of the PyTorch and CUDA port once.

    python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. The cell, its configuration and its traffic are read from
``BENCHMARK.json`` and the data files under ``bench/``; the last line of
standard output is the result, one JSON object. Exits non-zero, with no
result, where there is no card, where the program cannot be loaded, or
where a JAX module was loaded.
"""
import time

T_START = time.perf_counter()

import pathlib  # noqa: E402
import sys  # noqa: E402

from benchlib import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], t_start=T_START,
                          root=pathlib.Path(__file__).resolve().parent.parent))
