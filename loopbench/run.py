"""Time to drain a self-scheduled loop on the card, one cell a run.

    python3 loopbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON line last on standard output: ``correct``, ``attempted``,
``failed``, ``metrics``, ``device`` (and ``breakdown`` with ``--trace 1``),
then ``checks``, each compared number beside its limit.  Exits non-zero,
printing no result, without a CUDA device, when the program cannot be
imported, or when JAX or the JAX package is loaded once the window closed.
"""
import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from loopbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_start=T_START))
