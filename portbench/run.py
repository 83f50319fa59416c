#!/usr/bin/env python3
"""Run one cell of the port's benchmark and print one JSON line.

    python3 portbench/run.py --workload rmat22-count --seed 7 \\
        --seconds 10 --trace 0

From the root of a checkout with one CUDA card (``BENCHMARK.json`` names
the cells).  It exits non-zero, printing no result, without the cards
the cell asks for, or when JAX or the JAX package was loaded.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    # the harness's package and the program, not this directory's
    # modules under their bare names
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if p and Path(p).resolve() != Path(
        here)]
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench import harness

    return harness.main(args, ROOT, T_PROCESS)


if __name__ == "__main__":
    sys.exit(main())
