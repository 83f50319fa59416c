#!/usr/bin/env python3
"""Readings behind the limits of ``correct``, many seeds in one process.

    python3 portbench/proof.py --workload rmat22-count --variant control \\
        --seconds 10 --seeds 11 12 13

For each seed it runs the cell's driver as ``run.py`` does (pool, engine,
warm-up, window, reference) and prints one JSON line: the numbers
compared, each beside its limit, and whether the run came out correct.
``--variant program`` reads the program as the cell runs it (the lower
readings); ``--variant control`` switches on the configuration's
``control`` (its ``options``, the program's own path that breaks the
guarantee the configuration states: the upper readings).  The
benchmark's own runs never run the control.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--variant", choices=("program", "control"),
                    default="program")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    here = Path(__file__).resolve().parent
    sys.path[:] = [p for p in sys.path if p and Path(p).resolve() != here]
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench import harness
    from portbench.graphs import load_module

    harness.cache_dirs(ROOT)
    _, entry, config, traffic = harness.load_cell(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available():
        harness.log("needs a CUDA device")
        return 2
    override = (config["control"]["options"] if args.variant == "control"
                else None)
    driver = load_module("drivers", traffic["driver"])
    for seed in args.seeds:
        cell = harness.Cell(
            name=args.workload, config=config, traffic=traffic, seed=seed,
            seconds=args.seconds, trace=False,
            device=torch.device("cuda", 0), t_process=time.perf_counter(),
            options_override=override)
        out = driver.run(cell)
        print(json.dumps({
            "workload": args.workload, "variant": args.variant,
            "seed": seed, "options_override": override,
            "correct": harness.judge(out), "answers": out["answers"],
            "failed": out["failed"], "error": out["error"],
            "count_s": (out["window_s"] / out["answers"]
                        if out["answers"] else None),
            "checks": {k: {"value": v, "limit": lim}
                       for k, (v, lim) in out["checks"].items()},
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
