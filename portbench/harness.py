"""One run of one cell: resolve the cell by name, run its driver, read
its metrics, judge ``correct`` and print the result line.

Data, found by name: the cell in ``BENCHMARK.json``; its configuration
(the ``file`` of its ``configs`` entry); its traffic mix
(``traffic/<traffic>.json``), which names the driver
(``drivers/<driver>.py``) and holds the mix's parameters; and one reader
per metric (``metrics/<name>.py``: ``read(outcome) -> float | None``,
``None`` where the run has nothing to read).  With ``--trace 0`` the
line carries the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
from pathlib import Path
from typing import Optional

#: top-level module names that may not be loaded once the window closes:
#: JAX and the JAX package, compared whole (``repro_torch`` is the port)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t_process: float
    chips: int = 1
    options_override: Optional[dict] = None


def log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def forbidden_modules(modules=None) -> list[str]:
    """The loaded modules whose top-level name is in ``FORBIDDEN``."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in list(modules) if m.split(".")[0] in FORBIDDEN)


def load_cell(root: Path, workload: str) -> tuple[dict, dict, dict, dict]:
    """``(bench, cell, config, traffic)`` of the cell named ``workload``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"have {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads(
        (root / "portbench" / "traffic" / f"{cell['traffic']}.json")
        .read_text())
    return bench, cell, config, traffic


def metrics_for(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics this cell reports: its per-layer ones in a traced run,
    else its end-to-end ones; a metric with ``workloads`` only in those
    cells."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries
            if "workloads" not in m or workload in m["workloads"]]


def read_metrics(entries: list[dict], outcome: dict) -> dict:
    from portbench.graphs import load_module

    out = {}
    for m in entries:
        value = load_module("metrics", m["name"]).read(outcome)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def judge(outcome: dict) -> bool:
    """Every answer came, at least one did, and every compared number is
    within its limit."""
    return (outcome["failed"] == 0 and outcome["answers"] > 0
            and all(v <= lim for v, lim in outcome["checks"].values()))


def result_line(bench, cell: Cell, outcome: dict, device: dict) -> dict:
    correct = judge(outcome)
    line = {
        "correct": correct,
        "attempted": outcome["attempted"],
        "failed": outcome["failed"],
        "metrics": read_metrics(metrics_for(bench, cell.name, cell.trace),
                                outcome),
        "device": device,
    }
    if cell.trace and outcome.get("trace") is not None:
        from portbench import devtrace

        tr = outcome["trace"]
        line["breakdown"] = {
            "device_ops": devtrace.top_ops(tr["events"]),
            "idle_gaps": devtrace.idle_gaps(tr["events"], tr["spans"],
                                            tr["t0"], tr["t1"]),
        }
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in outcome["checks"].items()}
    return line


def cache_dirs(root: Path) -> None:
    """Kernel caches at fixed paths inside the checkout (the program's
    own nvcc output already goes to ``build/`` there)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")


def main(args, root: Path, t_process: float) -> int:
    cache_dirs(root)
    bench, entry, config, traffic = load_cell(root, args.workload)
    # the system under test: a checkout without it has nothing to measure
    import repro_torch.api  # noqa: F401
    import torch

    chips = int(entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA device(s); torch.cuda.is_available() is "
            f"{torch.cuda.is_available()}, device_count "
            f"{torch.cuda.device_count()}")
        return 2
    from portbench import work
    from portbench.graphs import load_module

    log(f"card: {work.card()}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    cell = Cell(name=args.workload, config=config, traffic=traffic,
                seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                device=torch.device("cuda", 0), t_process=t_process,
                chips=chips)
    outcome = load_module("drivers", traffic["driver"]).run(cell)
    found = forbidden_modules()
    if found:
        log(f"JAX or the JAX package was loaded: {found}")
        return 3
    device = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": chips,
        "memory_peak_bytes": outcome["peak_bytes"],
    }
    if cell.trace and outcome.get("trace") is not None:
        from portbench import devtrace

        tr = outcome["trace"]
        device["busy_s"] = devtrace.busy_ns(tr["events"], tr["t0"],
                                            tr["t1"]) / 1e9
        device["window_s"] = (tr["t1"] - tr["t0"]) / 1e9
    line = result_line(bench, cell, outcome, device)
    if outcome["error"]:
        log(f"failed: {outcome['error']}")
    for k, c in line["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(f"correct {line['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0
