"""Dry run of every (architecture x input shape) cell on the production
layouts, on the host alone: the counterpart of ``repro.launch.dryrun``.

  python -m repro_torch.launch.dryrun --mesh pod --list
  python -m repro_torch.launch.dryrun --mesh pod          # (16, 16) = 256
  python -m repro_torch.launch.dryrun --mesh multipod     # (2, 16, 16)
  python -m repro_torch.launch.dryrun --arch gemma3-1b --shape long_500k

Each cell is built on the ``meta`` device (``configs/registry.py:
build_cell``): shapes and dtypes, no storage, no card.  Per cell it
records ``arch``, ``shape``, ``kind``, ``status`` (``ok``, ``skipped``
or ``error``), ``model_flops``, ``param_count`` and ``argument_bytes``,
the bytes one card holds of the step's arguments (parameters, optimizer
state, batch or cache) under ``distributed/sharding.py``'s rules; a
dimension that does not divide over its axes is an ``error``.  The
reference also records what XLA's compiled program reports (temporary
bytes, HLO FLOPs, collective bytes); eager PyTorch compiles no program,
so the port has no counterpart of those.  Results go to
``results/dryrun_torch_<mesh>[_opt].json`` unless ``--out`` says
otherwise.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from pathlib import Path

RESULTS = Path(__file__).resolve().parents[3] / "results"


def run_cell(arch: str, shape: str, layout, *, smoke: bool = False,
             overrides: dict | None = None) -> dict:
    """The record of one cell (module docstring)."""
    from repro_torch.configs.registry import build_cell

    t0 = time.perf_counter()
    cell = build_cell(arch, shape, layout, smoke=smoke, overrides=overrides)
    if cell.skipped:
        return {"arch": arch, "shape": shape, "kind": cell.kind,
                "status": "skipped", "reason": cell.skip_reason,
                "model_flops": 0.0}
    return {
        "arch": arch,
        "shape": shape,
        "kind": cell.kind,
        "status": "ok",
        "model_flops": cell.model_flops,
        "param_count": cell.param_count,
        "argument_bytes": cell.argument_bytes(layout),
        "build_s": round(time.perf_counter() - t0, 4),
    }


def parse_overrides(text: str | None) -> dict | None:
    """``k=v[,k=v...]``: ints, floats and bools parsed, the rest kept as
    strings."""
    if not text:
        return None
    out = {}
    for kv in text.split(","):
        k, v = kv.split("=", 1)
        if v in ("true", "True", "false", "False"):
            v = v in ("true", "True")
        else:
            for conv in (int, float):
                try:
                    v = conv(v)
                    break
                except ValueError:
                    pass
        out[k] = v
    return out


def select_cells(arch=None, shape=None, include_tc=False) -> list:
    from repro_torch.configs.registry import all_cells

    cells = all_cells()
    if include_tc:
        cells.append(("cover-edge-tc", "rmat_pod"))
    if arch:
        cells = [(a, s) for a, s in cells if a == arch]
    if shape:
        cells = [(a, s) for a, s in cells if s == shape]
    return cells


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mesh", choices=["pod", "multipod"], default="pod")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--include-tc", action="store_true",
                    help="also run the paper's TC workload cell")
    ap.add_argument("--set", default=None, dest="overrides",
                    help="config overrides k=v[,k=v...], e.g. "
                         "--set act_dtype=bfloat16,moe.dispatch=a2a")
    ap.add_argument("--tag", default=None,
                    help="result key suffix for variant runs")
    ap.add_argument("--opt", action="store_true",
                    help="apply each arch's execution knobs "
                         "(registry.opt_overrides); writes *_opt.json")
    ap.add_argument("--out", default=None,
                    help="result file (default results/dryrun_torch_"
                         "<mesh>[_opt].json)")
    args = ap.parse_args(argv)
    overrides = parse_overrides(args.overrides)

    from repro_torch.configs.registry import opt_overrides
    from repro_torch.launch.mesh import make_production_mesh

    cells = select_cells(args.arch, args.shape, args.include_tc)
    if args.list:
        for a, s in cells:
            print(f"{a} x {s}")
        return 0

    layout = make_production_mesh(multi_pod=args.mesh == "multipod")
    print(f"mesh: {layout.shape} = {layout.size} devices")
    suffix = "_opt" if args.opt else ""
    out_path = (Path(args.out) if args.out
                else RESULTS / f"dryrun_torch_{args.mesh}{suffix}.json")
    out_path.parent.mkdir(parents=True, exist_ok=True)
    results = {}
    if out_path.exists():
        results = json.loads(out_path.read_text())
    failures = 0
    t_all = time.perf_counter()
    for arch, shape in cells:
        key = f"{arch}|{shape}" + (f"|{args.tag}" if args.tag else "")
        try:
            cell_over = overrides
            if args.opt:
                cell_over = {**opt_overrides(arch), **(overrides or {})}
            rec = run_cell(arch, shape, layout, smoke=args.smoke,
                           overrides=cell_over)
            if args.tag:
                rec["variant"] = args.tag
                rec["overrides"] = overrides
            extra = (f" flops={rec['model_flops']:.4g}"
                     f" argB={rec['argument_bytes']:,}"
                     if rec["status"] == "ok" else f" ({rec['reason']})")
            print(f"[{rec['status']:>7}] {arch} x {shape}{extra}",
                  flush=True)
        except Exception as e:  # noqa: BLE001 - recorded, run goes on
            failures += 1
            rec = {"arch": arch, "shape": shape, "status": "error",
                   "error": f"{type(e).__name__}: {e}"}
            print(f"[  ERROR] {arch} x {shape}: {e}", flush=True)
            traceback.print_exc()
        results[key] = rec
    out_path.write_text(json.dumps(results, indent=1))
    print(f"\n{len(cells) - failures}/{len(cells)} cells OK in "
          f"{time.perf_counter() - t_all:.2f} s -> {out_path}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
