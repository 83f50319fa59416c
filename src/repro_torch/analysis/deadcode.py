"""Unused-public-symbol scan of the port (counterpart of
``repro.analysis.deadcode``).

A public symbol nobody calls reads as supported surface, bit-rots
unseen and hides real seams.  Every top-level public ``def`` / ``class``
/ CONSTANT of ``src/repro_torch`` with zero word-boundary references
outside its defining module, across the port's production surface
(``src/repro_torch`` and ``chip_smoke.py``), is a finding.

Tests are NOT references, as in the reference: a symbol only its own
test touches is still unreachable from the engine.  The scan is
conservative about flagging: any word-boundary hit beyond the definition
itself (an internal call, a re-export, a docstring cross-reference, a
string-keyed dispatch) counts.  Findings are warnings, pinned in the
baseline: the gate is on NEW dead exports appearing (or pinned ones
vanishing without a baseline regen).
"""
from __future__ import annotations

import ast
import re
from pathlib import Path

from repro_torch.analysis.findings import Finding, finding_data

#: paths (relative to the repo root) whose .py files count as the
#: production reference surface: a directory or one file
REFERENCE_PATHS = ("src/repro_torch", "chip_smoke.py")

#: scan root for defined symbols
DEFINITION_DIR = "src/repro_torch"


def repo_root(start: Path | None = None) -> Path:
    """Nearest ancestor containing ``src/repro_torch`` — the scan
    anchor."""
    here = (start or Path(__file__)).resolve()
    for parent in (here, *here.parents):
        if (parent / DEFINITION_DIR).is_dir():
            return parent
    raise FileNotFoundError(f"{DEFINITION_DIR} not found above {here}")


def public_symbols(path: Path) -> list[str]:
    """Top-level public definitions of one module: functions, classes,
    and UPPER_CASE constants (the shapes a caller would import)."""
    tree = ast.parse(Path(path).read_text())
    out: list[str] = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            if not node.name.startswith("_"):
                out.append(node.name)
        elif isinstance(node, ast.Assign):
            for tgt in node.targets:
                if (isinstance(tgt, ast.Name)
                        and not tgt.id.startswith("_")
                        and tgt.id.isupper()):
                    out.append(tgt.id)
        elif isinstance(node, ast.AnnAssign):
            tgt = node.target
            if (isinstance(tgt, ast.Name) and not tgt.id.startswith("_")
                    and tgt.id.isupper()):
                out.append(tgt.id)
    return out


def _reference_files(base: Path) -> list[Path]:
    out: list[Path] = []
    for rel in REFERENCE_PATHS:
        p = base / rel
        if p.is_dir():
            out.extend(sorted(p.rglob("*.py")))
        elif p.is_file():
            out.append(p)
    return out


def find_unused_symbols(root: Path | None = None) -> list[dict]:
    """``[{module, symbol}]`` for every public symbol of
    ``src/repro_torch`` with zero references in any OTHER production
    file."""
    base = root or repo_root()
    def_files = sorted((base / DEFINITION_DIR).rglob("*.py"))
    texts = {p: p.read_text() for p in _reference_files(base)}
    unused: list[dict] = []
    for path in def_files:
        if path.name == "__init__.py":
            continue  # re-export shims: their names live elsewhere
        module = str(path.relative_to(base / "src")).replace(
            "/", ".").removesuffix(".py")
        own = texts.get(path, path.read_text())
        for sym in public_symbols(path):
            pat = re.compile(rf"\b{re.escape(sym)}\b")
            # the definition line itself contributes exactly one hit in
            # the defining module; anything past that — internal call,
            # cross-module import, docstring cross-ref — is a taker
            refs = len(pat.findall(own)) - 1
            refs += sum(len(pat.findall(text))
                        for p, text in texts.items() if p != path)
            if refs <= 0:
                unused.append({"module": module, "symbol": sym})
    return unused


def audit_deadcode(root: Path | None = None) -> list[Finding]:
    """One warning finding per unreachable public symbol."""
    return [
        Finding(
            pass_name="deadcode",
            site=f"unused:{u['module']}:{u['symbol']}",
            severity="warning",
            detail=(
                f"public symbol `{u['symbol']}` in {u['module']} has no "
                f"references in src/repro_torch or chip_smoke.py — "
                f"unreachable export; wire it up, delete it, or document "
                f"it as a seam and pin it in the baseline"
            ),
            data=finding_data(**u),
        )
        for u in find_unused_symbols(root)
    ]
