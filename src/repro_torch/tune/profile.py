"""Versioned tuned profiles: the persistent output of a sweep
(counterpart of ``repro.tune.profile``).

A :class:`TunedProfile` is small JSON: the workload-shape signature it
was tuned for, the winning workload-wide ``TCOptions``, the winning
``BudgetGrid`` and one :class:`CellProfile` per budget cell the trace
exercised.  Each cell carries its option override and its **meta
ceiling**, the union of the per-request ``BatchDegreeMeta``\\ s the trace
routed into it.  The meta quantizers commute with ``max``
(:func:`repro_torch.graph.csr.degree_meta`), so seeding the engine's
pooled-meta mark with the ceiling makes every covered flush land on the
prewarmed plan key: that is the prewarm contract.

Loading never crashes a server: a corrupt, missing, newer or
unknown-field file makes :func:`load_profile` return ``None`` with a
warning, and the engine serves with defaults.

The port keeps its profiles in ``results/tuned_torch`` (``PROFILE_DIR``),
apart from the reference's.  :func:`profile_from_reference` carries a
profile file of the reference across.  The port's own profile JSON has
no field the reference's ``TCOptions`` lacks, so the reference reads it
as long as its ``backend`` is ``"auto"``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import warnings
from typing import Optional, Tuple, Union

from repro_torch.api import TCOptions
from repro_torch.graph.csr import BatchDegreeMeta, BudgetGrid, ShapeBudget
from repro_torch.tune.trace import _meta_from_json, _meta_to_json

PROFILE_VERSION = 1

#: directory of the port's profiles (a profile tuned on the card never
#: lands beside the reference's ``results/tuned``)
PROFILE_DIR = os.path.join("results", "tuned_torch")

_OPTION_FIELDS = {f.name for f in dataclasses.fields(TCOptions)}
_TUPLE_OPTION_FIELDS = ("bucket_widths",)

#: the reference's backend names -> the port's
_REFERENCE_BACKENDS = {"auto": "auto", "jnp": "torch", "pallas": "cuda"}


def _options_to_json(options: TCOptions) -> dict:
    d = dataclasses.asdict(options)
    # the grid is persisted once, at the profile's top level
    d.pop("grid", None)
    return d


def _options_from_json(d: dict) -> TCOptions:
    unknown = set(d) - _OPTION_FIELDS
    if unknown:
        raise ValueError(f"unknown TCOptions fields {sorted(unknown)}")
    kw = dict(d)
    for name in _TUPLE_OPTION_FIELDS:
        if kw.get(name) is not None:
            kw[name] = tuple(kw[name])
    return TCOptions(**kw)


def _grid_to_json(grid: BudgetGrid) -> dict:
    return dataclasses.asdict(grid)


def _grid_from_json(d: dict) -> BudgetGrid:
    known = {f.name for f in dataclasses.fields(BudgetGrid)}
    unknown = set(d) - known
    if unknown:
        raise ValueError(f"unknown BudgetGrid fields {sorted(unknown)}")
    return BudgetGrid(**d)


@dataclasses.dataclass(frozen=True)
class CellProfile:
    """Tuned state of one budget cell: option override and meta ceiling."""

    budget: ShapeBudget
    options: Optional[TCOptions] = None  # None: the profile's default
    meta: Optional[BatchDegreeMeta] = None

    def to_json(self) -> dict:
        return {
            "budget": [self.budget.n_budget, self.budget.slot_budget],
            "options": _options_to_json(self.options) if self.options else None,
            "meta": _meta_to_json(self.meta) if self.meta else None,
        }

    @classmethod
    def from_json(cls, d: dict) -> "CellProfile":
        b = d["budget"]
        opts = d.get("options")
        meta = d.get("meta")
        return cls(
            budget=ShapeBudget(int(b[0]), int(b[1])),
            options=_options_from_json(opts) if opts else None,
            meta=_meta_from_json(meta) if meta else None,
        )


@dataclasses.dataclass(frozen=True, eq=False)
class TunedProfile:
    """A sweep winner, keyed by workload-shape signature."""

    signature: str
    options: TCOptions
    grid: BudgetGrid
    cells: Tuple[CellProfile, ...] = ()
    objective: Optional[dict] = None  # the sweep's outcome (graphs/s, ...)
    version: int = PROFILE_VERSION

    def cell_for(self, budget: ShapeBudget) -> Optional[CellProfile]:
        for cell in self.cells:
            if cell.budget == budget:
                return cell
        return None

    def options_for(self, budget: ShapeBudget) -> TCOptions:
        cell = self.cell_for(budget)
        if cell is not None and cell.options is not None:
            return cell.options
        return self.options

    def meta_for(self, budget: ShapeBudget) -> Optional[BatchDegreeMeta]:
        cell = self.cell_for(budget)
        return cell.meta if cell is not None else None

    def to_json(self) -> dict:
        return {
            "version": self.version,
            "signature": self.signature,
            "options": _options_to_json(self.options),
            "grid": _grid_to_json(self.grid),
            "cells": [c.to_json() for c in self.cells],
            "objective": self.objective,
        }

    @classmethod
    def from_json(cls, d: dict) -> "TunedProfile":
        version = int(d["version"])
        if version > PROFILE_VERSION:
            raise ValueError(
                f"profile version {version} > supported {PROFILE_VERSION}")
        return cls(
            signature=str(d["signature"]),
            options=_options_from_json(d["options"]),
            grid=_grid_from_json(d["grid"]),
            cells=tuple(CellProfile.from_json(c) for c in d.get("cells", [])),
            objective=d.get("objective"),
            version=version,
        )

    def save(self, path: str) -> str:
        path = os.fspath(path)
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as fh:
            json.dump(self.to_json(), fh, indent=2, sort_keys=True)
            fh.write("\n")
        return path


def load_profile(path: str) -> Optional[TunedProfile]:
    """Load a profile; on any problem return ``None`` (defaults) with a
    warning, so a bad file never takes a server down."""
    path = os.fspath(path)
    try:
        with open(path) as fh:
            data = json.load(fh)
        return TunedProfile.from_json(data)
    except Exception as exc:  # noqa: BLE001 - degrade, never crash at start
        warnings.warn(
            f"ignoring unusable tuned profile {path!r} ({exc}); "
            "serving with default options",
            stacklevel=2,
        )
        return None


def _reference_options(d: Optional[dict]) -> Optional[dict]:
    if not d:
        return d
    d = dict(d)
    d.pop("interpret", None)  # Pallas interpret mode: no port counterpart
    backend = d.get("backend", "auto")
    if backend not in _REFERENCE_BACKENDS:
        raise ValueError(f"unknown reference backend {backend!r}; expected "
                         f"one of {sorted(_REFERENCE_BACKENDS)}")
    d["backend"] = _REFERENCE_BACKENDS[backend]
    return d


def profile_from_reference(path_or_dict: Union[str, os.PathLike, dict]
                           ) -> TunedProfile:
    """The port's :class:`TunedProfile` of a profile that the reference
    wrote (a path to its JSON, or the parsed dict): ``interpret`` is
    dropped from every option set and ``backend`` is mapped (``jnp`` to
    ``torch``, ``pallas`` to ``cuda``, ``auto`` stays).  Raises on a
    file it cannot carry across."""
    if isinstance(path_or_dict, dict):
        d = path_or_dict
    else:
        with open(os.fspath(path_or_dict)) as fh:
            d = json.load(fh)
    d = dict(d, options=_reference_options(d["options"]),
             cells=[dict(c, options=_reference_options(c.get("options")))
                    for c in d.get("cells", [])])
    return TunedProfile.from_json(d)


def profile_path(signature_or_name: str, directory: str = PROFILE_DIR) -> str:
    """File path of a profile: signatures are slugged to a name."""
    slug = "".join(
        ch if ch.isalnum() or ch in "-_." else "_" for ch in signature_or_name
    )
    return os.path.join(directory, f"{slug}.json")
