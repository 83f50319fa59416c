"""Index-dtype policy: one place that decides the index width.

Counterpart of ``repro.analysis.dtypes``.  Device index tensors of the
port are int32: the kernels take int32 offsets and vertex ids, and an
int32 cumsum past 2**31 - 1 would wrap negative without a word (at
Graph500 scale 26 the CSR slot count, 32·n = 2**31, crosses exactly that
line).  So a bound that needs int64 raises :class:`IndexWidthError` at
build time, as the reference does in its default x32 mode, instead of
wrapping an offset at count time.
"""
from __future__ import annotations

import numpy as np
import torch

#: Largest value an int32 index can address.
INT32_MAX = 2**31 - 1

#: Largest value an int64 index can address.
INT64_MAX = 2**63 - 1


class IndexWidthError(OverflowError):
    """An index bound needs a wider dtype than the runtime provides."""


def index_dtype(bound: int) -> np.dtype:
    """Smallest of int32/int64 that exactly represents every index in
    ``[0, bound]``.  ``bound`` is inclusive: an array of ``k`` slots
    whose offsets may equal ``k`` (CSR row offsets do) must pass
    ``bound=k``, not ``k - 1``."""
    bound = int(bound)
    if bound < 0:
        raise ValueError(f"index bound must be >= 0; got {bound}")
    if bound <= INT32_MAX:
        return np.dtype(np.int32)
    if bound <= INT64_MAX:
        return np.dtype(np.int64)
    raise IndexWidthError(
        f"index bound {bound} exceeds int64; no supported index dtype"
    )


def torch_index_dtype(bound: int, *, site: str) -> torch.dtype:
    """:func:`index_dtype` for tensors that cross onto a device: always
    ``torch.int32``, and :class:`IndexWidthError` naming the call site
    for a bound that needs int64."""
    if index_dtype(bound) == np.dtype(np.int64):
        raise IndexWidthError(
            f"{site}: indices up to {bound} need int64, but device index "
            f"tensors are int32 — shard the input below 2**31 slots"
        )
    return torch.int32
