"""Op recorder of the port's auditor: the counterpart of the reference's
jaxpr walker (``repro.analysis.walker``).

The reference walks a lowered program.  The port's programs are eager,
so their counterpart is the list of aten ops a route runs: an
:class:`OpRecorder` (a ``TorchDispatchMode``) records every op's name and
its outputs' shapes and dtypes while a route runs, under a
:meth:`OpRecorder.scope` stack of labels that the passes push.

:data:`SYNC_OPS` are the ops that make the host wait for the device on
CUDA: ``_local_scalar_dense`` (what ``.item()``, ``bool(t)``, ``int(t)``
and ``if t:`` become) and the ops whose output size depends on the data
(``nonzero``, ``masked_select``, the ``unique`` family, ``bincount``,
``repeat_interleave`` without an ``output_size``, and an index by a bool
mask).  On a CUDA run, a blocking copy between the host and the card is
one too; those are recorded as ``_to_copy[d2h]``, ``copy_[h2d]`` and so
on.  The mode does not see ``.cpu()``, ``.tolist()`` or ``.numpy()`` of
a CPU tensor (no op runs); the AST half of the host-sync pass names
those.

Nothing in this module imports the rest of ``repro_torch``.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator

import torch
from torch.utils._python_dispatch import TorchDispatchMode

#: the shard group's collective kinds (``core/shards.py``), each priced by
#: ``core/comm_instrument.py``
COLLECTIVE_PRIMITIVES = ("all_gather", "all_to_all", "ppermute", "psum",
                         "pmax")

#: aten ops that make the host wait for the device on CUDA: a scalar read
#: back, or an output whose size the host must learn first
SYNC_OPS = frozenset({
    "_local_scalar_dense",
    "nonzero",
    "masked_select",
    "_unique",
    "_unique2",
    "unique_dim",
    "unique_consecutive",
    "unique_dim_consecutive",
    "bincount",
    "repeat_interleave",
    "index[bool]",
})

#: ops that copy between devices; a blocking one across the host and the
#: card is a sync
_COPY_OPS = ("_to_copy", "copy_")


@dataclasses.dataclass(frozen=True)
class OpSite:
    """One recorded op: its name (``func.overloadpacket`` without the
    ``aten.`` prefix, with a ``[...]`` tag where the arguments make it a
    sync), its outputs' shapes and dtypes, and the scope labels that
    were open when it ran."""

    op: str
    shapes: tuple
    dtypes: tuple
    scope: tuple[str, ...]


def _tensors(x) -> Iterator[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


def _device_type(x):
    return x.device.type if isinstance(x, torch.Tensor) else None


def _op_name(func, args, kwargs) -> str:
    """The recorded name: a copy across the host and the card gets its
    direction, an index by a bool mask its own tag, and a
    ``repeat_interleave`` whose output size is known is not a sync (it
    gets its own tag)."""
    name = str(func.overloadpacket)
    name = name[len("aten."):] if name.startswith("aten.") else name
    if name in _COPY_OPS and not kwargs.get("non_blocking", False):
        if name == "_to_copy":
            src = _device_type(args[0])
            dst = kwargs.get("device")
            dst = torch.device(dst).type if dst is not None else src
        else:  # copy_(dst, src)
            dst, src = _device_type(args[0]), _device_type(args[1])
            if len(args) > 2 and args[2]:
                return name  # non_blocking=True
        if src == "cuda" and dst == "cpu":
            return f"{name}[d2h]"
        if src == "cpu" and dst == "cuda":
            return f"{name}[h2d]"
    if name == "index" and len(args) > 1:
        if any(t.dtype == torch.bool for t in _tensors(args[1])):
            return "index[bool]"
    if name == "repeat_interleave" and (
            func._overloadname != "Tensor"
            or kwargs.get("output_size") is not None):
        return "repeat_interleave[sized]"
    return name


class OpRecorder(TorchDispatchMode):
    """Record every aten op run inside ``with OpRecorder() as rec:`` into
    ``rec.record`` (a list of :class:`OpSite`), with the labels of the
    :meth:`scope` blocks open at the time."""

    def __init__(self):
        super().__init__()
        self.record: list[OpSite] = []
        self._scope: list[str] = []

    @contextlib.contextmanager
    def scope(self, label: str):
        """Tag the ops of the block with ``label`` (scopes nest)."""
        self._scope.append(str(label))
        try:
            yield
        finally:
            self._scope.pop()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = list(_tensors(out))
        self.record.append(OpSite(
            op=_op_name(func, args, kwargs),
            shapes=tuple(tuple(int(d) for d in t.shape) for t in outs),
            dtypes=tuple(str(t.dtype).replace("torch.", "") for t in outs),
            scope=tuple(self._scope),
        ))
        return out


def sync_ops(record) -> list[OpSite]:
    """Every recorded op that makes the host wait on CUDA (the
    counterpart of the reference's ``callback_eqns``)."""
    return [s for s in record
            if s.op in SYNC_OPS or s.op.endswith(("[d2h]", "[h2d]"))]


def op_counts(sites) -> dict[str, int]:
    """``{op: count}`` of a list of sites, in first-seen order."""
    out: dict[str, int] = {}
    for s in sites:
        out[s.op] = out.get(s.op, 0) + 1
    return out
