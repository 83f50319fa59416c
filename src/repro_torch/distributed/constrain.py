"""The ambient mesh and mesh-aware optional sharding constraints, the
counterpart of ``repro.distributed.constrain`` (and of the reference's
``compat.set_mesh`` / ``get_abstract_mesh``).

``use_mesh(layout, shards)`` installs a :class:`MeshLayout` and the
shard group that carries its ``model`` axis for the block;
``current_mesh()`` returns them, or ``None`` outside any block.  Model
code reads it instead of taking a mesh argument, so it stays
mesh-agnostic: ``models/moe.py:moe_ffn`` takes the explicit
expert-parallel path (``models/moe_a2a.py``) under a mesh with a
``model`` axis.  The mesh is the process's, not a thread's: a training
step's backward recomputes its checkpointed layers on autograd's
device threads, which must take the path the forward took.

``maybe_constrain(x, *axes)`` is kept where the reference calls it
(the MoE dispatch buffer, the decode step's one-token k/v).  It returns
``x`` unchanged: with no mesh that is the reference's own behaviour,
and with one, eager PyTorch has no partitioner to pin a layout for.
"""
from __future__ import annotations

import contextlib

_MESH = [None]  # the innermost use_mesh block's (layout, shards)


def clean_axis(ax, names):
    """``ax`` (an axis name, a tuple of names or None) with the names the
    mesh lacks removed; None when none is left."""
    if ax is None:
        return None
    if isinstance(ax, (tuple, list)):
        kept = tuple(a for a in ax if a in names)
        return kept if kept else None
    return ax if ax in names else None


@contextlib.contextmanager
def use_mesh(layout, shards=None):
    """Make ``(layout, shards)`` the current mesh for the block.
    ``shards`` is the shard group of ``layout``'s ``model`` axis
    (``LocalShards(n_model, device)`` on one card, or ``GroupShards``
    with one rank a model peer); None takes ``LocalShards`` on the
    activations' device."""
    if shards is not None and "model" in layout.shape \
            and shards.p != layout.shape["model"]:
        raise ValueError(f"the shard group has {shards.p} shards; the "
                         f"layout's model axis {layout.shape['model']}")
    prev = _MESH[0]
    _MESH[0] = (layout, shards)
    try:
        yield layout
    finally:
        _MESH[0] = prev


def current_mesh():
    """``(layout, shards)`` of the innermost ``use_mesh`` block, or
    None."""
    return _MESH[0]


def maybe_constrain(x, *spec_axes):
    """``x``: eager PyTorch has no layout to pin (module docstring)."""
    del spec_axes
    return x
