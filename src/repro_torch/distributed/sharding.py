"""Layout-to-parameter and activation sharding rules per architecture
family, the counterparts of ``repro.distributed.sharding``.

Layout axes: ``pod`` (optional outer), ``data``, ``model``.  ``flat``
below means all axes collapsed, used for graph-edge and candidate
sharding.

LM      : DP batch over (pod, data); TP over model (attention heads,
          d_ff, vocab rows); MoE experts over model (EP); long-context
          cells shard the KV cache's T axis over data.
GNN     : edges over flat, node states and weights replicated.
RecSys  : DP batch; embedding tables row-sharded over model.
TC      : the paper's 1-D processor axis == flat.

A spec is a tuple with one entry per leading dimension: an axis name, a
tuple of names (sharded over their product), or None; dimensions past
its end are not sharded, as with a shorter ``PartitionSpec``.  The
parameter rules take the port's parameters, a dict from
``named_parameters()`` names (``layers.3.moe.experts.w_gate``) to
tensors, and give a full-length spec for each.  The reference stacks the
layers under a leading ``L`` axis that is never sharded; the port keeps
a module a layer, so a port leaf's spec is the reference leaf's without
that leading entry.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any


def data_axes(layout) -> tuple:
    return tuple(a for a in ("pod", "data") if a in layout.shape)


def flat_axes(layout) -> tuple:
    return tuple(a for a in ("pod", "data", "model") if a in layout.shape)


def _replicated(leaf) -> tuple:
    return (None,) * leaf.dim()


# ---------------------------------------------------------------- LM rules

def lm_param_spec(name: str, leaf) -> tuple:
    """The spec of one LM parameter by its name."""
    parts = name.split(".")
    last = parts[-1]
    if "experts" in parts:  # [E, d, f] or [E, f, d]: expert-parallel on E
        return ("model",) + (None,) * (leaf.dim() - 1)
    if last in ("embed", "unembed", "profile_embed", "item_embed"):
        return ("model", None)
    if last in ("wq", "wk", "wv", "w_gate", "w_up"):
        return (None, "model")
    if last in ("wo", "w_down"):
        return ("model", None)
    if last == "router":
        return (None, None)
    return _replicated(leaf)  # norms


def lm_param_specs(params: dict, layout) -> dict:
    del layout
    return {k: lm_param_spec(k, v) for k, v in params.items()}


def lm_batch_specs(layout, kind: str) -> dict:
    d = data_axes(layout)
    if kind == "train":
        return {"tokens": (d, None), "labels": (d, None)}
    if kind == "prefill":
        return {"tokens": (d, None)}
    raise ValueError(kind)


def lm_cache_spec(layout, batch: int) -> tuple:
    """[L, B, T, Hkv, D]: B over data when it divides; T over model
    (context-parallel decode).  For tiny batches (long_500k) T takes
    (data + model)."""
    d = data_axes(layout)
    ndev = math.prod(layout.shape[a] for a in d) if d else 1
    m = ("model",) if "model" in layout.shape else ()
    if batch >= ndev:
        return (None, d, m, None, None)
    return (None, None, d + m, None, None)


# ---------------------------------------------------------------- GNN rules

def gnn_param_specs(params: dict, layout) -> dict:
    # GNN models are tiny: replicate the weights, shard the edges
    del layout
    return {k: _replicated(v) for k, v in params.items()}


def gnn_batch_specs(layout) -> dict:
    f = flat_axes(layout)
    return {
        "src": (f,), "dst": (f,),
        "node_feat": (), "positions": (), "atom_type": (),
        "graph_id": (), "labels": (), "label_mask": (),
        "trip_kj": (f,), "trip_ji": (f,),
    }


# ---------------------------------------------------------------- recsys

def bst_param_spec(name: str, leaf) -> tuple:
    last = name.split(".")[-1]
    if last in ("item_embed", "profile_embed"):
        return ("model", None)
    if last == "w0" and leaf.dim() == 2:  # the MLP's first matrix
        return (None, "model")
    return _replicated(leaf)


def bst_param_specs(params: dict, layout) -> dict:
    del layout
    return {k: bst_param_spec(k, v) for k, v in params.items()}


def bst_batch_specs(layout, kind: str) -> dict:
    d = data_axes(layout)
    f = flat_axes(layout)
    if kind in ("train", "serve"):
        return {
            "history": (d, None), "target": (d,), "profile_idx": (d,),
            "profile_bag": (d,), "labels": (d,),
        }
    if kind == "retrieval":
        return {"history": (), "candidates": (f,)}
    raise ValueError(kind)


def opt_state_specs(param_specs: dict, opt_state: dict) -> dict:
    """Adam's moments (``mu``, ``nu``) mirror their parameter's spec;
    Adafactor's factored vectors are small and replicated.  The step
    ``count`` is a host int (``train/optimizer.py``): no device
    argument, spec None."""

    def rep(sub):
        if isinstance(sub, dict):
            return {k: rep(v) for k, v in sub.items()}
        return () if hasattr(sub, "dim") else None

    return {key: (param_specs if key in ("mu", "nu") else rep(sub))
            for key, sub in opt_state.items()}


# ------------------------------------------------------------ shard shapes

def _axis_names(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_shape(shape, spec, layout) -> tuple:
    """One card's block of an array of ``shape`` laid out by ``spec``;
    raises ``ValueError`` on a dimension its axes do not divide (as
    ``NamedSharding.shard_shape``)."""
    shape = tuple(int(s) for s in shape)
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape {shape}")
    out = []
    for i, n in enumerate(shape):
        names = _axis_names(spec[i] if i < len(spec) else None)
        for a in names:
            if a not in layout.shape:
                raise ValueError(f"axis {a!r} of spec {spec} is not in the "
                                 f"layout's {layout.axes}")
        ways = math.prod(layout.shape[a] for a in names)
        if n % ways:
            raise ValueError(f"dimension {i} of {shape} ({n}) does not "
                             f"divide over {names} ({ways} ways)")
        out.append(n // ways)
    return tuple(out)


def per_device_bytes(tree: Any, specs: Any, layout) -> int:
    """Bytes one card holds of ``tree`` (nested dicts, dataclasses,
    tuples and lists of tensors, with ``specs`` of the same structure):
    each tensor's ``shard_shape`` times its element size.  Leaves that
    are not tensors (a host int) hold nothing on the card."""
    if dataclasses.is_dataclass(tree):  # a GraphBatch: specs by field
        tree = {f.name: getattr(tree, f.name)
                for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        return sum(per_device_bytes(v, specs.get(k), layout)
                   for k, v in tree.items())
    if isinstance(tree, (tuple, list)):
        return sum(per_device_bytes(v, s, layout)
                   for v, s in zip(tree, specs, strict=True))
    if tree is None or not hasattr(tree, "dim"):
        return 0
    return math.prod(shard_shape(tree.shape, specs, layout)) \
        * tree.element_size()
