"""Weights carried across from the reference.

``repro.models.transformer.init_params``, the GNNs' and BST's
``init_params`` return pytrees; their leaves as numpy arrays
(``jax.tree.map(np.asarray, params)``) become the port's
:class:`TransformerLM`, :class:`GatedGCN`, :class:`GAT`, :class:`SchNet`,
:class:`DimeNet` or :class:`BST`.
Stacked ``[L, ...]`` layer or block leaves (scanned in the reference)
become one module per slice; GAT's per-layer leaves ``W{i}``,
``a_src{i}``, ``a_dst{i}`` one module per index; BST's list of blocks
one module per entry.  The KV cache has the
same ``[L, B, T, Hkv, D]`` layout in both packages.  The tests use both
to hold the port against the reference on the same weights.
:func:`reference_leaf` names the reference leaf behind each of the
port's parameters (the sharding rules' tests read it).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.gnn import dimenet as _dimenet
from repro_torch.models.gnn import gat as _gat
from repro_torch.models.gnn import schnet as _schnet
from repro_torch.models.gnn.gatedgcn import (
    LAYER_LEAVES as _GNN_LEAVES,
    GatedGCN,
    GatedGCNConfig,
)
from repro_torch.models.recsys import bst as _bst
from repro_torch.models.transformer import LMConfig, TransformerLM

_LAYER_LEAVES = ("ln_attn", "ln_mlp", "wq", "wk", "wv", "wo")
_MLP_LEAVES = ("w_gate", "w_up", "w_down")


def _copy(dst: torch.Tensor, src, name: str) -> None:
    src = np.asarray(src)
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: shape {tuple(src.shape)}, the model "
                         f"expects {tuple(dst.shape)}")
    dst.copy_(torch.from_numpy(np.array(src)))


@torch.no_grad()
def lm_params_from_numpy(cfg: LMConfig, tree: dict,
                         device: str | torch.device = "cuda"
                         ) -> TransformerLM:
    """The reference's parameter tree of ``cfg`` (numpy leaves: ``embed``,
    ``ln_final``, optional ``unembed``, and ``layers`` with stacked
    ``[L, ...]`` leaves: ``mlp.*``, or for an MoE config ``moe.router``
    [L, d, E], ``moe.experts.{w_gate, w_up, w_down}`` [L, E, ...] and
    ``moe.shared.*``) as the port's model on ``device``."""
    dev = resolve_device(device)
    model = TransformerLM(cfg)
    layers = tree["layers"]
    names = _LAYER_LEAVES + (("q_norm", "k_norm") if cfg.qk_norm else ())
    for i, lp in enumerate(model.layers):
        for name in names:
            _copy(getattr(lp, name), layers[name][i], f"layers.{name}[{i}]")
        if cfg.moe is None:
            for name in _MLP_LEAVES:
                _copy(lp.mlp[name], layers["mlp"][name][i],
                      f"layers.mlp.{name}[{i}]")
            continue
        moe = layers["moe"]
        _copy(lp.moe.router, moe["router"][i], f"layers.moe.router[{i}]")
        parts = {"experts": lp.moe.experts}
        if lp.moe.shared is not None:
            parts["shared"] = lp.moe.shared
        for part, mods in parts.items():
            for name in _MLP_LEAVES:
                _copy(mods[name], moe[part][name][i],
                      f"layers.moe.{part}.{name}[{i}]")
    _copy(model.embed, tree["embed"], "embed")
    _copy(model.ln_final, tree["ln_final"], "ln_final")
    if model.unembed is not None:
        _copy(model.unembed, tree["unembed"], "unembed")
    elif "unembed" in tree:
        raise ValueError(f"{cfg.name} ties its embeddings; the tree has an "
                         f"unembed")
    return model.to(dev)


@torch.no_grad()
def gatedgcn_params_from_numpy(cfg: GatedGCNConfig, tree: dict,
                               device: str | torch.device = "cuda"
                               ) -> GatedGCN:
    """The reference's GatedGCN parameter tree of ``cfg`` (numpy leaves:
    ``embed_h``, ``embed_e``, ``readout``, and ``layers`` with stacked
    ``[L, ...]`` leaves ``A B C U V ln_h_w ln_h_b ln_e_w ln_e_b``) as the
    port's model on ``device``."""
    dev = resolve_device(device)
    model = GatedGCN(cfg)
    layers = tree["layers"]
    for name in _GNN_LEAVES:
        if len(layers[name]) != cfg.n_layers:
            raise ValueError(f"layers.{name}: {len(layers[name])} layers, "
                             f"the model has {cfg.n_layers}")
    for i, lp in enumerate(model.layers):
        for name in _GNN_LEAVES:
            _copy(getattr(lp, name), layers[name][i], f"layers.{name}[{i}]")
    for name in ("embed_h", "embed_e", "readout"):
        _copy(getattr(model, name), tree[name], name)
    return model.to(dev)


@torch.no_grad()
def gat_params_from_numpy(cfg: _gat.GATConfig, tree: dict,
                          device: str | torch.device = "cuda") -> _gat.GAT:
    """The reference's GAT parameter tree of ``cfg`` (numpy leaves ``W{i}``,
    ``a_src{i}``, ``a_dst{i}`` for each layer i) as the port's model on
    ``device``."""
    dev = resolve_device(device)
    model = _gat.GAT(cfg)
    want = {f"{leaf}{i}" for leaf in _gat.LAYER_LEAVES
            for i in range(cfg.n_layers)}
    if set(tree) != want:
        raise ValueError(f"the tree has leaves {sorted(tree)}; {cfg.name} "
                         f"has {sorted(want)}")
    for i, layer in enumerate(model.layers):
        for leaf in _gat.LAYER_LEAVES:
            _copy(getattr(layer, leaf), tree[f"{leaf}{i}"], f"{leaf}{i}")
    return model.to(dev)


def _stacked(model, tree: dict, blocks, block_leaves, top_leaves) -> None:
    """Copy ``tree``'s top leaves and its ``blocks`` subtree (stacked
    ``[L, ...]`` leaves) into ``model`` and its block modules."""
    for name in block_leaves:
        if len(tree["blocks"][name]) != len(blocks):
            raise ValueError(f"blocks.{name}: {len(tree['blocks'][name])} "
                             f"blocks, the model has {len(blocks)}")
    for i, block in enumerate(blocks):
        for name in block_leaves:
            _copy(getattr(block, name), tree["blocks"][name][i],
                  f"blocks.{name}[{i}]")
    for name in top_leaves:
        _copy(getattr(model, name), tree[name], name)


@torch.no_grad()
def schnet_params_from_numpy(cfg: _schnet.SchNetConfig, tree: dict,
                             device: str | torch.device = "cuda"
                             ) -> _schnet.SchNet:
    """The reference's SchNet parameter tree of ``cfg`` (numpy leaves:
    ``embed``, ``head_w1``, ``head_b1``, ``head_w2``, and ``blocks`` with
    the ``vmap``-initialised ``[L, ...]`` leaves of the interaction
    blocks) as the port's model on ``device``."""
    dev = resolve_device(device)
    model = _schnet.SchNet(cfg)
    _stacked(model, tree, model.blocks, _schnet.BLOCK_LEAVES,
             _schnet.TOP_LEAVES)
    return model.to(dev)


@torch.no_grad()
def dimenet_params_from_numpy(cfg: _dimenet.DimeNetConfig, tree: dict,
                              device: str | torch.device = "cuda"
                              ) -> _dimenet.DimeNet:
    """The reference's DimeNet parameter tree of ``cfg`` (numpy leaves:
    ``embed``, ``w_edge_in``, ``w_out1``, ``w_out2``, and ``blocks`` with
    stacked ``[L, ...]`` block leaves) as the port's model on
    ``device``."""
    dev = resolve_device(device)
    model = _dimenet.DimeNet(cfg)
    _stacked(model, tree, model.blocks, _dimenet.BLOCK_LEAVES,
             _dimenet.TOP_LEAVES)
    return model.to(dev)


@torch.no_grad()
def bst_params_from_numpy(cfg: _bst.BSTConfig, tree: dict,
                          device: str | torch.device = "cuda") -> _bst.BST:
    """The reference's BST parameter tree of ``cfg`` (numpy leaves:
    ``item_embed``, ``pos_embed``, ``profile_embed``, ``blocks``, a list
    of dicts of the block leaves, and ``mlp``, ``w{i}`` and ``b{i}``) as
    the port's model on ``device``."""
    dev = resolve_device(device)
    model = _bst.BST(cfg)
    if len(tree["blocks"]) != len(model.blocks):
        raise ValueError(f"the tree has {len(tree['blocks'])} blocks, the "
                         f"model {len(model.blocks)}")
    if set(tree["mlp"]) != set(model.mlp):
        raise ValueError(f"mlp leaves {sorted(tree['mlp'])}; the model has "
                         f"{sorted(model.mlp)}")
    for i, block in enumerate(model.blocks):
        for name in _bst.BLOCK_LEAVES:
            _copy(getattr(block, name), tree["blocks"][i][name],
                  f"blocks[{i}].{name}")
    for name in _bst.TOP_LEAVES:
        _copy(getattr(model, name), tree[name], name)
    for name, leaf in model.mlp.items():
        _copy(leaf, tree["mlp"][name], f"mlp.{name}")
    return model.to(dev)


def cache_from_numpy(cache, device: str | torch.device = "cuda"):
    """The reference's KV cache ``(k, v)``, numpy ``[L, B, T, Hkv, D]``, as
    the port's on ``device``."""
    dev = resolve_device(device)
    return tuple(torch.from_numpy(np.array(c)).to(dev) for c in cache)


def reference_leaf(model, name: str) -> tuple[tuple, int | None]:
    """The reference leaf behind the port's parameter ``name`` of
    ``model``: ``(path, index)``, ``path`` the keys into the reference's
    tree and ``index`` the slice of its stacked ``[L, ...]`` leaf (None
    for a leaf that is not stacked)."""
    parts = name.split(".")
    if isinstance(model, _gat.GAT):            # W{i}, a_src{i}, a_dst{i}
        return (f"{parts[2]}{parts[1]}",), None
    if isinstance(model, _bst.BST) and parts[0] == "blocks":  # a list
        return ("blocks", int(parts[1]), *parts[2:]), None
    if parts[0] in ("layers", "blocks"):       # stacked [L, ...]
        return (parts[0], *parts[2:]), int(parts[1])
    return tuple(parts), None
