"""Step builders, the counterparts of ``repro.launch.steps``: the
training step (``make_train_step``; ``gnn_train_step`` and
``bst_train_step`` over it), the LM serving steps (``lm_prefill_step``,
``lm_decode_step``), BST's serving and retrieval
steps (``bst_serve_step``, ``bst_retrieval_step``), ``init_for`` and
``shape_model`` (a model on the ``meta`` device, for the dry run).

A training step is the forward, ``loss.backward()`` and ``opt_update``,
in place on the model and the optimizer state.  The reference's
gradient accumulation (``accum``) serves its dry-run compiler, which the
port does not have.  The LMs (dense and MoE), the four GNNs and BST
train; a serving or retrieval step runs without gradients.
"""
from __future__ import annotations

from typing import Callable, get_type_hints

import torch
from torch import nn

from repro_torch.configs.registry import arch_module
from repro_torch.models import transformer as tfm
from repro_torch.models.gnn import dimenet as dimenet_m
from repro_torch.models.gnn import gat as gat_m
from repro_torch.models.gnn import gatedgcn as gatedgcn_m
from repro_torch.models.gnn import schnet as schnet_m
from repro_torch.models.recsys import bst as bst_m
from repro_torch.train.optimizer import OptConfig, opt_update

GNN_MODULES = {
    "gatedgcn": gatedgcn_m,
    "gat-cora": gat_m,
    "schnet": schnet_m,
    "dimenet": dimenet_m,
}


def make_train_step(loss_fn: Callable, opt_cfg: OptConfig):
    """``loss_fn(model, *batch) -> scalar``.  Returns ``step(model,
    opt_state, *batch) -> (opt_state, metrics)``: the gradients of the
    loss, clipped, then one optimizer update of the model's parameters
    and ``opt_state`` in place; ``metrics`` holds ``loss`` and
    ``grad_norm`` as 0-d tensors on the model's device (nothing is read
    back)."""

    def step(model: nn.Module, opt_state, *batch):
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        loss = loss_fn(model, *batch)
        loss.backward()
        grads = {k: p.grad for k, p in params.items()}
        _, opt_state, gn = opt_update(opt_cfg, grads, opt_state, params)
        return opt_state, {"loss": loss.detach(), "grad_norm": gn}

    return step


# ------------------------------------------------------------------- LM

def lm_loss(cfg: tfm.LMConfig):
    """``loss(model, tokens, labels)``: the reference's ``lm_loss``."""
    del cfg  # the model carries its config
    return tfm.loss_fn


def lm_train_step(cfg: tfm.LMConfig, opt_cfg: OptConfig):
    return make_train_step(lm_loss(cfg), opt_cfg)


def lm_prefill_step(cfg: tfm.LMConfig, max_len: int):
    def step(model: tfm.TransformerLM, tokens: torch.Tensor):
        return model.prefill(tokens, max_len)
    return step


def lm_decode_step(cfg: tfm.LMConfig):
    def step(model: tfm.TransformerLM, cache, token: torch.Tensor,
             index: int):
        return model.decode_step(cache, token, index)
    return step


# ------------------------------------------------------------------- GNN

def gnn_train_step(arch: str, cfg, opt_cfg: OptConfig):
    return make_train_step(GNN_MODULES[arch].loss_fn, opt_cfg)


# ------------------------------------------------------------------- BST

def bst_train_step(cfg: bst_m.BSTConfig, opt_cfg: OptConfig):
    """``step(model, opt_state, history, target, profile_idx,
    profile_bag, labels)``: ``bst.loss_fn``'s gradients, one update."""
    del cfg  # the model carries its config
    return make_train_step(bst_m.loss_fn, opt_cfg)


def bst_serve_step(cfg: bst_m.BSTConfig):
    """``step(model, history, target, profile_idx, profile_bag)``: the
    CTR logits [B], without gradients."""
    del cfg

    @torch.no_grad()
    def step(model: bst_m.BST, history, target, profile_idx, profile_bag):
        return model(history, target, profile_idx, profile_bag)
    return step


def bst_retrieval_step(cfg: bst_m.BSTConfig):
    """``step(model, history, candidates)``: the scores [C] of one
    history against C candidates (``score_candidates``, in slices of
    ``bst.RETRIEVAL_SLICE``), without gradients."""
    del cfg

    @torch.no_grad()
    def step(model: bst_m.BST, history, candidates):
        return model.score_candidates(history, candidates)
    return step


# ------------------------------------------------------------------- init

def init_for(arch: str, cfg, seed: int = 0,
             device: str | torch.device = "cuda") -> nn.Module:
    """Random weights of ``cfg`` from ``seed`` for a model of
    ``configs.registry``; ``cover-edge-tc`` (family ``tc``) has none and
    raises."""
    mod = arch_module(arch)
    if arch in GNN_MODULES:
        return GNN_MODULES[arch].init_params(cfg, seed, device)
    if mod.FAMILY == "recsys":
        return bst_m.init_params(cfg, seed, device)
    if mod.FAMILY != "lm":
        raise ValueError(f"--arch {arch}: the {mod.FAMILY} family has no "
                         f"weights; repro_torch.api.TriangleEngine counts "
                         f"its graphs")
    return tfm.init_params(cfg, seed, device)


def shape_model(arch: str, cfg) -> nn.Module:
    """The model of ``cfg`` built on the ``meta`` device: its parameters'
    names, shapes and dtypes, no storage and no draw (the dry run's
    cells)."""
    mod = arch_module(arch)
    with torch.device("meta"):
        if arch in GNN_MODULES:   # the class its init_params returns
            return get_type_hints(GNN_MODULES[arch].init_params)[
                "return"](cfg)
        if mod.FAMILY == "recsys":
            return bst_m.BST(cfg)
        if mod.FAMILY == "lm":
            return tfm.TransformerLM(cfg)
    raise ValueError(f"--arch {arch}: the {mod.FAMILY} family has no "
                     f"weights")
