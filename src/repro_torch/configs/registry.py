"""The architectures the port runs, by ``--arch`` name, and the
(architecture x input shape) cells of the dry run: the counterpart of
``repro.configs.registry``.

Every architecture of the reference resolves: the LMs (dense and MoE,
trained and served), the four GNNs, the recsys BST (trained, served and
scored) and ``cover-edge-tc``, the paper's own workload (counted by
``repro_torch.api.TriangleEngine``; it trains nothing).
``GNN_FWD_FLOPS`` carries the reference's rough forward FLOP formulas of
the GNNs (``repro.configs.registry._GNN_FWD_FLOPS``).

A :class:`Cell` is what the dry run (``launch/dryrun.py``) reads of one
program on a :class:`~repro_torch.launch.mesh.MeshLayout`: the step
callable, its arguments as tensors on the ``meta`` device (shapes and
dtypes, no storage), their specs under ``distributed/sharding.py``'s
rules, and the roofline metadata (``model_flops``).  40 assigned cells
(10 archs x their 4 shapes) + the paper's own TC workload.  Token and
item ids are int32 as in the reference's cells (the port's steps take
any integer dtype; its streams draw int64).
"""
from __future__ import annotations

import dataclasses
import importlib
import math
from typing import Any, Callable, Optional

import torch

from repro_torch.distributed import sharding as sh
from repro_torch.train.optimizer import OptConfig, opt_init

ARCH_MODULES = {
    "smollm-135m": "repro_torch.configs.smollm_135m",
    "gemma3-4b": "repro_torch.configs.gemma3_4b",
    "gemma3-1b": "repro_torch.configs.gemma3_1b",
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe_a2_7b",
    "phi3.5-moe-42b-a6.6b": "repro_torch.configs.phi35_moe",
    "gatedgcn": "repro_torch.configs.gatedgcn",
    "gat-cora": "repro_torch.configs.gat_cora",
    "dimenet": "repro_torch.configs.dimenet",
    "schnet": "repro_torch.configs.schnet",
    "bst": "repro_torch.configs.bst",
    "cover-edge-tc": "repro_torch.configs.cover_edge_tc",
}

ASSIGNED_ARCHS = [a for a in ARCH_MODULES if a != "cover-edge-tc"]


def arch_module(name: str):
    """The config module of ``name`` (``CONFIG``, ``SMOKE``, ``FAMILY``)."""
    if name in ARCH_MODULES:
        return importlib.import_module(ARCH_MODULES[name])
    raise KeyError(f"unknown --arch {name!r}; the port runs "
                   f"{sorted(ARCH_MODULES)}")


# ------------------------------------------------------------------- GNN
# rough per-layer dense + edge costs of one forward, the reference's
# formulas: n nodes, e edge slots, t triplet slots (DimeNet)


def gatedgcn_fwd_flops(cfg, n: int, e: int) -> int:
    return cfg.n_layers * (5 * n * cfg.d_hidden ** 2
                           + 6 * e * cfg.d_hidden) * 2


def gat_fwd_flops(cfg, n: int, e: int) -> int:
    return (n * cfg.d_in * cfg.d_hidden * cfg.n_heads * 2
            + n * cfg.d_hidden * cfg.n_heads * cfg.n_classes * 2
            + 8 * e * cfg.d_hidden * cfg.n_heads)


def schnet_fwd_flops(cfg, n: int, e: int) -> int:
    return cfg.n_interactions * (
        4 * n * cfg.d_hidden ** 2 * 2 + 2 * e * cfg.n_rbf * cfg.d_hidden
        + 4 * e * cfg.d_hidden)


def dimenet_fwd_flops(cfg, n: int, e: int, t: int = 0) -> int:
    """``t``: the triplet budget of the shape."""
    return cfg.n_blocks * (
        2 * t * (cfg.d_hidden * cfg.n_bilinear           # w_kj gather-side
                 + cfg.n_spherical * cfg.n_radial * cfg.n_bilinear
                 + cfg.n_bilinear ** 2 * cfg.d_hidden)   # bilinear einsum
        + 6 * e * cfg.d_hidden ** 2 * 2)


GNN_FWD_FLOPS = {
    "gatedgcn": gatedgcn_fwd_flops,
    "gat-cora": gat_fwd_flops,
    "schnet": schnet_fwd_flops,
    "dimenet": dimenet_fwd_flops,
}


# ------------------------------------------------------------------ cells

@dataclasses.dataclass
class Cell:
    """One (arch, shape) program.  ``args`` mirror the step's arguments;
    a model enters as its parameters by name.  ``layout`` overrides the
    cell's layout (the TC cell's flat 1-D ``p`` axis)."""
    arch: str
    shape: str
    kind: str
    fn: Optional[Callable]
    args: tuple
    in_specs: Any
    model_flops: float
    skip_reason: Optional[str] = None
    layout: Any = None
    param_count: int = 0

    @property
    def skipped(self) -> bool:
        return self.skip_reason is not None

    def argument_bytes(self, layout) -> int:
        """Bytes one card holds of the arguments (parameters, optimizer
        state, batch or cache) on ``layout`` (or the cell's own)."""
        return sh.per_device_bytes(self.args, self.in_specs,
                                   self.layout or layout)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _shape_params(arch: str, cfg) -> tuple[dict, int]:
    """The parameters of ``cfg``'s model on ``meta`` by name, and their
    count."""
    from repro_torch.launch.steps import shape_model

    params = dict(shape_model(arch, cfg).named_parameters())
    return params, sum(p.numel() for p in params.values())


# ------------------------------------------------------------------- LM

def lm_model_flops(cfg, kind: str, batch: int, s_len: int) -> float:
    """Algorithmically useful FLOPs: 2 x (active non-embedding params) a
    token, the exact causal / windowed attention positions and the LM
    head; train = 3x the forward, remat's recompute not counted."""
    n_embed = cfg.vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    n_body = cfg.active_param_count() - n_embed

    def attn_len(w):
        if w is None or w >= s_len:
            return s_len * s_len / 2
        return s_len * w - w * w / 2

    if kind in ("train", "prefill"):
        tokens = batch * s_len
        attn_positions = sum(attn_len(w) for w in cfg.layer_windows)
        fwd = (
            2.0 * n_body * tokens
            + 4.0 * batch * cfg.n_heads * cfg.d_head * attn_positions
            + 2.0 * tokens * cfg.d_model * cfg.vocab
        )
        return 3.0 * fwd if kind == "train" else fwd
    # decode: one token a sequence against the cache
    lens = sum(
        s_len if w is None else min(w, s_len) for w in cfg.layer_windows
    )
    return (
        2.0 * n_body * batch
        + 4.0 * batch * cfg.n_heads * cfg.d_head * lens
        + 2.0 * batch * cfg.d_model * cfg.vocab
    )


def _lm_cell(arch: str, cfg, shape_name: str, layout, opt_cfg) -> Cell:
    from repro_torch.configs.lm import LM_SHAPES, LONG_CONTEXT_OK
    from repro_torch.launch import steps

    info = LM_SHAPES[shape_name]
    kind, s_len, batch = info["kind"], info["seq_len"], info["global_batch"]
    if shape_name == "long_500k" and cfg.name not in LONG_CONTEXT_OK:
        return Cell(arch, shape_name, kind, None, (), None, 0.0,
                    skip_reason="pure full-attention arch; 512k dense-cache "
                    "decode excluded")
    d_axes = sh.data_axes(layout)
    params, n_params = _shape_params(arch, cfg)
    pspecs = sh.lm_param_specs(params, layout)
    flops = lm_model_flops(cfg, kind, batch, s_len)
    if kind == "train":
        opt = opt_init(opt_cfg, params)
        tokens = _meta((batch, s_len), torch.int32)
        fn = steps.lm_train_step(cfg, opt_cfg)
        args = (params, opt, tokens, tokens)
        bspecs = sh.lm_batch_specs(layout, kind)
        specs = (pspecs, sh.opt_state_specs(pspecs, opt), bspecs["tokens"],
                 bspecs["labels"])
    elif kind == "prefill":
        fn = steps.lm_prefill_step(cfg, max_len=s_len)
        args = (params, _meta((batch, s_len), torch.int32))
        specs = (pspecs, sh.lm_batch_specs(layout, kind)["tokens"])
    else:  # decode; the position is a host int
        cache_shape = (cfg.n_layers, batch, s_len, cfg.n_kv_heads,
                       cfg.d_head)
        cache_dtype = getattr(torch, cfg.act_dtype)  # bf16 cache when bf16
        cache = (_meta(cache_shape, cache_dtype),
                 _meta(cache_shape, cache_dtype))
        fn = steps.lm_decode_step(cfg)
        args = (params, cache, _meta((batch, 1), torch.int32), 0)
        cspec = sh.lm_cache_spec(layout, batch)
        n_data = math.prod(layout.shape[a] for a in d_axes) if d_axes else 1
        tok_spec = (d_axes, None) if batch >= n_data else (None, None)
        specs = (pspecs, (cspec, cspec), tok_spec, None)
    return Cell(arch, shape_name, kind, fn, args, specs, flops,
                param_count=n_params)


# ------------------------------------------------------------------- GNN

def _gnn_cell(arch: str, cfg, shape_name: str, layout, opt_cfg) -> Cell:
    from repro_torch.configs.gnn import GNN_SHAPES
    from repro_torch.launch import steps
    from repro_torch.models.gnn.common import GraphBatch

    info = GNN_SHAPES[shape_name]
    molecular = arch in ("schnet", "dimenet")
    # feature-consuming archs adapt d_in to the shape's dataset
    if not molecular and hasattr(cfg, "d_in"):
        cfg = dataclasses.replace(cfg, d_in=info["d_feat"])
    if shape_name == "minibatch_lg":
        seeds, (f1, f2) = info["batch_nodes"], info["fanout"]
        n = seeds * (1 + f1 + f1 * f2)
        e_slots = seeds * f1 + seeds * f1 * f2
        n_graphs = 1
    elif shape_name == "molecule":
        n = info["n_nodes"] * info["batch"]
        e_slots = 2 * info["n_edges"] * info["batch"]
        n_graphs = info["batch"]
    else:
        n = info["n_nodes"]
        e_slots = 2 * info["n_edges"]
        n_graphs = 1
    d_feat = info["d_feat"]
    # edge slots padded to a multiple of the cards for even sharding
    ndev = layout.size
    e_slots = -(-e_slots // ndev) * ndev
    trip = info["triplet_factor"] * e_slots if arch == "dimenet" else None
    if trip is not None:
        trip = -(-trip // ndev) * ndev
    i32, f32 = torch.int32, torch.float32
    batch = GraphBatch(
        src=_meta((e_slots,), i32), dst=_meta((e_slots,), i32),
        node_feat=None if molecular else _meta((n, d_feat), f32),
        positions=_meta((n, 3), f32) if molecular else None,
        atom_type=_meta((n,), i32) if molecular else None,
        graph_id=_meta((n,), i32),
        labels=_meta((n_graphs,), f32) if molecular else _meta((n,), i32),
        label_mask=None if molecular else _meta((n,), torch.bool),
        trip_kj=_meta((trip,), i32) if trip else None,
        trip_ji=_meta((trip,), i32) if trip else None,
    )
    params, n_params = _shape_params(arch, cfg)
    pspecs = sh.gnn_param_specs(params, layout)
    opt = opt_init(opt_cfg, params)
    fn = steps.gnn_train_step(arch, cfg, opt_cfg)
    args = (params, opt, batch)
    specs = (pspecs, sh.opt_state_specs(pspecs, opt),
             sh.gnn_batch_specs(layout))
    if arch == "dimenet":
        flops = 3.0 * GNN_FWD_FLOPS[arch](cfg, n, e_slots, trip or 0)
    else:
        flops = 3.0 * GNN_FWD_FLOPS[arch](cfg, n, e_slots)
    return Cell(arch, shape_name, "train", fn, args, specs, flops,
                param_count=n_params)


# ------------------------------------------------------------------- BST

def _bst_cell(cfg, shape_name: str, layout, opt_cfg) -> Cell:
    from repro_torch.configs.recsys import RECSYS_SHAPES
    from repro_torch.launch import steps

    info = RECSYS_SHAPES[shape_name]
    kind = info["kind"]
    params, n_params = _shape_params("bst", cfg)
    pspecs = sh.bst_param_specs(params, layout)
    bspecs = sh.bst_batch_specs(layout, kind)
    d = cfg.embed_dim
    seq_flops = cfg.n_blocks * (
        8 * cfg.seq_len * d * d + 4 * cfg.seq_len ** 2 * d
    ) + 2 * sum(
        a * b for a, b in zip(
            (cfg.seq_len * d + d,) + cfg.mlp_dims, cfg.mlp_dims + (1,)
        )
    )
    i32 = torch.int32
    order = ("history", "target", "profile_idx", "profile_bag", "labels")
    if kind in ("train", "serve"):
        b = info["batch"]
        batch = (_meta((b, cfg.seq_len - 1), i32), _meta((b,), i32),
                 _meta((b * cfg.profile_bag,), i32),
                 _meta((b * cfg.profile_bag,), i32),
                 _meta((b,), torch.float32))
        if kind == "train":
            opt = opt_init(opt_cfg, params)
            fn = steps.bst_train_step(cfg, opt_cfg)
            args = (params, opt) + batch
            specs = (pspecs, sh.opt_state_specs(pspecs, opt)) + tuple(
                bspecs[k] for k in order)
            flops = 3.0 * b * seq_flops
        else:
            fn = steps.bst_serve_step(cfg)
            args = (params,) + batch[:4]
            specs = (pspecs,) + tuple(bspecs[k] for k in order[:4])
            flops = 1.0 * b * seq_flops
    else:  # retrieval
        # candidates padded to a 512-multiple so the flat axis divides
        # them on both production layouts (pad slots' scores discarded)
        c = -(-info["n_candidates"] // 512) * 512
        fn = steps.bst_retrieval_step(cfg)
        args = (params, _meta((cfg.seq_len - 1,), i32), _meta((c,), i32))
        specs = (pspecs, bspecs["history"], bspecs["candidates"])
        flops = 1.0 * c * seq_flops
    return Cell("bst", shape_name, kind, fn, args, specs, flops,
                param_count=n_params)


# ------------------------------------------------------------------- TC

def _tc_cell(cfg: dict, shape_name: str, layout) -> Cell:
    from repro_torch.configs.cover_edge_tc import SHAPES
    from repro_torch.core.parallel_tc import build_tc_shard_fn
    from repro_torch.launch.mesh import MeshLayout

    info = {**cfg, **SHAPES[shape_name]}  # the shape owns scale, factor
    info.update({k: v for k, v in cfg.items()
                 if k not in ("scale", "edge_factor", "name")})
    scale, ef = info["scale"], info["edge_factor"]
    n = 1 << scale
    m2 = 2 * ef * n
    # the paper's p processors = a flat 1-D view of the same cards
    p = layout.size
    tc_layout = MeshLayout(("p",), (p,))
    fn, cap_edges, _, _ = build_tc_shard_fn(
        n=n, m2=m2, p=p,
        d_pad=info.get("d_pad", 256),
        mode=info.get("mode", "ring"),
        hedge_chunk=info.get("hedge_chunk", 4096),
        slack=info.get("slack", 4.0),
        frontier_dtype=info.get("frontier_dtype", "int32"),
    )
    args = (_meta((p * cap_edges,), torch.int32),
            _meta((p * cap_edges,), torch.int32))
    # "useful work": one compare a probe, k·m·d̄ probes (k≈0.65, d̄=2·ef)
    flops = 0.65 * (m2 / 2) * (2 * ef) * math.log2(max(cap_edges, 2))
    return Cell("cover-edge-tc", shape_name, "tc", fn, args,
                (("p",), ("p",)), flops, layout=tc_layout)


# ------------------------------------------------------------------- api

def build_cell(arch: str, shape: str, layout, *, opt_cfg=None,
               smoke: bool = False, overrides: dict | None = None) -> Cell:
    """The cell of ``arch`` x ``shape`` on ``layout``.  ``overrides``:
    dataclass-field tweaks of the arch config (e.g. ``{"act_dtype":
    "bfloat16"}``); nested MoE fields use ``"moe.<field>"``; the TC
    workload's dict takes its knobs as they are."""
    mod = arch_module(arch)
    cfg = mod.SMOKE if smoke else mod.CONFIG
    if overrides:
        if isinstance(cfg, dict):  # TC workload: plain dict knobs
            cfg = {**cfg, **overrides}
        else:
            moe_over = {k.split(".", 1)[1]: v for k, v in overrides.items()
                        if k.startswith("moe.")}
            flat_over = {k: v for k, v in overrides.items()
                         if not k.startswith("moe.")}
            if moe_over and getattr(cfg, "moe", None) is not None:
                flat_over["moe"] = dataclasses.replace(cfg.moe, **moe_over)
            cfg = dataclasses.replace(cfg, **flat_over)
    opt_cfg = opt_cfg or OptConfig()
    if mod.FAMILY == "lm":
        return _lm_cell(arch, cfg, shape, layout, opt_cfg)
    if mod.FAMILY == "gnn":
        return _gnn_cell(arch, cfg, shape, layout, opt_cfg)
    if mod.FAMILY == "recsys":
        return _bst_cell(cfg, shape, layout, opt_cfg)
    if mod.FAMILY == "tc":
        return _tc_cell(cfg, shape, layout)
    raise ValueError(arch)


def opt_overrides(arch: str) -> dict:
    """The reference's per-arch execution knobs (math-preserving) that
    the port's configs have."""
    from repro_torch.configs.lm import OPT, OPT_MOE

    mod = arch_module(arch)
    if mod.FAMILY == "lm":
        return dict(OPT_MOE if getattr(mod.CONFIG, "moe", None) else OPT)
    if mod.FAMILY == "tc":
        # d_pad=64 is safe at p >= 256 (max sublist ~ d_max / p; the
        # overflow flag guards production runs)
        return dict(frontier_dtype="uint8", slack=2.0, d_pad=64)
    return {}


def all_cells() -> list[tuple[str, str]]:
    return [(arch, shape) for arch in ASSIGNED_ARCHS
            for shape in arch_module(arch).SHAPES]
