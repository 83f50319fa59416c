"""Behavior Sequence Transformer (Chen et al., arXiv:1905.06874, Alibaba),
the counterpart of ``repro.models.recsys.bst``.

Config: embed_dim 32, seq_len 20 (19 history + 1 target), one
transformer block of 8 heads, MLP 1024-512-256 -> one CTR logit.

* The item lookup over the ~1M-row table is ``index_select``, and so is
  the position lookup; the table's gradient is the gather's backward, an
  ``index_add_``.  One card holds the whole table: the reference
  row-shards it over its mesh's ``model`` axis.
* The profile features are ``graph/segment.py:embedding_bag`` (mode
  ``sum``): the gather, then the bag sum on K4 on the card.
* The block's attention has no mask; its logits are ``einsum`` products,
  its softmax is taken in float32 and the post-LayerNorms use eps 1e-5,
  as in the reference.  At a head width of 4 it is plain torch ops: K5
  takes D 16-256.
* ``BST.score_candidates`` is the retrieval cell: one user history
  against C candidates, the sequence tower run once per candidate (BST
  is target-aware), the profile vector zero.  It scores the candidates
  in slices of ``RETRIEVAL_SLICE`` rows to bound the activations'
  memory (the attention logits of 10^6 candidates alone are ~13 GB);
  every candidate is scored once, in order, and its score is a one-shot
  call's to float32 rounding (a GEMM may block by its row count).

Weights keep the reference's layout (``x @ w``), so its tree carries
across as it is (``models/convert.py:bst_params_from_numpy``).
"""
from __future__ import annotations

import dataclasses
import time

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.graph.segment import embedding_bag
from repro_torch.models.layers import (
    bce_logits,
    dense_init,
    draw_parallel,
    embed_init,
    layernorm,
    mlp_stack,
    mlp_stack_init,
)

#: one block's leaves: the four attention matrices, the feed-forward
#: pair and the two LayerNorms
BLOCK_LEAVES = ("wq", "wk", "wv", "wo", "ff1", "ff2",
                "ln1_w", "ln1_b", "ln2_w", "ln2_b")
#: the model's leaves outside its blocks and its MLP
TOP_LEAVES = ("item_embed", "pos_embed", "profile_embed")
#: candidates scored at a time by ``BST.score_candidates``: the attention
#: logits of a slice are 262,144 x 8 heads x 20 x 20 float32, ~3.4 GB
#: (~13 GB for 10^6 candidates in one call)
RETRIEVAL_SLICE = 262_144


@dataclasses.dataclass(frozen=True)
class BSTConfig:
    name: str = "bst"
    embed_dim: int = 32
    seq_len: int = 20          # 19 history + target
    n_blocks: int = 1
    n_heads: int = 8
    mlp_dims: tuple[int, ...] = (1024, 512, 256)
    item_vocab: int = 1_048_576
    profile_vocab: int = 65_536  # multi-hot user profile features
    profile_bag: int = 8         # lookups per user
    dtype: str = "float32"


def mlp_shape(cfg: BSTConfig) -> tuple[int, ...]:
    """The MLP's widths: the flattened sequence and the profile vector
    in, ``mlp_dims``, one logit out."""
    flat = cfg.seq_len * cfg.embed_dim + cfg.embed_dim
    return (flat,) + tuple(cfg.mlp_dims) + (1,)


class BSTBlock(nn.Module):
    """Post-LayerNorm transformer block: unmasked multi-head attention,
    then a ReLU feed-forward of width 4d."""

    def __init__(self, d: int, n_heads: int, dtype: torch.dtype):
        super().__init__()
        self.n_heads = n_heads
        for name in ("wq", "wk", "wv", "wo"):
            setattr(self, name, nn.Parameter(torch.zeros((d, d),
                                                         dtype=dtype)))
        self.ff1 = nn.Parameter(torch.zeros((d, 4 * d), dtype=dtype))
        self.ff2 = nn.Parameter(torch.zeros((4 * d, d), dtype=dtype))
        self.ln1_w = nn.Parameter(torch.ones((d,), dtype=dtype))
        self.ln1_b = nn.Parameter(torch.zeros((d,), dtype=dtype))
        self.ln2_w = nn.Parameter(torch.ones((d,), dtype=dtype))
        self.ln2_b = nn.Parameter(torch.zeros((d,), dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        h = self.n_heads
        dh = d // h
        q = (x @ self.wq).reshape(b, s, h, dh)
        k = (x @ self.wk).reshape(b, s, h, dh)
        v = (x @ self.wv).reshape(b, s, h, dh)
        logits = torch.einsum("bshd,bthd->bhst", q, k) * dh ** -0.5
        probs = torch.softmax(logits.float(), dim=-1).to(x.dtype)
        attn = torch.einsum("bhst,bthd->bshd", probs, v).reshape(b, s, d)
        x = layernorm(x + attn @ self.wo, self.ln1_w, self.ln1_b)
        ff = F.relu(x @ self.ff1) @ self.ff2
        return layernorm(x + ff, self.ln2_w, self.ln2_b)


class BST(nn.Module):
    """CTR logits [B] of ``(history, target, profile_idx, profile_bag)``."""

    def __init__(self, cfg: BSTConfig):
        super().__init__()
        self.cfg = cfg
        dt = getattr(torch, cfg.dtype)
        d = cfg.embed_dim
        self.item_embed = nn.Parameter(torch.zeros((cfg.item_vocab, d),
                                                   dtype=dt))
        self.pos_embed = nn.Parameter(torch.zeros((cfg.seq_len, d),
                                                  dtype=dt))
        self.profile_embed = nn.Parameter(torch.zeros((cfg.profile_vocab, d),
                                                      dtype=dt))
        self.blocks = nn.ModuleList(BSTBlock(d, cfg.n_heads, dt)
                                    for _ in range(cfg.n_blocks))
        dims = mlp_shape(cfg)
        self.mlp = nn.ParameterDict(
            {f"w{i}": nn.Parameter(torch.zeros((dims[i], dims[i + 1]),
                                               dtype=dt))
             for i in range(len(dims) - 1)}
            | {f"b{i}": nn.Parameter(torch.zeros((dims[i + 1],), dtype=dt))
               for i in range(len(dims) - 1)})

    def sequence_tower(self, seq_ids: torch.Tensor) -> torch.Tensor:
        """int[B, seq_len] (history, then target) -> [B, seq_len * d]."""
        b, s = seq_ids.shape
        x = self.item_embed.index_select(0, seq_ids.reshape(-1).long())
        x = x.reshape(b, s, -1) + self.pos_embed[None]
        for block in self.blocks:
            x = block(x)
        return x.reshape(b, -1)

    def head(self, seq_repr: torch.Tensor, prof: torch.Tensor):
        feats = torch.cat([seq_repr, prof.to(seq_repr.dtype)], dim=1)
        return mlp_stack(self.mlp, feats, n=len(self.cfg.mlp_dims) + 1)[:, 0]

    def forward(self, history: torch.Tensor, target: torch.Tensor,
                profile_idx: torch.Tensor,
                profile_bag: torch.Tensor) -> torch.Tensor:
        """history int[B, seq_len - 1]; target int[B]; profile_idx
        int[B * bag], flat lookups with bag ids ``profile_bag`` (a bag id
        outside [0, B) drops its lookup)."""
        b = history.shape[0]
        seq = torch.cat([history, target[:, None].to(history.dtype)], dim=1)
        seq_repr = self.sequence_tower(seq)
        prof = embedding_bag(self.profile_embed, profile_idx, profile_bag,
                             b, mode="sum")
        return self.head(seq_repr, prof)

    def score_candidates(self, history: torch.Tensor,
                         candidates: torch.Tensor) -> torch.Tensor:
        """history int[seq_len - 1]; candidates int[C] -> scores [C]: the
        tower once per candidate, the profile vector zero;
        ``RETRIEVAL_SLICE`` candidates at a time."""
        c = candidates.shape[0]
        step = RETRIEVAL_SLICE
        out = torch.empty((c,), dtype=self.item_embed.dtype,
                          device=self.item_embed.device)
        for lo in range(0, c, step):
            cand = candidates[lo:lo + step]
            hist = history[None].expand(cand.shape[0], history.shape[0])
            seq = torch.cat([hist, cand[:, None].to(history.dtype)], dim=1)
            seq_repr = self.sequence_tower(seq)
            prof = seq_repr.new_zeros((cand.shape[0], self.cfg.embed_dim))
            out[lo:lo + step] = self.head(seq_repr, prof)
        return out


def loss_fn(model: BST, history, target, profile_idx, profile_bag,
            labels) -> torch.Tensor:
    """Mean binary cross-entropy of the CTR logits (``bce_logits``)."""
    return bce_logits(model(history, target, profile_idx, profile_bag),
                      labels)


@torch.no_grad()
def init_params(cfg: BSTConfig, seed: int = 0,
                device: str | torch.device = "cuda") -> BST:
    """A model with random weights (the reference's initialisers:
    ``embed_init`` for the three tables, ``dense_init`` for the blocks'
    and the MLP's matrices, ones and zeros for the LayerNorms, zeros for
    the biases), built on ``device``.  Each matrix is drawn on the CPU
    from its own generator, seeded by ``(seed, leaf)`` through
    ``seeded_generator`` (a block's by ``(seed, 3, block, leaf)``, the
    MLP's stack by ``(seed, 4)`` through ``mlp_stack_init``), on a pool
    of threads: the same weights on every device, whatever the
    threads.  ``model.init_seconds`` holds the draw's seconds."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    with torch.device(dev):
        model = BST(cfg)
    dt = getattr(torch, cfg.dtype)
    d = cfg.embed_dim
    jobs = [
        (model.item_embed, (seed, 0),
         lambda g: embed_init(g, cfg.item_vocab, d, dt)),
        (model.pos_embed, (seed, 1),
         lambda g: embed_init(g, cfg.seq_len, d, dt)),
        (model.profile_embed, (seed, 2),
         lambda g: embed_init(g, cfg.profile_vocab, d, dt)),
    ]
    for bi, block in enumerate(model.blocks):
        for li, name in enumerate(("wq", "wk", "wv", "wo", "ff1", "ff2")):
            shape = tuple(getattr(block, name).shape)
            jobs.append((getattr(block, name), (seed, 3, bi, li),
                         lambda g, s=shape: dense_init(g, *s, dt)))
    jobs.append((model.mlp, (seed, 4),
                 lambda g: mlp_stack_init(g, mlp_shape(cfg), dt)))
    vals = draw_parallel([(words, fn) for _, words, fn in jobs])
    for (leaf, _, _), val in zip(jobs, vals):
        if isinstance(leaf, nn.ParameterDict):
            for name, v in val.items():
                leaf[name].copy_(v)
        else:
            leaf.copy_(val)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    model.init_seconds = time.perf_counter() - t0
    return model
