"""The port's fanout sampler (``repro_torch.graph.sampler``) held against
``repro.graph.sampler.sample_blocks`` bit for bit, given the uniforms
that the reference's ``key, sub = jax.random.split(key)`` chain draws
(torch cannot draw ``jax.random``'s numbers, so the port takes them):
on ``rmat(8, 8)`` with seeds 0-15 and fanouts (5, 3) under several keys
(also through the reference's edge-validity check), on sentinel seeds
and isolated nodes, and at one and three hops; the generator form;
``train/data.py``'s ``GNNSampledStream`` (deterministic at a cursor,
restart-safe), ``block_batch`` and the LM and BST streams.
Integer outputs: no tolerance."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graph import generators as jgen
from repro.graph.csr import from_edges as jfrom_edges
from repro.graph.sampler import sample_blocks as jsample
from repro_torch.graph.csr import from_edges as tfrom_edges
from repro_torch.graph.sampler import sample_blocks
from repro_torch.models.gnn import gat as tgat
from repro_torch.configs import gnn as tgnn
from repro_torch.train import data as tdata

torch.set_num_threads(1)


def _graphs(edges, n):
    return jfrom_edges(edges, n), tfrom_edges(edges, n, device="cpu")


def _reference_uniforms(key, frontier0: int, fanouts):
    """The uniforms ``sample_blocks`` draws from ``key``, hop by hop."""
    out, width = [], frontier0
    for f in fanouts:
        key, sub = jax.random.split(key)
        out.append(torch.from_numpy(np.array(
            jax.random.uniform(sub, (width, f)))))
        width *= f
    return out


def _both(jg, tg, seeds, fanouts, n, key):
    want = jsample(key, jg.row_offsets, jg.dst, jg.deg, jnp.asarray(seeds),
                   fanouts, n)
    got = sample_blocks(_reference_uniforms(key, len(seeds), fanouts),
                        tg.row_offsets, tg.dst, tg.deg,
                        torch.from_numpy(seeds), fanouts, n)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def _equal(got, want):
    for name, g, w in zip(("nodes", "src", "dst", "seed_mask"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert g.tobytes() == w.tobytes(), name


@pytest.mark.parametrize("key", [0, 1, 2, 7])
def test_sample_blocks_equals_the_reference_on_rmat8(key):
    edges, n = jgen.rmat(8, 8, seed=2)
    jg, tg = _graphs(edges, n)
    seeds = np.arange(16, dtype=np.int32)
    want, got = _both(jg, tg, seeds, (5, 3), n, jax.random.key(key))
    _equal(got, want)
    nodes, src, dst, seed_mask = got
    n_sub = 16 + 16 * 5 + 16 * 5 * 3
    assert nodes.shape == (n_sub,) and src.shape == (16 * 5 + 16 * 15,)
    assert int(seed_mask.sum()) == 16
    # the reference's check: every unpadded sampled edge is a graph edge
    k = int(tg.n_edges_dir)
    real = set(zip(tg.src[:k].tolist(), tg.dst[:k].tolist()))
    checked = 0
    for s, d in zip(src, dst):
        if d < n_sub and nodes[s] < n and nodes[d] < n:
            assert (int(nodes[d]), int(nodes[s])) in real
            checked += 1
    assert checked > 0


@pytest.mark.parametrize("fanouts", [(4,), (3, 2, 2), (1, 1)])
def test_sample_blocks_equals_the_reference_with_sentinels(fanouts):
    """Isolated vertices and sentinel seeds sample the sentinel; their
    edges carry dst n_sub; the seed mask is false on sentinel seeds."""
    edges = np.array([[0, 1], [1, 2], [2, 0], [2, 3], [5, 6]])
    n = 9                                  # 4, 7 and 8 are isolated
    jg, tg = _graphs(edges, n)
    seeds = np.array([0, 4, 9, 2, 8, 12, 5], np.int32)
    want, got = _both(jg, tg, seeds, fanouts, n, jax.random.key(3))
    _equal(got, want)
    nodes, src, dst, seed_mask = got
    assert seed_mask[:7].tolist() == [True, True, False, True, True, False,
                                      True]
    assert (dst[nodes[src] >= n] == nodes.shape[0]).all()


def test_generator_form_equals_its_own_draws():
    edges, n = jgen.rmat(8, 8, seed=1)
    tg = tfrom_edges(edges, n, device="cpu")
    seeds = torch.arange(0, 64, 4, dtype=torch.int32)
    got = sample_blocks(torch.Generator().manual_seed(5), tg.row_offsets,
                        tg.dst, tg.deg, seeds, (5, 3), n)
    g = torch.Generator().manual_seed(5)
    draws = [torch.rand((16, 5), generator=g),
             torch.rand((80, 3), generator=g)]
    want = sample_blocks(draws, tg.row_offsets, tg.dst, tg.deg, seeds,
                         (5, 3), n)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="float32"):
        sample_blocks([draws[0].double(), draws[1]], tg.row_offsets,
                      tg.dst, tg.deg, seeds, (5, 3), n)
    with pytest.raises(ValueError, match="float32"):
        sample_blocks([draws[1], draws[0]], tg.row_offsets, tg.dst,
                      tg.deg, seeds, (5, 3), n)


def _stream(cursor=0, seed=4):
    edges, n = jgen.rmat(9, 8, seed=0)
    tg = tfrom_edges(edges, n, device="cpu")
    return tdata.GNNSampledStream(tg, 32, (15, 10), n, seed=seed,
                                  cursor=cursor), n


def test_sampled_stream_is_deterministic_and_restart_safe():
    s, n = _stream()
    blocks = [next(s) for _ in range(3)]
    assert s.cursor == 3
    again, _ = _stream()
    assert all(torch.equal(a, b) for a, b in zip(next(again), blocks[0]))
    resumed, _ = _stream(cursor=2)
    assert all(torch.equal(a, b) for a, b in zip(next(resumed), blocks[2]))
    assert not torch.equal(blocks[0][0], blocks[1][0])
    other, _ = _stream(seed=5)
    assert not torch.equal(next(other)[0], blocks[0][0])
    nodes, src, dst, seed_mask = blocks[0]
    assert nodes.shape == (32 * (1 + 15 + 150),)
    assert src.shape == dst.shape == (32 * 15 + 32 * 150,)
    assert bool(seed_mask[:32].all()) and not seed_mask[32:].any()
    assert int(nodes[:32].max()) < n


def test_block_batch_feeds_gat():
    s, n = _stream()
    block = next(s)
    cfg = tgnn.GAT_CORA_SMOKE
    feat = torch.randn((n, cfg.d_in), generator=torch.Generator()
                       .manual_seed(0))
    labels = torch.randint(0, cfg.n_classes, (n,), dtype=torch.int32)
    b = tdata.block_batch(block, feat, labels)
    nodes = block[0]
    assert b.n_nodes == nodes.shape[0] and b.n_edges == block[1].shape[0]
    inside = nodes < n
    assert torch.equal(b.node_feat[inside], feat[nodes[inside].long()])
    assert not b.node_feat[~inside].any()
    assert torch.equal(b.label_mask, block[3])
    model = tgat.init_params(cfg, 0, "cpu")
    loss = tgat.loss_fn(model, b)
    loss.backward()
    assert bool(torch.isfinite(loss))


@pytest.mark.parametrize("stream", ["LMStream", "BSTStream"])
def test_streams_of_unported_models_raise_naming_the_queue(stream):
    """Both streams are ported: ``LMStream`` (LM training) yields
    next-token batches, ``BSTStream`` (the recsys BST) users' histories,
    targets, profile bags and labels."""
    if stream == "LMStream":
        from repro_torch.configs import lm as tlm

        lm = tdata.LMStream(tlm.SMOLLM_135M_SMOKE, 4, 16, seed=0,
                            device="cpu")
        tok, lab = next(lm)
        assert tok.shape == lab.shape == (4, 16) and lm.cursor == 1
        assert torch.equal(tok[:, 1:], lab[:, :-1])
        return
    from repro_torch.configs import recsys as trecsys

    cfg = trecsys.BST_SMOKE
    bst = tdata.BSTStream(cfg, 4, seed=0, device="cpu")
    hist, target, pidx, pbag, labels = next(bst)
    assert hist.shape == (4, cfg.seq_len - 1) and bst.cursor == 1
    assert target.shape == labels.shape == (4,)
    assert pidx.shape == pbag.shape == (4 * cfg.profile_bag,)
