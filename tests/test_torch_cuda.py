"""Tests that need the card: the Hopper kernels K1, K2 and K3 against
their plain versions on CUDA tensors (K1 and K2 by each path: the
bitmap items, the row walk and the rule by shape; a hub target cut into
many items, targets past 65,536 entries, a span wider than the bitmap,
two ``lev_u`` on one target, empty and all-sentinel launches, each
repeated bit for bit), the count, find and per-vertex paths at RMAT
scale 16 going through them, ``ops.horizontal_edge_counts``, and stream sessions whose
delta probes go through K3 (K2 with credit); K3 by each path (the bitmap
items, the row walk, the length-balanced tiles, the rule) at the stream
probes' shapes,
on the bitmap cases, on tiles of many rows and runs of sentinel rows,
on every rmat16 bucket and on the launches of rmat16 sessions at
buffers of 4,096 and 65,536, each launched twice; the batch route
(``count_batch`` bounded and exact, with and without credit, and the
server) on the card equal to the CPU path, every K1 and K2 call of a
batch's lane view equal to its plain version, one K1 launch per bucket
for all lanes, and the robust server (admission, failed batches) and
the wedge baseline equal to the CPU; a server prewarmed from a tuned
profile loading no library after its prewarm, in a fresh process; K5 against its plain
attention, and the LM server going through it, its split decode launched
twice and equal bit for bit; K4 against its plain segment sum, bit for
bit across launches and against its chunk-then-carry order in plain
PyTorch (RMAT hubs, a segment over more than 30 chunks), a GatedGCN
training step going through it, GAT's edge softmax with its denominator
on K4, a training step of GAT, SchNet and DimeNet through K4 against the
CPU, and a sampled block on the card equal to the CPU's; K5's backward
against its plain version and bit for bit across launches, the
``grad_fn`` of K5's output on the card, an LM training step through
K5's backward against the CPU, and one MoE layer (its combine on K4)
against the CPU; BST's bag sum on K4 and a BST training step
against the CPU; the explicit expert-parallel MoE layer over
``LocalShards(4, "cuda")`` (its combine on K4) against the CPU's, and
the int8 gradient psum on the card equal to the CPU's bits.

Marked ``cuda``; run them on a machine with an NVIDIA H100 with
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
Whether a card is present is decided inside the ``cuda_device``
fixture, so every worker collects the same tests; without a card each
test skips with the reason."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.api import TCOptions, TriangleEngine
from repro_torch.core import intersect as tint
from repro_torch.core.edges import horizontal_queries
from repro_torch.graph import generators as gen
from repro_torch.graph import csr as tcsr
from repro_torch.graph.csr import from_edges
from repro_torch.configs import lm as tlm
from repro_torch.kernels.flash_attention import flash_attention as tflash
from repro_torch.kernels.flash_attention.ref import (
    attention_ref,
    attention_split_ref,
)
from repro_torch.kernels.intersect import intersect as tkern
from repro_torch.launch import serve as tserve
from repro_torch.launch import serve_tc as tserve_tc
from repro_torch.models import transformer as ttfm
from repro_torch.kernels.intersect.ref import (
    intersect_count_ref,
    intersect_hits_ref,
    intersect_levels_ref,
)
from repro_torch.configs import data as tdata
from repro_torch.configs import gnn as tgnn
from repro_torch.kernels.segsum import ops as tseg
from repro_torch.kernels.segsum import segsum as tsegk
from repro_torch.kernels.segsum.ref import (
    segment_sum_chunked_ref,
    segment_sum_ref,
)
from repro_torch.launch import steps as tsteps
from repro_torch.models.gnn import gatedgcn as tgat
from repro_torch.train import optimizer as topt

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is "
                    "False on this host")
    return torch.device("cuda")


def _random_operands(rng, q, d, n=2000):
    """``n`` sorted unique lists of up to ``d`` ids and ``q`` random
    (candidate row, target row) pairs over them, as the kernel's operands."""
    ids = max(n, 2 * d)
    lists = [np.unique(rng.integers(0, ids, size=rng.integers(0, d + 1)))
             for _ in range(n)]
    flat = np.concatenate(lists).astype(np.int32)
    starts = np.cumsum([0] + [len(x) for x in lists[:-1]]).astype(np.int32)
    lens = np.array([len(x) for x in lists], np.int32)
    u = rng.integers(0, n, size=q)
    w = rng.integers(0, n, size=q)
    level = rng.integers(0, 4, size=ids).astype(np.int32)
    return (flat, starts[u], lens[u], starts[w], lens[w], level, level[u])


# The block kernel stages a target of at most 4,096 entries in shared
# memory and searches a longer one in global memory; lists of up to
# 10,000 entries reach both branches within one launch.
@pytest.mark.parametrize("d_cand,d_targ,d_list", [
    (32, 1024, 1200),      # warp kernel
    (256, 300, 1200),      # warp kernel, clamped targets
    (1024, 1024, 1200),    # block kernel, staged targets
    (16384, 16384, 10000),  # block kernel, staged and global-memory search
    (512, 100, 1200),      # block kernel, clamped lists
])
def test_kernel_matches_plain_on_random_operands(cuda_device, d_cand,
                                                 d_targ, d_list):
    rng = np.random.default_rng(d_cand + d_targ)
    ops = [torch.from_numpy(x).to(cuda_device)
           for x in _random_operands(rng, 3000, d_list)]
    before = tkern.LAUNCHES["intersect_levels"]
    k1, k2 = tkern.intersect_levels(*ops, d_cand=d_cand, d_targ=d_targ)
    torch.cuda.synchronize()
    assert tkern.LAUNCHES["intersect_levels"] == before + 1
    r1, r2 = intersect_levels_ref(*ops, d_cand=d_cand, d_targ=d_targ)
    assert torch.equal(k1, r1) and torch.equal(k2, r2)


def test_kernel_matches_plain_on_every_bucket_of_rmat16(cuda_device):
    edges, n = gen.rmat(16, 16, seed=0)
    res = TriangleEngine(device=cuda_device).count_raw((edges, n))
    g = from_edges(edges, n, device=cuda_device)
    qu, qw, *_ = horizontal_queries(g, res.levels, order="desc")
    adj = tint.CsrAdjacency.from_graph(g)
    for b, base, qu_b, qw_b, bounds in tint.bucket_slices(adj, qu, qw,
                                                          res.plan):
        ops = tint.probe_operands(adj, qu_b, qw_b, bounds, base, b.count,
                                  res.levels)
        k = tkern.intersect_levels(adj.flat, *ops[:4], res.levels, ops[4],
                                   d_cand=b.d_cand, d_targ=b.d_targ)
        r = intersect_levels_ref(adj.flat, *ops[:4], res.levels, ops[4],
                                 d_cand=b.d_cand, d_targ=b.d_targ)
        assert torch.equal(k[0], r[0]) and torch.equal(k[1], r[1])


def test_count_rmat16_goes_through_the_kernel(cuda_device):
    edges, n = gen.rmat(16, 16, seed=0)
    before = dict(tkern.LAUNCHES)
    r = TriangleEngine(device=cuda_device).count((edges, n))
    # one K1 launch per bucket of the exact plan, and no K2 or K3
    assert tkern.LAUNCHES == {"intersect_levels":
                              before["intersect_levels"] + 3,
                              "intersect_hits": before["intersect_hits"],
                              "intersect_count": before["intersect_count"]}
    assert r.backend == "cuda" and r.plan_id == "exact/cuda"
    assert (r.triangles, r.num_horizontal) == (15673932, 528985)
    assert not r.overflow
    plain = TriangleEngine(device=cuda_device).count(
        (edges, n), options=TCOptions(backend="torch"))
    assert (plain.c1, plain.c2) == (r.c1, r.c2)


def test_wrapper_refuses_mixed_devices(cuda_device):
    ops = [torch.from_numpy(x) for x in
           _random_operands(np.random.default_rng(0), 8, 16, n=50)]
    ops[0] = ops[0].to(cuda_device)
    with pytest.raises(ValueError, match="one device"):
        tkern.intersect_levels(*ops, d_cand=16, d_targ=16)
    with pytest.raises(ValueError, match="one device"):
        tkern.intersect_hits(*ops[:5], d_cand=16, d_targ=16)


# K2 takes K1's two mappings: the same cases reach the warp kernel, the
# staged and the global-memory branch of the block kernel, and clamps.
@pytest.mark.parametrize("d_cand,d_targ,d_list", [
    (32, 1024, 1200),      # warp kernel
    (256, 300, 1200),      # warp kernel, clamped targets
    (1024, 1024, 1200),    # block kernel, staged targets
    (16384, 16384, 10000),  # block kernel, staged and global-memory search
    (512, 100, 1200),      # block kernel, clamped lists
])
def test_hits_kernel_matches_plain_on_random_operands(cuda_device, d_cand,
                                                      d_targ, d_list):
    rng = np.random.default_rng(d_cand + d_targ + 1)
    ops = [torch.from_numpy(x).to(cuda_device)
           for x in _random_operands(rng, 3000, d_list)[:5]]
    before = tkern.LAUNCHES["intersect_hits"]
    ko, kh = tkern.intersect_hits(*ops, d_cand=d_cand, d_targ=d_targ)
    torch.cuda.synchronize()
    assert tkern.LAUNCHES["intersect_hits"] == before + 1
    ro, rh = intersect_hits_ref(*ops, d_cand=d_cand, d_targ=d_targ)
    assert torch.equal(ko, ro) and torch.equal(kh, rh)
    assert kh.any() and not kh.all()


def test_hits_kernel_matches_plain_on_every_bucket_of_rmat16(cuda_device):
    edges, n = gen.rmat(16, 16, seed=0)
    res = TriangleEngine(device=cuda_device).count_raw((edges, n))
    g = from_edges(edges, n, device=cuda_device)
    qu, qw, *_ = horizontal_queries(g, res.levels, order="desc")
    adj = tint.CsrAdjacency.from_graph(g)
    for b, base, qu_b, qw_b, bounds in tint.bucket_slices(adj, qu, qw,
                                                          res.plan):
        ops = tint.probe_operands(adj, qu_b, qw_b, bounds, base, b.count,
                                  res.levels)[:4]
        k = tkern.intersect_hits(adj.flat, *ops, d_cand=b.d_cand,
                                 d_targ=b.d_targ)
        r = intersect_hits_ref(adj.flat, *ops, d_cand=b.d_cand,
                               d_targ=b.d_targ)
        assert torch.equal(k[0], r[0]) and torch.equal(k[1], r[1])


def test_find_and_per_vertex_rmat16_go_through_k2(cuda_device):
    edges, n = gen.rmat(16, 16, seed=0)
    expect = 15673932
    eng = TriangleEngine(device=cuda_device)
    before = dict(tkern.LAUNCHES)
    tri, cnt = eng.find((edges, n), max_triangles=expect)
    assert tkern.LAUNCHES["intersect_hits"] > before["intersect_hits"]
    assert tkern.LAUNCHES["intersect_levels"] == before["intersect_levels"]
    assert tri.device.type == "cuda" and int(cnt) == expect
    plain_tri, plain_cnt = eng.find((edges, n), max_triangles=expect,
                                    options=TCOptions(backend="torch"))
    assert torch.equal(tri, plain_tri) and int(plain_cnt) == expect

    before = dict(tkern.LAUNCHES)
    r = eng.count((edges, n), options=TCOptions(per_vertex=True))
    assert tkern.LAUNCHES["intersect_hits"] > before["intersect_hits"]
    assert tkern.LAUNCHES["intersect_levels"] == before["intersect_levels"]
    assert r.triangles == expect and int(r.per_vertex.sum()) == 3 * expect
    plain = eng.count((edges, n),
                      options=TCOptions(per_vertex=True, backend="torch"))
    assert (plain.c1, plain.c2) == (r.c1, r.c2)
    np.testing.assert_array_equal(plain.per_vertex, r.per_vertex)
    found = np.bincount(tri.cpu().numpy().reshape(-1), minlength=n)
    np.testing.assert_array_equal(found, r.per_vertex)


# K3 under the rule by shape (every call here has 3,000 rows, so it walks):
# short rows in tiles of several rows, long rows in tiles of one (their
# target's slice staged or searched in global memory), and clamps.
@pytest.mark.parametrize("d_cand,d_targ,d_list", [
    (32, 1024, 1200),      # warp kernel
    (256, 300, 1200),      # warp kernel, clamped targets
    (1024, 1024, 1200),    # block kernel, staged targets
    (16384, 16384, 10000),  # block kernel, staged and global-memory search
    (512, 100, 1200),      # block kernel, clamped lists
])
def test_count_kernel_matches_plain_on_random_operands(cuda_device, d_cand,
                                                       d_targ, d_list):
    rng = np.random.default_rng(d_cand + d_targ + 2)
    ops = [torch.from_numpy(x).to(cuda_device)
           for x in _random_operands(rng, 3000, d_list)]
    before = tkern.LAUNCHES["intersect_count"]
    k = tkern.intersect_count(*ops[:5], d_cand=d_cand, d_targ=d_targ)
    torch.cuda.synchronize()
    assert tkern.LAUNCHES["intersect_count"] == before + 1
    assert torch.equal(k, intersect_count_ref(*ops[:5], d_cand=d_cand,
                                              d_targ=d_targ))
    c1, c2 = tkern.intersect_levels(*ops, d_cand=d_cand, d_targ=d_targ)
    assert torch.equal(k, c1 + c2) and bool(k.any())


def test_count_kernel_matches_plain_and_k1_on_every_bucket_of_rmat16(
        cuda_device):
    edges, n = gen.rmat(16, 16, seed=0)
    res = TriangleEngine(device=cuda_device).count_raw((edges, n))
    g = from_edges(edges, n, device=cuda_device)
    qu, qw, *_ = horizontal_queries(g, res.levels, order="desc")
    adj = tint.CsrAdjacency.from_graph(g)
    for b, base, qu_b, qw_b, bounds in tint.bucket_slices(adj, qu, qw,
                                                          res.plan):
        ops = tint.probe_operands(adj, qu_b, qw_b, bounds, base, b.count,
                                  res.levels)
        kw = dict(d_cand=b.d_cand, d_targ=b.d_targ)
        k = tkern.intersect_count(adj.flat, *ops[:4], **kw)
        assert torch.equal(k, intersect_count_ref(adj.flat, *ops[:4], **kw))
        c1, c2 = tkern.intersect_levels(adj.flat, *ops[:4], res.levels,
                                        ops[4], **kw)
        assert torch.equal(k, c1 + c2)


def _bitmap_operands(rng, *, q, n_lists, cand_len, targ_len, id_hi,
                     hub_rows=0, n_level=None):
    """Sorted unique lists over ids ``[0, id_hi)`` as the kernels'
    operands: ``n_lists`` candidate lists of up to ``cand_len`` ids (one
    led by negative ids), ``n_lists`` target lists of up to ``targ_len``
    ids and one hub target of ``targ_len``; ``q`` random (candidate,
    target) rows, the first ``hub_rows`` of them against the hub.  The
    level array covers ``n_level`` ids (default ``id_hi // 2``), so a
    found id above it reads the pad -7."""
    lists = [np.unique(rng.integers(0, id_hi, size=rng.integers(1, cand_len)))
             for _ in range(n_lists)]
    lists[0] = np.r_[-5, -1, lists[0]]
    lists += [np.unique(rng.integers(0, id_hi, size=rng.integers(1, targ_len)))
              for _ in range(n_lists)]
    lists.append(np.unique(rng.integers(0, id_hi, size=targ_len)))
    flat = np.concatenate(lists).astype(np.int32)
    starts = np.cumsum([0] + [len(x) for x in lists[:-1]]).astype(np.int32)
    lens = np.array([len(x) for x in lists], np.int32)
    u = rng.integers(0, n_lists, size=q)
    w = rng.integers(n_lists, 2 * n_lists, size=q)
    w[:hub_rows] = 2 * n_lists
    n_level = id_hi // 2 if n_level is None else n_level
    level = rng.integers(0, 3, size=n_level).astype(np.int32)
    lev_u = rng.integers(0, 3, size=q).astype(np.int32)
    lev_u[:hub_rows] = 1  # the count's rows: one lev_u per target
    return (flat, starts[u], lens[u], starts[w], lens[w], level, lev_u)


# (q, n_lists, cand_len, targ_len, id_hi, hub_rows, d_cand, d_targ)
BITMAP_CASES = {
    # one hub target shared by 3,000 rows: many item cuts (cells, rows)
    "hub": (3000, 40, 2000, 5000, 20000, 3000, 2048, 5000),
    # targets past the old 4,096-entry stage and past 65,536 entries
    "long_targets": (600, 30, 3000, 80000, 1_000_000, 200, 4096, 80000),
    # a span wider than one window of the bitmap: ids up to ~4 M
    "wide_span": (800, 30, 3000, 20000, 4_000_000, 300, 4096, 20000),
    # clamped widths, narrow rows (the walk kernel is a warp per row)
    "clamped": (4000, 200, 300, 3000, 50000, 500, 64, 1000),
}


@pytest.mark.parametrize("path", ["auto", "bitmap", "walk"])
@pytest.mark.parametrize("case", sorted(BITMAP_CASES))
def test_k1_k2_paths_match_plain(cuda_device, case, path):
    """K1 and K2 through the bitmap items, the row walk or the rule by
    shape equal their plain versions on the same operands, and each
    repeats bit for bit."""
    q, n_lists, cl, tl, id_hi, hub, d_cand, d_targ = BITMAP_CASES[case]
    rng = np.random.default_rng(len(case))
    ops = [torch.from_numpy(x).to(cuda_device) for x in _bitmap_operands(
        rng, q=q, n_lists=n_lists, cand_len=cl, targ_len=tl, id_hi=id_hi,
        hub_rows=hub)]
    kw = dict(d_cand=d_cand, d_targ=d_targ)
    lay = tkern.item_layout(*ops[1:5], path=path, **kw)
    on_bitmap = path == "bitmap" or (
        path == "auto" and d_cand > tkern.WALK_MAX_CAND
        and q >= tkern.BITMAP_MIN_ROWS)
    assert (lay is not None) == on_bitmap
    if lay is not None:
        assert int(lay.item_start[int(lay.n_items[0])]) == q  # all live
    r1, r2 = intersect_levels_ref(*ops, **kw)
    ro, rh = intersect_hits_ref(*ops[:5], **kw)
    assert int(r1.sum()) > 0 and int(r2.sum()) > 0
    before = dict(tkern.LAUNCHES)
    for _ in range(2):
        k1, k2 = tkern.intersect_levels(*ops, path=path, **kw)
        ko, kh = tkern.intersect_hits(*ops[:5], path=path, **kw)
        torch.cuda.synchronize()
        assert torch.equal(k1, r1) and torch.equal(k2, r2)
        assert torch.equal(ko, ro) and torch.equal(kh, rh)
    assert tkern.LAUNCHES["intersect_levels"] == before[
        "intersect_levels"] + 2
    assert tkern.LAUNCHES["intersect_hits"] == before["intersect_hits"] + 2


@pytest.mark.parametrize("path", ["bitmap", "walk"])
def test_k1_level_split_with_two_lev_u_per_target(cuda_device, path):
    """K1's level split when the rows of one target carry two ``lev_u``
    (the contract allows any): the plain version's counts on either
    path."""
    rng = np.random.default_rng(7)
    ops = [torch.from_numpy(x).to(cuda_device) for x in _bitmap_operands(
        rng, q=2000, n_lists=20, cand_len=1500, targ_len=3000, id_hi=30000,
        hub_rows=1500)]
    ops[6][:700] = 2  # the hub's rows with two lev_u
    kw = dict(d_cand=2048, d_targ=3000)
    k1, k2 = tkern.intersect_levels(*ops, path=path, **kw)
    r1, r2 = intersect_levels_ref(*ops, **kw)
    assert torch.equal(k1, r1) and torch.equal(k2, r2)


@pytest.mark.parametrize("q", [0, 5000])
def test_k1_k2_empty_and_all_sentinel_launches(cuda_device, q):
    """No rows, or rows that are all sentinels (l_s = l_l = 0): zeros
    and an empty mask, one launch each."""
    z = torch.zeros(q, dtype=torch.int32, device=cuda_device)
    flat = torch.arange(10, dtype=torch.int32, device=cuda_device)
    level = torch.zeros(10, dtype=torch.int32, device=cuda_device)
    for path in ("auto", "bitmap"):
        c1, c2 = tkern.intersect_levels(flat, z, z, z, z, level, z,
                                        d_cand=64, d_targ=64, path=path)
        off, hits = tkern.intersect_hits(flat, z, z, z, z, d_cand=64,
                                         d_targ=64, path=path)
        torch.cuda.synchronize()
        assert c1.shape == c2.shape == (q,) and not c1.any() and not c2.any()
        assert hits.numel() == 0 and off.shape == (q + 1,) and not off.any()


def test_ops_horizontal_edge_counts_on_the_card(cuda_device):
    """``kernels/intersect/ops.py`` on a CUDA graph goes through K1 and
    equals its CPU path (the dense plain version) edge for edge."""
    from repro_torch.core.bfs import bfs_levels
    from repro_torch.core.edges import horizontal_mask
    from repro_torch.graph.csr import max_degree, undirected_edges
    from repro_torch.kernels.intersect.ops import horizontal_edge_counts

    edges, n = gen.rmat(10, 16, seed=0)
    got = []
    for dev in (cuda_device, torch.device("cpu")):
        g = from_edges(edges, n, device=dev)
        level = bfs_levels(g.src, g.dst, n, row_offsets=g.row_offsets)
        eu, ew, und = undirected_edges(g)
        use = und & horizontal_mask(g.src, g.dst, level, n)
        before = tkern.LAUNCHES["intersect_levels"]
        got.append([x.cpu() for x in horizontal_edge_counts(
            g, torch.where(use, eu, n), torch.where(use, ew, n), level,
            d_max=max_degree(g))])
        assert tkern.LAUNCHES["intersect_levels"] == before + (
            dev.type == "cuda")
    assert all(torch.equal(a, b) for a, b in zip(*got))
    assert int(got[0][0].sum() + got[0][1].sum() // 3) == 75682


def test_from_edges_takes_a_cuda_tensor(cuda_device):
    edges, n = gen.rmat(10, 16, seed=0)
    e = torch.from_numpy(edges).to(cuda_device)
    g = from_edges(e, n, num_slots=1 << 15, device=cuda_device)
    ref = from_edges(edges, n, num_slots=1 << 15, device="cpu")
    for name in ("src", "dst", "row_offsets", "deg", "n_edges_dir"):
        assert torch.equal(getattr(g, name).cpu(), getattr(ref, name))


@pytest.mark.parametrize("per_vertex", [False, True], ids=["count", "pv"])
def test_stream_session_goes_through_k3_and_matches_the_cpu(cuda_device,
                                                            per_vertex):
    """rmat12 sessions on the card and on the CPU, the same stream: equal
    updates and arrays after every apply; between refreshes the probes
    launch K3 alone without credit and K2 alone with it."""
    edges, n = gen.rmat(12, 16, seed=0)
    opts = TCOptions(per_vertex=per_vertex, stream_staleness=1e9)
    gpu = TriangleEngine(opts).stream((edges, n))
    cpu = TriangleEngine(opts, device="cpu").stream((edges, n))
    assert gpu.state.keys.device.type == "cuda"
    rng = np.random.default_rng(1)
    want = "intersect_hits" if per_vertex else "intersect_count"
    for _ in range(3):
        cur = cpu.state.edges()
        dels = cur[rng.choice(cur.shape[0], 300, replace=False)]
        ins = rng.integers(0, n, size=(300, 2))
        ops = np.r_[-np.ones(300, np.int8), np.ones(300, np.int8)]
        batch = (ops, np.r_[dels, ins])
        before = dict(tkern.LAUNCHES)
        up = gpu.apply(batch)
        got = {k: tkern.LAUNCHES[k] - before[k] for k in before}
        assert got[want] > 0 and sum(got.values()) == got[want], got
        assert up == cpu.apply(batch)
        assert gpu.triangles == cpu.triangles
        if per_vertex:
            np.testing.assert_array_equal(gpu.per_vertex, cpu.per_vertex)
    fresh = TriangleEngine().count((gpu.state.edges(), n),
                                   options=TCOptions(per_vertex=per_vertex))
    assert fresh.triangles == gpu.triangles
    if per_vertex:
        np.testing.assert_array_equal(fresh.per_vertex, gpu.per_vertex)
    before = dict(tkern.LAUNCHES)
    gpu.apply([], refresh=True)
    got = {k: tkern.LAUNCHES[k] - before[k] for k in before}
    assert got["intersect_count"] == 0
    assert gpu.count().c1 == fresh.c1 and gpu.count().k == fresh.k


def _k3_paths_match(ops, kw, paths=tkern.COUNT_PATHS):
    """K3 by each path equal to its plain version on every row, launched
    twice (the same bits), one count a launch."""
    want = intersect_count_ref(*ops[:5], **kw)
    for path in paths:
        before = tkern.LAUNCHES["intersect_count"]
        first = tkern.intersect_count(*ops[:5], path=path, **kw)
        again = tkern.intersect_count(*ops[:5], path=path, **kw)
        torch.cuda.synchronize()
        assert tkern.LAUNCHES["intersect_count"] == before + 2
        assert torch.equal(first, want), path
        assert torch.equal(again, first), path
    return want


def _probe_like_operands(rng, *, q, live, d_cand, n_ids, hub_len,
                         hub_rows):
    """A delta probe's operands at its own shape: ``live`` rows of
    heavy-tailed candidate lists (median ~140, a few of ``d_cand`` and
    one of 16,384 when d_cand allows) against targets of up to
    ``hub_len`` entries, ``hub_rows`` of them one shared hub target,
    negative ids in one list; the other rows sentinels (l_s = l_l = 0)
    spread among them."""
    lens = np.minimum(rng.lognormal(np.log(140), 1.3, size=2 * live)
                      .astype(np.int64) + 1, d_cand)
    lens[0] = min(d_cand, 16384)
    lists = [np.unique(rng.integers(0, n_ids, size=int(x))) for x in lens]
    lists[1] = np.r_[-3, -1, lists[1]]
    lists.append(np.unique(rng.integers(0, n_ids, size=hub_len)))
    flat = np.concatenate(lists).astype(np.int32)
    starts = np.cumsum([0] + [len(x) for x in lists[:-1]]).astype(np.int32)
    sizes = np.array([len(x) for x in lists], np.int32)
    u = rng.integers(0, live, size=q)
    w = rng.integers(live, 2 * live, size=q)
    u[0] = 0
    w[:hub_rows] = 2 * live
    ls, ll = sizes[u], sizes[w]
    dead = rng.permutation(q)[:q - live]
    ls[dead] = 0
    ll[dead] = 0
    return (flat, starts[u], ls, starts[w], ll)


# (q, live, d_cand, n_ids, hub_len, hub_rows, d_targ): the stream's probe
# shapes at RMAT scale 20, synthetic
K3_PROBES = {
    "delete_probe": (2048, 2048, 16384, 1_048_576, 64807, 300, 65536),
    "insert_probe": (2048, 789, 1024, 1_048_576, 64807, 20, 65536),
    "large_probe": (32768, 32768, 16384, 1_048_576, 64807, 3000, 65536),
}


@pytest.mark.parametrize("case", sorted(K3_PROBES))
def test_k3_paths_match_plain_at_the_stream_probe_shapes(cuda_device, case):
    """K3 by the rule and by each path on operands of the stream
    probes' shapes: every row equal to the plain version, bit for bit
    across launches."""
    q, live, d_cand, n_ids, hub_len, hub_rows, d_targ = K3_PROBES[case]
    ops = [torch.from_numpy(x).to(cuda_device) for x in _probe_like_operands(
        np.random.default_rng(q + live), q=q, live=live, d_cand=d_cand,
        n_ids=n_ids, hub_len=hub_len, hub_rows=hub_rows)]
    want = _k3_paths_match(ops, dict(d_cand=d_cand, d_targ=d_targ))
    assert int(want.sum()) > 0


@pytest.mark.parametrize("case", sorted(BITMAP_CASES))
def test_k3_paths_match_plain(cuda_device, case):
    """K3 by each path where K1 and K2 are held: a hub target cut across
    items, targets past 4,096 and 65,536 entries, a span wider than the
    bitmap (~4 M ids), clamped narrow rows."""
    q, n_lists, cl, tl, id_hi, hub, d_cand, d_targ = BITMAP_CASES[case]
    ops = [torch.from_numpy(x).to(cuda_device) for x in _bitmap_operands(
        np.random.default_rng(len(case) + 1), q=q, n_lists=n_lists,
        cand_len=cl, targ_len=tl, id_hi=id_hi, hub_rows=hub)]
    kw = dict(d_cand=d_cand, d_targ=d_targ)
    want = _k3_paths_match(ops, kw)
    c1, c2 = intersect_levels_ref(*ops, **kw)
    assert torch.equal(want, c1 + c2) and int(want.sum()) > 0


def test_k3_walk_over_tiles_of_many_rows_and_dead_runs(cuda_device):
    """Rows of 1-7 cells (a tile spans more than one window of 32 rows),
    long runs of sentinel rows between live ones, and a long row whose
    tiles hold dense candidates (a staged slice) beside sparse ones (a
    slice searched in global memory)."""
    rng = np.random.default_rng(21)
    lists = [np.unique(rng.integers(0, 5000, size=rng.integers(1, 8)))
             for _ in range(400)]
    lists.append(np.arange(0, 40000, 2))        # dense against the hub
    lists.append(np.unique(rng.integers(0, 10**6, size=3000)))  # sparse
    lists.append(np.arange(0, 40000, 3))        # the hub target
    flat = np.concatenate(lists).astype(np.int32)
    starts = np.cumsum([0] + [len(x) for x in lists[:-1]]).astype(np.int32)
    sizes = np.array([len(x) for x in lists], np.int32)
    q = 6000
    u = rng.integers(0, 400, size=q)
    u[100], u[3000] = 400, 401
    w = np.full(q, 402)
    ls, ll = sizes[u], sizes[w]
    ls[500:2500] = 0  # a run of 2,000 sentinel rows
    ll[500:2500] = 0
    ops = [torch.from_numpy(x).to(cuda_device)
           for x in (flat, starts[u], ls, starts[w], ll)]
    want = _k3_paths_match(ops, dict(d_cand=20000, d_targ=20000),
                           paths=("tiles",))
    assert int(want[100]) > 0 and int(want.sum()) > int(want[100])


@pytest.mark.parametrize("q", [0, 5000])
def test_k3_empty_and_all_sentinel_launches(cuda_device, q):
    """No rows, or rows that are all sentinels: zeros on every path, one
    launch each where there are rows."""
    z = torch.zeros(q, dtype=torch.int32, device=cuda_device)
    flat = torch.arange(10, dtype=torch.int32, device=cuda_device)
    for path in tkern.COUNT_PATHS:
        before = tkern.LAUNCHES["intersect_count"]
        k = tkern.intersect_count(flat, z, z, z, z, d_cand=1024, d_targ=64,
                                  path=path)
        torch.cuda.synchronize()
        assert k.shape == (q,) and not k.any()
        assert tkern.LAUNCHES["intersect_count"] == before + (q > 0)


def test_k3_paths_match_plain_on_every_bucket_of_rmat16(cuda_device):
    """The count's plan run level-free: every bucket by each path equal
    to the plain version and to K1's c1 + c2."""
    edges, n = gen.rmat(16, 16, seed=0)
    res = TriangleEngine(device=cuda_device).count_raw((edges, n))
    g = from_edges(edges, n, device=cuda_device)
    qu, qw, *_ = horizontal_queries(g, res.levels, order="desc")
    adj = tint.CsrAdjacency.from_graph(g)
    for b, base, qu_b, qw_b, bounds in tint.bucket_slices(adj, qu, qw,
                                                          res.plan):
        ops = tint.probe_operands(adj, qu_b, qw_b, bounds, base, b.count,
                                  res.levels)
        kw = dict(d_cand=b.d_cand, d_targ=b.d_targ)
        want = _k3_paths_match((adj.flat, *ops[:4]), kw)
        c1, c2 = tkern.intersect_levels(adj.flat, *ops[:4], res.levels,
                                        ops[4], **kw)
        assert torch.equal(want, c1 + c2)


def _captured_counts(run):
    """``run()`` with the probe engine's K3 calls recorded: ``[(flat,
    s_s, l_s, s_l, l_l), kw]`` each, in launch order."""
    real, calls = tint.intersect_count, []

    def record(flat, s_s, l_s, s_l, l_l, *, d_cand, d_targ):
        calls.append(((flat, s_s, l_s, s_l, l_l),
                      dict(d_cand=d_cand, d_targ=d_targ)))
        return real(flat, s_s, l_s, s_l, l_l, d_cand=d_cand, d_targ=d_targ)

    tint.intersect_count = record
    try:
        run()
    finally:
        tint.intersect_count = real
    return calls


@pytest.mark.parametrize("buffer", [4096, 65536])
def test_stream_session_at_both_buffers_goes_through_k3(cuda_device,
                                                        buffer):
    """rmat16 sessions at the default buffer and at 65,536 updates an
    internal batch: every apply launches K3 alone, the totals equal a
    fresh count, and each captured launch equals the plain version on
    every row by each path."""
    edges, n = gen.rmat(16, 16, seed=0)
    opts = TCOptions(stream_buffer=buffer, stream_staleness=1e9)
    eng = TriangleEngine(device=cuda_device)
    sess = eng.stream((edges, n), options=opts)
    rng = np.random.default_rng(buffer)
    calls = []
    for _ in range(2):
        cur = sess.state.edges()
        k = buffer // 2
        dels = cur[rng.choice(cur.shape[0], k, replace=False)]
        ins = rng.integers(0, n, size=(k, 2))
        ops = np.r_[-np.ones(k, np.int8), np.ones(k, np.int8)]
        before = dict(tkern.LAUNCHES)
        calls += _captured_counts(
            lambda: sess.apply((ops, np.r_[dels, ins])))
        got = {name: tkern.LAUNCHES[name] - before[name] for name in before}
        assert got["intersect_count"] > 0
        assert sum(got.values()) == got["intersect_count"], got
    fresh = eng.count((sess.state.edges(), n))
    assert fresh.triangles == sess.triangles
    rows = max(len(c[0][1]) for c in calls)
    assert rows >= buffer // 2
    for ops, kw in calls:
        _k3_paths_match(ops, kw)


# ------------------------------------------------------------------- K5

# (b, hq, hkv, s, t, d, causal, window, kv_offset): the reference's sweep
# (tests/test_kernel_flash_attention.py) and every head width K5 is built
# for at the models' shapes
FLASH_CASES = [
    (2, 4, 2, 256, 256, 64, True, None, 0),
    (1, 4, 1, 200, 200, 64, True, 96, 0),
    (1, 2, 2, 128, 384, 32, True, None, 256),
    (1, 8, 8, 130, 130, 64, False, None, 0),
    (1, 1, 1, 1, 512, 128, True, None, 511),
    (1, 3, 3, 64, 64, 128, True, 17, 0),
    (2, 9, 3, 40, 64, 64, True, None, 0),      # smollm prefill over a cache
    (4, 9, 3, 1, 48, 64, True, None, 37),      # smollm decode
    (1, 4, 1, 300, 300, 256, True, 128, 0),    # gemma3 local layer
    (2, 2, 1, 1, 70, 48, True, 16, 69),        # gemma3-1b smoke decode
    (2, 3, 1, 33, 33, 32, True, None, 0),      # smollm smoke
    (2, 4, 4, 64, 64, 16, True, None, 0),      # qwen2-moe smoke
    (2, 4, 2, 1, 40, 16, True, None, 39),      # phi3.5-moe smoke decode
]


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_attention_matches_plain(cuda_device, case, dtype):
    b, hq, hkv, s, t, d, causal, window, kv_offset = case
    g = torch.Generator(device=cuda_device).manual_seed(s * 7 + t)
    q, k, v = (torch.randn(shape, generator=g, device=cuda_device).to(dtype)
               for shape in ((b, hq, s, d), (b, hkv, t, d), (b, hkv, t, d)))
    kw = dict(causal=causal, window=window, kv_offset=kv_offset)
    before = tflash.LAUNCHES["flash_attention"]
    got = tflash.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert tflash.LAUNCHES["flash_attention"] == before + 1
    want = attention_ref(q, k, v, **kw)
    assert got.dtype == dtype and got.shape == want.shape
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_flash_attention_reads_strided_views(cuda_device):
    """[B, H, S, D] views of [B, S, H, D] tensors, as the transformer
    passes its q and KV cache, give the contiguous operands' result."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q = torch.randn((2, 17, 9, 64), generator=g, device=cuda_device)
    k, v = (torch.randn((2, 40, 3, 64), generator=g, device=cuda_device)
            for _ in range(2))
    views = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    got = tflash.flash_attention(*views, kv_offset=5)
    want = tflash.flash_attention(*(x.contiguous() for x in views),
                                  kv_offset=5)
    assert torch.equal(got, want)


def test_flash_attention_refuses_unsupported_width(cuda_device):
    q = torch.zeros((1, 2, 4, 96), device=cuda_device)
    before = tflash.LAUNCHES["flash_attention"]
    with pytest.raises(ValueError, match="head widths"):
        tflash.flash_attention(q, q, q)
    assert tflash.LAUNCHES["flash_attention"] == before


@pytest.mark.parametrize("cfg", [tlm.SMOLLM_135M_SMOKE, tlm.GEMMA3_1B_SMOKE],
                         ids=lambda c: c.name)
def test_serve_goes_through_k5_and_matches_the_cpu(cuda_device, cfg):
    gpu = ttfm.init_params(cfg, seed=0, device=cuda_device)
    cpu = ttfm.init_params(cfg, seed=0, device="cpu")
    tokens = tserve.prompt_tokens(cfg, 3, 24, "cpu")
    want = tserve.serve(cpu, tokens, 6)
    before = tflash.LAUNCHES["flash_attention"]
    got = tserve.serve(gpu, tokens.to(cuda_device), 6, forced=want.ids)
    assert tflash.LAUNCHES["flash_attention"] - before == 6 * cfg.n_layers
    torch.testing.assert_close(got.logits.cpu(), want.logits, rtol=1e-4,
                               atol=1e-4)


# K5's backward: (b, hq, hkv, s, d, causal, window, dtype), S = T
BWD_CASES = [
    (2, 9, 3, 300, 64, True, None, torch.float32),
    (1, 4, 1, 257, 256, True, 40, torch.float32),
    (2, 6, 2, 130, 48, True, 17, torch.float32),
    (1, 2, 2, 96, 32, False, None, torch.float32),
    (1, 4, 4, 200, 128, False, 33, torch.float32),
    (2, 4, 2, 70, 16, True, 24, torch.float32),
    (2, 9, 3, 300, 64, True, None, torch.bfloat16),
    # the bf16 twins of the float32 cases, on the tensor cores' tiling
    (1, 4, 1, 257, 256, True, 40, torch.bfloat16),
    (2, 6, 2, 130, 48, True, 17, torch.bfloat16),
    (1, 2, 2, 96, 32, False, None, torch.bfloat16),
    (1, 4, 4, 200, 128, False, 33, torch.bfloat16),
    (2, 4, 2, 70, 16, True, 24, torch.bfloat16),
]


@pytest.mark.parametrize("case", BWD_CASES, ids=lambda c: "x".join(
    str(x) for x in c[:5]) + f"-{c[5]}-{c[6]}-{str(c[7])[6:]}")
def test_flash_attention_bwd_matches_plain_and_repeats_bit_for_bit(
        cuda_device, case):
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref

    b, hq, hkv, s, d, causal, window, dt = case
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g, device=cuda_device).to(dt)
               for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d)))
    kw = dict(causal=causal, window=window)
    o, lse = tflash.flash_attention_fwd(q, k, v, with_lse=True, **kw)
    _, want_lse = attention_ref(q, k, v, return_lse=True, **kw)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=2e-5)
    assert torch.equal(o, tflash.flash_attention(q, k, v, **kw))
    do = torch.randn(o.shape, generator=g, device=cuda_device).to(dt)
    before = tflash.LAUNCHES["flash_attention_bwd"]
    got = tflash.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    again = tflash.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    assert tflash.LAUNCHES["flash_attention_bwd"] - before == 2
    want = attention_bwd_ref(q, k, v, o, do, lse, **kw)
    tol = 1e-4 if dt == torch.float32 else 2e-2
    for x, y, z in zip(got, again, want):
        assert x.dtype == dt and x.shape == z.shape
        assert torch.equal(x, y)
        diff = (x.float() - z.float()).abs()
        assert bool((diff <= tol * (1 + z.float().abs())).all()), \
            float(diff.max())


def test_flash_attention_output_has_grad_fn_on_the_card(cuda_device):
    q, k, v = (torch.randn((1, 4, 64, 64), device=cuda_device)
               for _ in range(3))
    q.requires_grad_()
    before = dict(tflash.LAUNCHES)
    out = tflash.flash_attention(q, k, v)
    assert out.grad_fn is not None
    out.sum().backward()
    assert q.grad is not None and q.grad.shape == q.shape
    assert tflash.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    assert tflash.LAUNCHES["flash_attention_bwd"] == before[
        "flash_attention_bwd"] + 1
    with torch.no_grad():
        assert tflash.flash_attention(q, k, v).grad_fn is None
    with pytest.raises(ValueError, match="S = T and kv_offset 0"):
        tflash.flash_attention(q, k, v, kv_offset=3)


@pytest.mark.parametrize("cfg", [tlm.SMOLLM_135M_SMOKE, tlm.GEMMA3_1B_SMOKE,
                                 tlm.QWEN2_MOE_SMOKE],
                         ids=lambda c: c.name)
def test_lm_train_step_goes_through_k5_bwd_and_matches_the_cpu(cuda_device,
                                                              cfg):
    tok, lab = tdata.lm_batch(cfg, 2, 64, 0, device="cpu")
    grads, losses = {}, {}
    for dev in ("cpu", cuda_device):
        model = ttfm.init_params(cfg, seed=0, device=dev)
        before = dict(tflash.LAUNCHES)
        loss = ttfm.loss_fn(model, tok.to(dev), lab.to(dev))
        loss.backward()
        launched = {k: tflash.LAUNCHES[k] - before[k] for k in before}
        want = ({"flash_attention": 0, "flash_attention_bwd": 0}
                if dev == "cpu" else
                {"flash_attention": 2 * cfg.n_layers,
                 "flash_attention_bwd": cfg.n_layers})
        assert launched == want
        losses[str(dev)] = float(loss)
        grads[str(dev)] = {n: p.grad.cpu() for n, p in
                           model.named_parameters()}
    assert abs(losses["cpu"] - losses["cuda"]) <= 1e-4 * (1 + losses["cpu"])
    for name, want in grads["cpu"].items():
        torch.testing.assert_close(grads["cuda"][name], want, rtol=1e-4,
                                   atol=1e-4, msg=name)


def test_moe_layer_on_the_card_matches_the_cpu(cuda_device):
    from repro_torch.models import moe as tmoe

    cfg = tlm.QWEN2_MOE_A2_7B.moe
    d = tlm.QWEN2_MOE_A2_7B.d_model
    g = torch.Generator().manual_seed(0)
    layer = tmoe.MoE(cfg, d)
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.02)
    x = torch.randn((4, 32, d), generator=g)
    want, want_aux = tmoe.moe_ffn(layer.leaves(), cfg, x)
    layer = layer.to(cuda_device)
    before = tsegk.LAUNCHES["segment_sum"]
    got, aux = tmoe.moe_ffn(layer.leaves(), cfg, x.to(cuda_device))
    assert tsegk.LAUNCHES["segment_sum"] - before == 1
    torch.testing.assert_close(got.cpu(), want.detach(), rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(aux.cpu(), want_aux, rtol=1e-5, atol=1e-6)
    n, cap = 4 * 32, tmoe.capacity_for(cfg, 4 * 32)
    r = tmoe.route(layer.router, cfg, x.to(cuda_device).reshape(n, d), cap)
    rc = tmoe.route(layer.router.cpu(), cfg, x.reshape(n, d), cap)
    for f in ("expert_idx", "se", "stok", "pos", "keep"):
        assert torch.equal(getattr(r, f).cpu(), getattr(rc, f)), f


# K5 decode at the models' shapes: (b, hq, hkv, t, d, window, kv_offset)
DECODE_CASES = [
    (8, 9, 3, 2048, 64, None, 2046),    # smollm-135m, the long serve's end
    (8, 9, 3, 2048, 64, None, 1920),    # its first decode step
    (2, 4, 1, 2048, 256, 512, 2000),    # gemma3-1b, a local layer
    (2, 4, 1, 2048, 256, None, 2047),   # gemma3-1b, a global layer
]


@pytest.mark.parametrize("case", DECODE_CASES,
                         ids=lambda c: f"t{c[3]}-d{c[4]}-w{c[5]}-at{c[6]}")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_decode_splits_repeat_bit_for_bit(cuda_device, case, dtype):
    b, hq, hkv, t, d, window, off = case
    g = torch.Generator(device=cuda_device).manual_seed(t + d + off)
    q, k, v = (torch.randn(shape, generator=g, device=cuda_device).to(dtype)
               for shape in ((b, hq, 1, d), (b, hkv, t, d), (b, hkv, t, d)))
    kw = dict(causal=True, window=window, kv_offset=off)
    splits = tflash.decode_splits(t, off, causal=True, window=window,
                                  units=b * hkv, d=d)
    assert splits[2] > 1
    before = tflash.LAUNCHES["flash_attention"]
    got = tflash.flash_attention(q, k, v, **kw)
    again = tflash.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert tflash.LAUNCHES["flash_attention"] == before + 2
    assert torch.equal(got, again)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    for want in (attention_ref(q, k, v, **kw),
                 attention_split_ref(q, k, v, splits=splits, **kw)):
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


def test_init_cache_is_on_the_card(cuda_device):
    k, v = ttfm.init_cache(tlm.SMOLLM_135M_SMOKE, 2, 16)
    assert k.device.type == v.device.type == "cuda"


# K4: (E, N, F, dtype, id range) — the reference's sweep, GatedGCN's
# F = 70 at both smoke runs' sizes, bf16, negative and sentinel ids
SEGSUM_CASES = [
    (1000, 300, 64, torch.float32, (-1, 300)),
    (64, 5, 8, torch.float32, (-1, 5)),
    (4096, 700, 128, torch.float32, (-1, 700)),
    (513, 129, 32, torch.float32, (-1, 129)),
    (2048, 64, 256, torch.float32, (-1, 64)),
    (3000, 100, 300, torch.float32, (-3, 110)),
    (21112, 2708, 70, torch.float32, (0, 2709)),
    (168960, 169984, 70, torch.float32, (0, 169985)),
    (5000, 257, 70, torch.bfloat16, (-1, 258)),
]


@pytest.mark.parametrize("case", SEGSUM_CASES,
                         ids=lambda c: f"{c[0]}x{c[2]}-{c[3]}".replace(
                             "torch.", ""))
def test_segsum_kernel_matches_plain_and_repeats_bit_for_bit(cuda_device,
                                                             case):
    e, n, f, dtype, (lo, hi) = case
    g = torch.Generator(device=cuda_device).manual_seed(e + f)
    seg = torch.randint(lo, hi, (e,), generator=g, device=cuda_device,
                        dtype=torch.int32)
    msgs = torch.randn((e, f), generator=g, device=cuda_device).to(dtype)
    lay = tseg.build_layout(seg, n)
    before = tsegk.LAUNCHES["segment_sum"]
    got = tseg.segment_sum(msgs, seg, n, layout=lay)
    again = tseg.segment_sum(msgs, seg, n, layout=lay)
    torch.cuda.synchronize()
    assert tsegk.LAUNCHES["segment_sum"] == before + 2
    assert got.dtype == torch.float32 and got.shape == (n, f)
    assert torch.equal(got, again)
    want = segment_sum_ref(msgs, seg, n)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _k4_scaled_err(got, msgs, seg, n):
    """K4's error against its plain version summed in float64 (the
    float32 one adds with atomics in a run-dependent order), over 1 + S."""
    m = msgs.double()
    diff = (got.double() - segment_sum_ref(m, seg, n)).abs()
    return float((diff / (1 + segment_sum_ref(m.abs(), seg, n))).max())


@pytest.mark.parametrize("ids", ["rmat", "one-segment"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_segsum_kernel_balances_hubs(cuda_device, ids, dtype):
    """RMAT destinations (a hub of 2,779 edges) and one segment that owns
    2,000 edges (63 chunks): within 1e-5 (1 + S) of the plain version, the
    same bits twice, and the bits of its order in plain PyTorch."""
    if ids == "rmat":
        edges, n = gen.rmat(14, 8, seed=0)
        seg = torch.from_numpy(edges[:, 1].astype(np.int32)).to(cuda_device)
    else:
        n = 50
        seg = torch.full((2000,), 17, dtype=torch.int32, device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(7)
    msgs = torch.randn((seg.shape[0], 70), generator=g,
                       device=cuda_device).to(dtype)
    lay = tseg.build_layout(seg, n)
    counts = (lay.offsets[1:] - lay.offsets[:-1]).max().item()
    assert counts > 30 * tsegk.CHUNK
    got = tsegk.segment_sum_cuda(msgs, lay)
    again = tsegk.segment_sum_cuda(msgs, lay)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(got, segment_sum_chunked_ref(msgs, lay))
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert _k4_scaled_err(got, msgs, seg, n) <= tol


def test_segsum_kernel_reads_strided_rows(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    wide = torch.randn((900, 140), generator=g, device=cuda_device)
    seg = torch.randint(-1, 60, (900,), generator=g, device=cuda_device)
    for msgs in (wide[:, ::2], wide[:, 3:73], wide.t()[:70].t()):
        torch.testing.assert_close(tseg.segment_sum(msgs, seg, 60),
                                   segment_sum_ref(msgs, seg, 60),
                                   rtol=1e-5, atol=1e-5)


def test_gatedgcn_train_step_goes_through_k4_and_matches_the_cpu(
        cuda_device):
    cfg = tgnn.GATEDGCN_SMOKE
    batch = tdata.gnn_batch("gatedgcn", cfg, n_nodes=300, n_edges_und=1200,
                            d_feat=cfg.d_in, device="cpu")
    losses = {}
    for dev in ("cpu", cuda_device):
        model = tgat.init_params(cfg, 0, dev)
        step = tsteps.gnn_train_step("gatedgcn", cfg, topt.OptConfig())
        state = topt.opt_init(topt.OptConfig(),
                              dict(model.named_parameters()))
        before = tsegk.LAUNCHES["segment_sum"]
        state, metrics = step(model, state, batch.to(dev))
        losses[str(dev)] = float(metrics["loss"])
        launched = tsegk.LAUNCHES["segment_sum"] - before
        assert launched == (0 if dev == "cpu" else 2 * cfg.n_layers)
    assert abs(losses["cpu"] - losses["cuda"]) <= 1e-4 * (1 + losses["cpu"])


def test_segment_softmax_denominator_goes_through_k4(cuda_device):
    """GAT's edge softmax over an RMAT hub at H = 8 with its denominator
    on K4: one launch a call, equal bits across launches, within 1e-5 of
    the plain version summed in float64."""
    from repro_torch.graph.segment import segment_softmax

    n = 4096
    edges, _ = gen.rmat(12, 8, seed=0)
    seg = torch.from_numpy(np.concatenate([edges[:, 1], [n, n]]).astype(
        np.int32)).to(cuda_device)        # two sentinel (padded) rows
    g = torch.Generator(device=cuda_device).manual_seed(0)
    scores = torch.randn((seg.shape[0], 8), generator=g, device=cuda_device)
    lay = tseg.build_layout(seg, n)
    before = tsegk.LAUNCHES["segment_sum"]
    got = segment_softmax(scores, seg, n, layout=lay)
    again = segment_softmax(scores, seg, n, layout=lay)
    assert tsegk.LAUNCHES["segment_sum"] - before == 2
    assert torch.equal(got, again)
    want = segment_softmax(scores.double().cpu(), seg.cpu(), n)
    keep = (seg < n).cpu()
    torch.testing.assert_close(got.cpu().double()[keep], want[keep],
                               rtol=1e-5, atol=1e-5)
    assert int(torch.bincount(seg[seg < n].long()).max()) >= 256


GNN_ZOO = {  # arch -> (smoke config, n_graphs, K4 launches a forward)
    "gat-cora": (tgnn.GAT_CORA_SMOKE, 1, 4),
    "schnet": (tgnn.SCHNET_SMOKE, 4, 3),
    "dimenet": (tgnn.DIMENET_SMOKE, 4, 4),
}


@pytest.mark.parametrize("arch", sorted(GNN_ZOO))
def test_gnn_zoo_train_step_goes_through_k4_and_matches_the_cpu(
        cuda_device, arch):
    cfg, n_graphs, want = GNN_ZOO[arch]
    batch = tdata.gnn_batch(arch, cfg, n_nodes=60, n_edges_und=180,
                            d_feat=getattr(cfg, "d_in", 8),
                            n_graphs=n_graphs, device="cpu")
    out, losses = {}, {}
    for dev in ("cpu", cuda_device):
        model = tsteps.init_for(arch, cfg, 0, dev)
        out[str(dev)] = model(batch.to(dev)).detach().cpu()
        step = tsteps.gnn_train_step(arch, cfg, topt.OptConfig())
        state = topt.opt_init(topt.OptConfig(),
                              dict(model.named_parameters()))
        before = tsegk.LAUNCHES["segment_sum"]
        state, metrics = step(model, state, batch.to(dev))
        losses[str(dev)] = float(metrics["loss"])
        launched = tsegk.LAUNCHES["segment_sum"] - before
        assert launched == (0 if dev == "cpu" else want)
    torch.testing.assert_close(out["cuda"], out["cpu"], rtol=1e-4,
                               atol=1e-4)
    assert abs(losses["cpu"] - losses["cuda"]) <= 1e-4 * (1 + losses["cpu"])


def test_sampled_block_on_the_card_equals_the_cpu(cuda_device):
    from repro_torch.train.data import GNNSampledStream

    edges, n = gen.rmat(12, 16, seed=0)
    blocks = {}
    for dev in ("cpu", cuda_device):
        g = from_edges(edges, n, device=dev)
        blocks[str(dev)] = next(GNNSampledStream(g, 64, (15, 10), n,
                                                 seed=3))
    for a, b in zip(blocks["cpu"], blocks["cuda"]):
        assert b.device.type == "cuda" and torch.equal(a, b.cpu())


# ------------------------------------------------------------ batch route

BATCH_MIXES = {
    "synth": lambda: tserve_tc.synth_requests(24, seed=0, smoke=True),
    "rmat12x4": lambda: [gen.rmat(12, 16, seed=s) for s in range(4)],
}


def _batch_fields(reps):
    return [(r.triangles, r.c1, r.c2, r.num_horizontal, r.k,
             r.overflow.h, r.levels.tolist(),
             None if r.per_vertex is None else r.per_vertex.tolist())
            for r in reps]


@pytest.mark.parametrize("per_vertex", [False, True], ids=["count", "pv"])
@pytest.mark.parametrize("mix", sorted(BATCH_MIXES))
def test_count_batch_on_the_card_equals_the_cpu(cuda_device, mix,
                                                per_vertex):
    """``count_batch`` on the card, bounded and exact, equals the port's
    CPU path lane for lane (the synth mix over its several cells)."""
    graphs = BATCH_MIXES[mix]()
    opts = TCOptions(per_vertex=per_vertex)
    gpu, cpu = (TriangleEngine(opts, device=d) for d in (cuda_device,
                                                         "cpu"))
    by_cell: dict = {}
    for e, n in graphs:
        by_cell.setdefault(gpu.budgets.budget_for(n, len(e)), []).append(
            (e, n))
    for cell in by_cell.values():
        for exact in (False, True):
            packed = [tcsr.from_edges_batch(cell, device=d)
                      for d in (cuda_device, "cpu")]
            if exact:
                packed = [dataclasses.replace(gb, meta=None)
                          for gb in packed]
            g, c = gpu.count_batch(packed[0]), cpu.count_batch(packed[1])
            assert g[0].backend == "cuda" and c[0].backend == "torch"
            assert _batch_fields(g) == _batch_fields(c)


def test_lane_view_launches_match_plain_and_go_once_per_bucket(
        cuda_device):
    """Every K1 and K2 call of a 4-lane rmat12 batch equals its plain
    version on every row, and the count makes one K1 launch per bucket
    of its plan for all lanes (not one per lane)."""
    graphs = BATCH_MIXES["rmat12x4"]()
    eng = TriangleEngine(device=cuda_device)
    gb = tcsr.from_edges_batch(graphs, device=cuda_device)
    plan = eng.plan_for(gb)
    before = dict(tkern.LAUNCHES)
    res = eng.count_batch_raw(gb, plan=plan)
    got = {k: tkern.LAUNCHES[k] - before[k] for k in before}
    assert got == {"intersect_levels": len(plan.buckets),
                   "intersect_hits": 0, "intersect_count": 0}
    assert not res.h_overflow.any()
    for name, opts in (("intersect_levels", TCOptions()),
                       ("intersect_hits", TCOptions(per_vertex=True))):
        real, calls = getattr(tint, name), []

        def record(*args, real=real, calls=calls, **kw):
            calls.append((args, kw))
            return real(*args, **kw)

        setattr(tint, name, record)
        try:
            eng.count_batch_raw(gb, options=opts, plan=plan)
        finally:
            setattr(tint, name, real)
        assert calls
        for args, kw in calls:
            assert args[1].shape[0] >= len(graphs)  # all lanes' rows
            if name == "intersect_levels":
                for x, y in zip(tkern.intersect_levels(*args, **kw),
                                intersect_levels_ref(*args, **kw)):
                    assert torch.equal(x, y)
            else:
                for x, y in zip(tkern.intersect_hits(*args, **kw),
                                intersect_hits_ref(*args, **kw)):
                    assert torch.equal(x, y)


def test_server_on_the_card_equals_the_cpu(cuda_device):
    reqs = tserve_tc.synth_requests(24, seed=0, smoke=True)
    out = []
    for d in (cuda_device, "cpu"):
        srv = TriangleEngine(TCOptions(per_vertex=True),
                             device=d).serve(batch_size=8)
        for e, n in reqs:
            srv.submit(e, n)
        res = sorted(srv.drain(), key=lambda r: r.request_id)
        out.append([(r.request_id, r.triangles, r.c1, r.c2,
                     r.num_horizontal, r.k, r.overflow,
                     r.per_vertex.tolist()) for r in res])
    assert out[0] == out[1] and len(out[0]) == 24


def test_robust_server_on_the_card_equals_the_cpu(cuda_device):
    """A server with per-vertex credit, admission tokens and a plan that
    fails every flush from ordinal 2 on (size and drain flushes only, so
    the schedule is the same on both devices): the same answers by id,
    exact (K2) and approx, and the same failed batches."""
    from repro_torch.launch.robust import FaultPlan

    reqs = tserve_tc.synth_requests(24, seed=0, smoke=True)
    opts = TCOptions(per_vertex=True, admission_tokens=6,
                     approx_samples=1024)
    out = []
    for d in (cuda_device, "cpu"):
        before = tkern.LAUNCHES["intersect_hits"]
        srv = TriangleEngine(opts, device=d).serve(
            batch_size=4, max_inflight=0,
            faults=FaultPlan(fail_batch_every=3))
        for e, n in reqs:
            srv.submit(e, n)
        res = sorted(srv.drain(), key=lambda r: r.request_id)
        if d == cuda_device:
            assert tkern.LAUNCHES["intersect_hits"] > before
        out.append(([(r.request_id, r.route, r.triangles, r.c1, r.c2,
                      r.num_horizontal, r.k if r.route == "batched" else None,
                      None if r.per_vertex is None else r.per_vertex.tolist(),
                      r.approx) for r in res],
                    srv.summary()["failed_batches"], srv.batches_run))
    assert out[0] == out[1] and len(out[0][0]) == 24
    assert out[0][1] > 0 and out[0][2] == 2


def test_edge_exists_and_wedge_baseline_on_the_card(cuda_device, monkeypatch):
    from repro_torch.core import wedge_baseline as wb

    e, n = gen.rmat(10, 16, seed=0)
    rng = np.random.default_rng(0)
    qu = torch.as_tensor(rng.integers(0, n + 3, size=50_000))
    qv = torch.as_tensor(rng.integers(0, n + 3, size=50_000))
    got, want = [], []
    for d, acc in ((cuda_device, got), ("cpu", want)):
        g = from_edges(e, n, device=d)
        acc.append(tint.edge_exists(g, qu.to(d), qv.to(d)).cpu())
        d_max, counts = tcsr.max_degree(g), []
        for budget in (wb.WEDGE_CELL_BUDGET, 1000 * d_max):  # 1,000 slots
            monkeypatch.setattr(wb, "WEDGE_CELL_BUDGET", budget)
            counts.append(int(wb.wedge_triangle_count(g, d_max=d_max)))
        monkeypatch.undo()
        acc.append(counts)
    assert torch.equal(got[0], want[0])
    assert got[1] == want[1] == [75682, 75682]


# ------------------------------------------------- distributed route
@pytest.mark.parametrize("mode", ["allgather", "ring"])
def test_k3_on_pair_lists_at_the_hedge_shapes(cuda_device, mode):
    """Algorithm 2's hedge rounds on the card over 8 shards stacked on
    one device: every K3 launch (a sorted block over the shards' pair
    lists) by each path equal to its plain version on every row, and
    the run equal to the CPU's, field for field."""
    from repro_torch.core.shards import LocalShards

    edges, n = gen.rmat(12, 16, seed=0)
    opts = TCOptions(mode=mode, per_vertex=False)
    cpu = TriangleEngine(device="cpu", mesh=LocalShards(8, "cpu"))
    card = TriangleEngine(device=cuda_device,
                          mesh=LocalShards(8, cuda_device))
    want = cpu.count_distributed_raw((edges, n), options=opts)
    before = tkern.LAUNCHES["intersect_count"]
    got = []
    calls = _captured_counts(lambda: got.append(
        card.count_distributed_raw((edges, n), options=opts)))
    got = got[0]
    assert tkern.LAUNCHES["intersect_count"] - before == len(calls) > 0
    for f in ("triangles", "per_device", "recv_counts", "num_horizontal",
              "transpose_overflow", "hedge_overflow"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    assert got.comm == want.comm and got.collectives == want.collectives
    for ops, kw in calls:
        _k3_paths_match(ops, kw)


def test_distributed_per_vertex_and_server_on_the_card(cuda_device):
    """Per-vertex credit on the route (K2 over the pair lists) equal to
    the CPU's; a capped server's over-budget request answered on the
    card, exactly, also after a stalled first attempt."""
    from repro_torch.core.shards import LocalShards
    from repro_torch.launch.robust import FaultPlan

    edges, n = gen.rmat(10, 16, seed=0)
    opts = TCOptions(per_vertex=True)
    a = TriangleEngine(device=cuda_device, mesh=LocalShards(8, cuda_device)
                       ).count((edges, n), route="distributed", options=opts)
    b = TriangleEngine(device="cpu", mesh=LocalShards(8, "cpu")).count(
        (edges, n), route="distributed", options=opts)
    assert a.triangles == b.triangles == 75682
    np.testing.assert_array_equal(a.per_vertex, b.per_vertex)

    class StallFirst(FaultPlan):
        def before_distributed(self, rid, attempt):
            if attempt == 0:
                super().before_distributed(rid, attempt)

    eng = TriangleEngine(
        TCOptions(distributed_timeout_s=5.0),
        budgets=tcsr.BudgetGrid(max_nodes=256, max_slots=2048),
        device=cuda_device, mesh=LocalShards(4, cuda_device))
    big = gen.rmat(9, 8, seed=0)
    srv = eng.serve(faults=StallFirst(stall_distributed_every=1,
                                      distributed_stall_s=5.5))
    srv.submit(*big)
    (r,) = srv.drain()
    assert (r.route, r.triangles) == (
        "distributed", eng.count(big, route="local").triangles)
    s = srv.summary()
    assert (s["distributed_timeouts"], s["distributed_retries"]) == (1, 1)


def test_prewarmed_server_first_request_loads_no_library(cuda_device,
                                                         tmp_path):
    """In a fresh process, a server prewarmed from a tuned profile loads
    the intersection library before its first request and none after;
    its answers equal the CPU's."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    from repro_torch.tune import SweepConfig, build_profile
    from repro_torch.tune.trace import TraceRecorder

    reqs = tserve_tc.synth_requests(12, seed=0, smoke=True)
    with TraceRecorder() as rec:
        srv = TriangleEngine(device="cpu").serve(batch_size=4, recorder=rec)
        for e, n in reqs:
            srv.submit(e, n)
        want = [r.triangles for r in sorted(srv.drain(),
                                            key=lambda r: r.request_id)]
    path = build_profile(SweepConfig("default", TCOptions()),
                         rec.records).save(str(tmp_path / "p.json"))
    np.savez(tmp_path / "reqs.npz", *[e for e, _ in reqs],
             n=np.array([n for _, n in reqs]))
    src = str(Path(__file__).resolve().parents[1] / "src")
    script = f"""
import json, sys
sys.path.insert(0, {src!r})
import numpy as np
from repro_torch.api import TriangleEngine
from repro_torch.kernels import build
d = np.load({str(tmp_path / "reqs.npz")!r})
srv = TriangleEngine(device="cuda", profile={path!r}).serve(
    batch_size=4, prewarm=True)
at_start = build.loads()
srv.submit(d["arr_0"], int(d["n"][0]))
srv.drain()
first = srv.summary()["jit_compiles"]
for i in range(1, len(d["n"])):
    srv.submit(d[f"arr_{{i}}"], int(d["n"][i]))
res = sorted(srv.drain(), key=lambda r: r.request_id)
print(json.dumps([at_start, first, srv.summary()["jit_compiles"],
                  srv.summary()["plan_hit"], [r.triangles for r in res]]))
"""
    proc = subprocess.run([sys.executable, "-c", script],
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    at_start, first, after, hit, got = json.loads(
        proc.stdout.strip().splitlines()[-1])
    assert at_start >= 1 and (first, after, hit) == (0, 0, 1.0)
    assert got == want


# ------------------------------------------------------------------- BST

def test_bst_embedding_bag_runs_k4_within_tol_and_repeats(cuda_device):
    """``embedding_bag``'s sum on the card is one K4 launch at BST's own
    layout (8 lookups a bag, F 32; bag ids past the end dropped, an empty
    bag), within 1e-5 (1 + S) of the float64 sum and bit for bit across
    calls; mean and max equal the CPU's."""
    from repro_torch.graph import segment as tgseg

    g = torch.Generator(device=cuda_device).manual_seed(0)
    table = torch.randn((4096, 32), generator=g, device=cuda_device)
    idx = torch.randint(-3, 4100, (65536,), generator=g, device=cuda_device)
    bags = torch.arange(8192, device=cuda_device).repeat_interleave(8)
    bags[:8] = 8192                                  # bag 0 empty
    before = tsegk.LAUNCHES["segment_sum"]
    got = tgseg.embedding_bag(table, idx, bags, 8192)
    assert tsegk.LAUNCHES["segment_sum"] == before + 1
    assert torch.equal(got, tgseg.embedding_bag(table, idx, bags, 8192))
    rows = table.index_select(0, idx.clamp(0, 4095)).double()
    want = segment_sum_ref(rows, bags, 8192)
    scale = 1 + segment_sum_ref(rows.abs(), bags, 8192)
    assert bool(((got.double() - want).abs() <= 1e-5 * scale).all())
    assert not got[0].any()
    cpu = [t.cpu() for t in (table, idx, bags)]
    for mode in ("mean", "max"):
        torch.testing.assert_close(
            tgseg.embedding_bag(table, idx, bags, 8192, mode=mode).cpu(),
            tgseg.embedding_bag(*cpu, 8192, mode=mode), rtol=0, atol=1e-6)


def test_bst_train_step_on_the_card_matches_the_cpu(cuda_device,
                                                    monkeypatch):
    """BST's smoke config: the logits, loss and every gradient leaf on the
    card (the profile bags on K4, once a forward) against the CPU's plain
    path on the same weights, within 1e-4 (1 + |cpu|); the retrieval
    scores in slices equal one call's to the same tolerance."""
    from repro_torch.configs import recsys as trecsys
    from repro_torch.models.recsys import bst as tbst

    cfg = trecsys.BST_SMOKE
    cpu = tbst.init_params(cfg, 0, "cpu")
    card = tbst.init_params(cfg, 0, cuda_device)
    batch = tdata.bst_batch(cfg, 256, 0, device="cpu")
    before = tsegk.LAUNCHES["segment_sum"]
    loss = tbst.loss_fn(card, *(t.to(cuda_device) for t in batch))
    assert tsegk.LAUNCHES["segment_sum"] == before + 1
    loss.backward()
    want = tbst.loss_fn(cpu, *batch)
    want.backward()
    torch.testing.assert_close(loss.detach().cpu(), want.detach(),
                               rtol=1e-4, atol=1e-4)
    cpu_params = dict(cpu.named_parameters())
    for name, p in card.named_parameters():
        ref = cpu_params[name].grad
        assert bool(((p.grad.cpu() - ref).abs()
                     <= 1e-4 * (1 + ref.abs())).all()), name
    step = tsteps.bst_retrieval_step(cfg)
    hist, cands = batch[0][0].to(cuda_device), torch.arange(
        cfg.item_vocab, device=cuda_device)
    assert tbst.RETRIEVAL_SLICE >= cfg.item_vocab
    one = step(card, hist, cands)
    monkeypatch.setattr(tbst, "RETRIEVAL_SLICE", 300)
    assert bool(((step(card, hist, cands) - one).abs()
                 <= 1e-4 * (1 + one.abs())).all())


def test_a2a_moe_layer_on_the_card_matches_the_cpu(cuda_device):
    """The explicit expert-parallel MoE layer (``models/moe_a2a.py``) at
    qwen2-moe's width over ``LocalShards(4, "cuda")`` under a (data 2,
    model 4) layout against the CPU's a2a path on the same weights: one
    K4 launch a data group, each slice's routing integers equal, the
    output, aux loss and every gradient within 1e-4 (1 + |cpu|)."""
    from repro_torch.core.shards import LocalShards
    from repro_torch.distributed.constrain import use_mesh
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import moe as tmoe

    cfg = dataclasses.replace(tlm.QWEN2_MOE_A2_7B.moe, dispatch="a2a")
    d = tlm.QWEN2_MOE_A2_7B.d_model
    g = torch.Generator().manual_seed(0)
    layer = tmoe.MoE(cfg, d)
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.02)
    x = torch.randn((4, 32, d), generator=g)
    layout = make_debug_mesh((2, 4))
    seen = {"cpu": [], "cuda": []}
    real = tmoe.route

    def spy(router, cfg_, tokens, capacity):
        r = real(router, cfg_, tokens, capacity)
        seen[tokens.device.type].append(r)
        return r

    w = torch.randn((4, 32, d), generator=g) * 0.01  # a fixed cotangent

    def run(lay, xx, dev):
        with use_mesh(layout, LocalShards(4, dev)):
            out, aux = tmoe.moe_ffn(lay.leaves(), cfg, xx)
        ((out * w.to(dev)).sum() + aux).backward()
        return out.detach(), aux.detach()

    tmoe.route = spy
    try:
        want, want_aux = run(layer, x, "cpu")
        card = tmoe.MoE(cfg, d).to(cuda_device)
        card.load_state_dict(layer.state_dict())
        before = tsegk.LAUNCHES["segment_sum"]
        got, aux = run(card, x.to(cuda_device), cuda_device)
        assert tsegk.LAUNCHES["segment_sum"] - before == 2
    finally:
        tmoe.route = real
    assert len(seen["cuda"]) == len(seen["cpu"]) == 8  # 2 groups x 4
    for rc, rg in zip(seen["cpu"], seen["cuda"]):
        for f in ("expert_idx", "keep"):
            assert torch.equal(getattr(rg, f).cpu(), getattr(rc, f)), f
    assert bool(((got.cpu() - want).abs() <= 1e-4 * (1 + want.abs())).all())
    assert abs(float(aux) - float(want_aux)) <= 1e-4 * (1 + abs(
        float(want_aux)))
    cpu_params = dict(layer.named_parameters())
    for name, p in card.named_parameters():
        ref = cpu_params[name].grad
        err = ((p.grad.cpu() - ref).abs() / (1 + ref.abs())).max()
        assert float(err) <= 1e-4, (name, float(err))


def test_int8_psum_on_the_card_equals_the_cpu_bits(cuda_device):
    """``int8_compressed_psum`` over ``LocalShards(8, "cuda")`` with
    unequal per-shard absmax equals the CPU's bit for bit."""
    from repro_torch.core.shards import LocalShards
    from repro_torch.train.trainer import int8_compressed_psum

    rng = np.random.default_rng(0)
    scale = (10.0 ** -rng.uniform(0, 3, 8)).astype(np.float32)
    shapes = {"w": (70, 70), "b": (70,), "e": (1433, 70)}
    host = {k: torch.from_numpy((rng.standard_normal((8,) + s)
                                 * scale.reshape((8,) + (1,) * len(s))
                                 ).astype(np.float32))
            for k, s in shapes.items()}
    got = int8_compressed_psum({k: v.to(cuda_device) for k, v in
                                host.items()}, LocalShards(8, cuda_device))
    want = int8_compressed_psum(host, LocalShards(8, "cpu"))
    for k in host:
        assert torch.equal(got[k].cpu().view(torch.int32),
                           want[k].view(torch.int32)), k
