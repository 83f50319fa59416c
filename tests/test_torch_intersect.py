"""The port's intersection engine held bit for bit against the JAX
package: ``plan_buckets`` field for field, the plain versions of K1
(dense ``intersect_ref`` and CSR-bounds ``intersect_levels_ref``)
against ``intersect_pallas`` in interpret mode and the reference's
``intersect_ref``, and ``run_plan`` / ``count_common_neighbors`` with and
without ``query_chunk``.  K1's and K2's work layout (``ItemLayout``)
holds its properties, and their item walk in plain PyTorch
(``probe_items_ref``: bitmaps, windows) equals the plain
versions row for row and ``intersect_pallas`` / ``intersect_pallas_hits``
in interpret mode.  ``kernels/intersect/ops.py``'s end-to-end karate
count is held against the reference's.  Inputs are numpy arrays made
from a seed."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bfs as jbfs
from repro.core import edges as jedges
from repro.core import intersect as jint
from repro.graph import csr as jcsr
from repro.kernels.intersect.intersect import (
    intersect_pallas,
    intersect_pallas_count,
    intersect_pallas_hits,
)
from repro.kernels.intersect.ref import intersect_ref as j_intersect_ref
from repro_torch.core import bfs as tbfs
from repro_torch.core import edges as tedges
from repro_torch.core import intersect as tint
from repro_torch.graph import csr as tcsr
from repro_torch.graph import generators as gen
from repro_torch.kernels.intersect import intersect as tkern
from repro_torch.kernels.intersect.ref import (
    count_tiles_ref,
    found_counts,
    hits_ref,
    intersect_count_ref,
    intersect_hits_ref,
    intersect_levels_ref,
    intersect_ref,
    probe_items_ref,
    search_steps,
    split_counts,
)

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(x):
    return np.asarray(x.cpu().numpy() if isinstance(x, torch.Tensor) else x)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.int32))


# ------------------------------------------------------------------ plans

def _profile(seed, h, layout):
    rng = np.random.default_rng(seed)
    ds = rng.integers(1, 700, size=h)
    dl = ds + rng.integers(0, 900, size=h)
    order = np.argsort(ds, kind="stable")
    if layout == "desc":
        order = order[::-1]
    return ds[order], dl[order]


@pytest.mark.parametrize("layout", ["asc", "desc"])
@pytest.mark.parametrize("kw", [
    {},
    {"bucket_widths": (8, 64, 512)},
    {"d_cap": 100},
    {"row_mult": 1},
    {"row_mult": 128, "query_chunk": 128},
    {"bucket_widths": (1000,)},
], ids=["default", "widths", "d_cap", "rows1", "chunk128", "one_bucket"])
def test_plan_buckets_match_reference(layout, kw):
    ds, dl = _profile(len(kw) + (layout == "asc"), 3000, layout)
    jp = jint.plan_buckets(ds, dl, layout=layout, **kw)
    tp = tint.plan_buckets(ds, dl, layout=layout, **kw)
    assert len(tp.buckets) == len(jp.buckets) > 0
    for jb, tb in zip(jp.buckets, tp.buckets):
        assert (tb.start, tb.count, tb.rows, tb.d_cand, tb.d_targ) == (
            jb.start, jb.count, jb.rows, jb.d_cand, jb.d_targ)
    assert tp.total_rows == jp.total_rows
    assert tp.probe_rows == jp.probe_rows
    assert tp.probe_cells == jp.probe_cells
    assert tp.peak_rows == jp.peak_rows


def test_plan_buckets_empty_and_bad_layout():
    assert tint.plan_buckets([], [], layout="desc").buckets == ()
    with pytest.raises(ValueError, match="layout must be"):
        tint.plan_buckets([1], [1], layout="sideways")


# ------------------------------------------------ K1 plain versions (dense)

def _random_sorted_lists(rng, q, d, hi):
    out = np.full((q, d), -1, dtype=np.int32)
    for i in range(q):
        ln = rng.integers(0, d + 1)
        vals = np.unique(rng.integers(0, hi, size=ln))
        out[i, : len(vals)] = vals
    return out


SWEEP = [
    (7, 17, 8, 128),      # sub-block ragged
    (64, 128, 32, 128),   # exact tiles
    (33, 260, 16, 128),   # multi-tile D with remainder
    (128, 64, 128, 64),   # small blocks
]


@pytest.mark.parametrize("q,d,bq,bd", SWEEP)
def test_intersect_ref_matches_reference_and_pallas(q, d, bq, bd):
    rng = np.random.default_rng(q * 1000 + d)
    cand = _random_sorted_lists(rng, q, d, 400)
    targ = _random_sorted_lists(rng, q, d, 400)
    targ = np.where(targ < 0, -2, targ)
    lev_c = rng.integers(0, 5, size=(q, d)).astype(np.int32)
    lev_u = rng.integers(0, 5, size=(q,)).astype(np.int32)
    jargs = tuple(map(jnp.asarray, (cand, targ, lev_c, lev_u)))
    c1p, c2p = intersect_pallas(*jargs, block_q=bq, block_d=bd,
                                interpret=True)
    c1r, c2r = j_intersect_ref(*jargs)
    c1t, c2t = intersect_ref(*map(_t, (cand, targ, lev_c, lev_u)))
    assert c1t.dtype == c2t.dtype == torch.int32
    for a in (c1p, c1r):
        np.testing.assert_array_equal(_np(c1t), np.asarray(a))
    for a in (c2p, c2r):
        np.testing.assert_array_equal(_np(c2t), np.asarray(a))


# ------------------------------------------- K1 plain versions (CSR bounds)

def _csr_operands(rng, q, d, n=400, lmax=None):
    """Flat sorted adjacency of n vertices + q random query rows whose
    candidate/target slices are vertex lists (lengths up to ``lmax``)."""
    lmax = lmax or d
    lists = [np.unique(rng.integers(0, n, size=rng.integers(0, lmax + 1)))
             for _ in range(n)]
    flat = np.concatenate(lists).astype(np.int32)
    starts = np.cumsum([0] + [len(x) for x in lists[:-1]]).astype(np.int32)
    lens = np.array([len(x) for x in lists], np.int32)
    u = rng.integers(0, n, size=q)
    w = rng.integers(0, n, size=q)
    level = rng.integers(0, 4, size=n).astype(np.int32)
    lev_u = level[u]
    return (flat, starts[u], lens[u], starts[w], lens[w], level, lev_u)


def _pallas_on_dense(ops, *, d_cand, d_targ, bq, bd):
    """The reference kernel on the dense blocks its engine gathers from
    the same bounds (``_gather_cand_targ``)."""
    flat, s_s, l_s, s_l, l_l, level, lev_u = map(jnp.asarray, ops)
    cand, targ, _ = jint._gather_cand_targ(
        flat, s_s, l_s, s_l, l_l, d_cand=d_cand, d_targ=d_targ,
        need_targ=True)
    n = level.shape[0]
    lev_ext = jnp.concatenate([level, jnp.full((1,), -7, jnp.int32)])
    lev_c = jnp.where(cand >= 0, lev_ext[jnp.clip(cand, 0, n)], -7)
    return intersect_pallas(cand, targ, lev_c, lev_u, block_q=bq,
                            block_d=bd, interpret=True)


@pytest.mark.parametrize("q,d,bq,bd", SWEEP)
def test_intersect_levels_ref_matches_pallas(q, d, bq, bd):
    rng = np.random.default_rng(q + d)
    ops = _csr_operands(rng, q, d)
    d_targ = int(max(ops[4].max(), 1))
    c1p, c2p = _pallas_on_dense(ops, d_cand=d, d_targ=d_targ, bq=bq, bd=bd)
    c1t, c2t = intersect_levels_ref(*map(_t, ops), d_cand=d, d_targ=d_targ)
    np.testing.assert_array_equal(_np(c1t), np.asarray(c1p))
    np.testing.assert_array_equal(_np(c2t), np.asarray(c2p))
    # the wrapper takes the plain version for CPU tensors
    c1w, c2w = tkern.intersect_levels(*map(_t, ops), d_cand=d, d_targ=d_targ)
    np.testing.assert_array_equal(_np(c1w), _np(c1t))
    np.testing.assert_array_equal(_np(c2w), _np(c2t))


@pytest.mark.parametrize("d_cand,d_targ", [(16, 200), (64, 24), (8, 8)])
def test_intersect_levels_ref_clamps_like_the_dense_gather(d_cand, d_targ):
    # lists up to 100 long against widths that clamp them
    rng = np.random.default_rng(d_cand * d_targ)
    ops = _csr_operands(rng, 48, 100, n=300)
    assert ops[2].max() > d_cand or ops[4].max() > d_targ
    c1p, c2p = _pallas_on_dense(ops, d_cand=d_cand, d_targ=d_targ, bq=16,
                                bd=128)
    c1t, c2t = intersect_levels_ref(*map(_t, ops), d_cand=d_cand,
                                    d_targ=d_targ)
    np.testing.assert_array_equal(_np(c1t), np.asarray(c1p))
    np.testing.assert_array_equal(_np(c2t), np.asarray(c2p))


def test_wrapper_rejects_operands_the_kernel_does_not_take():
    ops = [_t(x) for x in _csr_operands(np.random.default_rng(0), 8, 16)]
    with pytest.raises(TypeError, match="int32"):
        tkern.intersect_levels(ops[0].long(), *ops[1:], d_cand=16,
                               d_targ=16)
    with pytest.raises(ValueError, match="1-D"):
        tkern.intersect_levels(ops[0], ops[1][:, None], *ops[2:],
                               d_cand=16, d_targ=16)
    with pytest.raises(ValueError, match="rows"):
        tkern.intersect_levels(*ops[:4], ops[4][:3], *ops[5:], d_cand=16,
                               d_targ=16)
    with pytest.raises(ValueError, match="one device"):
        tkern.intersect_levels(ops[0].to("meta"), *ops[1:], d_cand=16,
                               d_targ=16)
    with pytest.raises(ValueError, match=">= 0"):
        tkern.intersect_levels(*ops, d_cand=-1, d_targ=16)
    before = dict(tkern.LAUNCHES)
    tkern.intersect_levels(*ops, d_cand=16, d_targ=16)
    assert tkern.LAUNCHES == before  # the plain path is not a launch


# ------------------------------------------- K3 plain versions (level-free)

@pytest.mark.parametrize("q,d,bq,bd", SWEEP)
def test_count_ref_matches_pallas_count(q, d, bq, bd):
    rng = np.random.default_rng(q * 7 + d)
    cand = _random_sorted_lists(rng, q, d, 400)
    targ = _random_sorted_lists(rng, q, d, 400)
    targ = np.where(targ < 0, -2, targ)
    cp = intersect_pallas_count(jnp.asarray(cand), jnp.asarray(targ),
                                block_q=bq, block_d=bd, interpret=True)
    ct = hits_ref(_t(cand), _t(targ)).sum(dim=1, dtype=torch.int32)
    assert ct.dtype == torch.int32
    np.testing.assert_array_equal(_np(ct), np.asarray(cp))


def _pallas_count_on_dense(ops, *, d_cand, d_targ, bq, bd):
    """The reference's count kernel on the dense blocks its engine
    gathers from the same bounds."""
    flat, s_s, l_s, s_l, l_l = map(jnp.asarray, ops[:5])
    cand, targ, _ = jint._gather_cand_targ(
        flat, s_s, l_s, s_l, l_l, d_cand=d_cand, d_targ=d_targ,
        need_targ=True)
    return intersect_pallas_count(cand, targ, block_q=bq, block_d=bd,
                                  interpret=True)


@pytest.mark.parametrize("q,d,bq,bd", SWEEP + [(40, 100, 16, 128)])
@pytest.mark.parametrize("targ_scale", [1, 2, 0.5],
                         ids=["dt_eq", "dt_wide", "dt_clamped"])
def test_intersect_count_ref_matches_pallas_count(q, d, bq, bd, targ_scale):
    rng = np.random.default_rng(q + 3 * d)
    ops = _csr_operands(rng, q, d)
    d_targ = max(1, int(int(ops[4].max()) * targ_scale))
    cp = _pallas_count_on_dense(ops, d_cand=d, d_targ=d_targ, bq=bq, bd=bd)
    ct = intersect_count_ref(*map(_t, ops[:5]), d_cand=d, d_targ=d_targ)
    np.testing.assert_array_equal(_np(ct), np.asarray(cp))
    # K1's c1 + c2 on the same rows, and the wrapper's plain path
    c1, c2 = intersect_levels_ref(*map(_t, ops), d_cand=d, d_targ=d_targ)
    np.testing.assert_array_equal(_np(ct), _np(c1 + c2))
    before = dict(tkern.LAUNCHES)
    cw = tkern.intersect_count(*map(_t, ops[:5]), d_cand=d, d_targ=d_targ)
    assert tkern.LAUNCHES == before  # the plain path is not a launch
    np.testing.assert_array_equal(_np(cw), _np(ct))


def test_found_counts_under_searches_like_the_reference():
    # a target longer than the search depth covers: the jnp probe's rule
    rng = np.random.default_rng(11)
    ops = _csr_operands(rng, 64, 100, n=300)
    flat, s_s, l_s, s_l, l_l = map(_t, ops[:5])
    d_targ = 16
    assert int(l_l.max()) > 2 ** search_steps(d_targ) - 1
    got = found_counts(flat, s_s, l_s, s_l, l_l, d_cand=128,
                       num_steps=search_steps(d_targ))
    c1, c2 = split_counts(flat, s_s, l_s, s_l, l_l, _t(ops[5]), _t(ops[6]),
                          d_cand=128, num_steps=search_steps(d_targ))
    np.testing.assert_array_equal(_np(got), _np(c1 + c2))
    with pytest.raises(ValueError, match="rows"):
        tkern.intersect_count(flat, s_s, l_s[:3], s_l, l_l, d_cand=8,
                              d_targ=8)


# ---------------------------------------------------------- engine level

def _engine_inputs(edges, n):
    jg = jcsr.from_edges(edges, n)
    tg = tcsr.from_edges(edges, n, device=CPU)
    jl = jbfs.bfs_levels(jg.src, jg.dst, n, row_offsets=jg.row_offsets)
    tl = tbfs.bfs_levels(tg.src, tg.dst, n, row_offsets=tg.row_offsets)
    jq = jedges.horizontal_queries(jg, jl, order="desc")
    tq = tedges.horizontal_queries(tg, tl, order="desc")
    return jg, tg, jl, tl, jq, tq


GRAPHS = {
    "karate": gen.karate(),
    "ring_of_cliques": gen.ring_of_cliques(5, 6),
    "rmat10": gen.rmat(10, 16, seed=0),
}


@pytest.mark.parametrize("query_chunk", [None, 64])
@pytest.mark.parametrize("case", sorted(GRAPHS))
def test_run_plan_matches_reference(case, query_chunk):
    jg, tg, jl, tl, jq, tq = _engine_inputs(*GRAPHS[case])
    h = int(jq[4])
    ds, dl = np.asarray(jq[2])[:h], np.asarray(jq[3])[:h]
    kw = dict(layout="desc", query_chunk=query_chunk,
              row_mult=query_chunk or 64)
    jp = jint.plan_buckets(ds, dl, backend="jnp", **kw)
    tp = tint.plan_buckets(ds, dl, backend="torch", **kw)
    je = jint.run_plan(jint.CsrAdjacency.from_graph(jg), jq[0], jq[1], jp,
                       level=jl)
    te = tint.run_plan(tint.CsrAdjacency.from_graph(tg), tq[0], tq[1], tp,
                       level=tl)
    assert int(te.c1) == int(je.c1) and int(te.c2) == int(je.c2)
    assert bool(te.overflow) == bool(je.overflow) is False
    assert te.c1.dtype == te.c2.dtype == torch.int32


def test_run_plan_flags_a_clamped_candidate_width():
    jg, tg, jl, tl, jq, tq = _engine_inputs(*GRAPHS["rmat10"])
    h = int(jq[4])
    ds, dl = np.asarray(jq[2])[:h], np.asarray(jq[3])[:h]
    jp = jint.plan_buckets(ds, dl, layout="desc", d_cap=40)
    tp = tint.plan_buckets(ds, dl, layout="desc", d_cap=40)
    je = jint.run_plan(jint.CsrAdjacency.from_graph(jg), jq[0], jq[1], jp,
                       level=jl)
    te = tint.run_plan(tint.CsrAdjacency.from_graph(tg), tq[0], tq[1], tp,
                       level=tl)
    assert (int(te.c1), int(te.c2)) == (int(je.c1), int(je.c2))
    assert bool(te.overflow) and bool(je.overflow)


@pytest.mark.parametrize("per_vertex", [False, True], ids=["count", "pv"])
@pytest.mark.parametrize("query_chunk", [None, 64])
@pytest.mark.parametrize("case", sorted(GRAPHS))
def test_level_free_run_plan_matches_reference(case, query_chunk,
                                               per_vertex):
    """``level=None``: every hit counts once into c1 (c2 == 0) and, with
    credit, credits its apex and both edge endpoints."""
    jg, tg, jl, tl, jq, tq = _engine_inputs(*GRAPHS[case])
    h = int(jq[4])
    ds, dl = np.asarray(jq[2])[:h], np.asarray(jq[3])[:h]
    kw = dict(layout="desc", query_chunk=query_chunk,
              row_mult=query_chunk or 64)
    jp = jint.plan_buckets(ds, dl, backend="jnp", **kw)
    tp = tint.plan_buckets(ds, dl, backend="torch", **kw)
    je = jint.run_plan(jint.CsrAdjacency.from_graph(jg), jq[0], jq[1], jp,
                       level=None, per_vertex=per_vertex)
    te = tint.run_plan(tint.CsrAdjacency.from_graph(tg), tq[0], tq[1], tp,
                       level=None, per_vertex=per_vertex)
    assert (int(te.c1), int(te.c2)) == (int(je.c1), int(je.c2))
    assert int(te.c2) == 0 and int(te.c1) > 0
    assert bool(te.overflow) == bool(je.overflow) is False
    if per_vertex:
        np.testing.assert_array_equal(_np(te.per_vertex),
                                      np.asarray(je.per_vertex))
        assert int(te.per_vertex.sum()) == 3 * int(te.c1)


@pytest.mark.parametrize("query_chunk", [None, 32])
@pytest.mark.parametrize("d_cand,d_targ", [(64, None), (128, 256), (16, 4)],
                         ids=["square", "wide_targ", "under_search"])
def test_count_common_neighbors_matches_reference(d_cand, d_targ,
                                                  query_chunk):
    jg, tg, jl, tl, jq, tq = _engine_inputs(*GRAPHS["rmat10"])
    rows = 2048  # includes the sentinel tail of the compacted block
    ja = jint.count_common_neighbors(
        jg, jq[0][:rows], jq[1][:rows], jl, d_cand=d_cand, d_targ=d_targ,
        query_chunk=query_chunk)
    ta = tint.count_common_neighbors(
        tg, tq[0][:rows], tq[1][:rows], tl, d_cand=d_cand, d_targ=d_targ,
        query_chunk=query_chunk, backend="torch")
    assert (int(ta[0]), int(ta[1])) == (int(ja[0]), int(ja[1]))


def test_backends_agree_row_by_row_on_exact_plans():
    """``"torch"`` (unclamped search, reference jnp probe) and the
    kernel's function (clamped target, ``intersect_levels_ref``) give the
    same per-row counts on every bucket of an exact plan."""
    _, tg, _, tl, _, tq = _engine_inputs(*gen.rmat(11, 16, seed=0))
    h = int(tq[4])
    plan = tint.plan_buckets(_np(tq[2])[:h], _np(tq[3])[:h], layout="desc")
    adj = tint.CsrAdjacency.from_graph(tg)
    assert len(plan.buckets) == 3
    for b, base, qu, qw, bounds in tint.bucket_slices(adj, tq[0], tq[1],
                                                      plan):
        ops = tint.probe_operands(adj, qu, qw, bounds, base, b.count, tl)
        s_s, l_s, s_l, l_l, lev_u = ops
        kern = intersect_levels_ref(adj.flat, s_s, l_s, s_l, l_l, tl, lev_u,
                                    d_cand=b.d_cand, d_targ=b.d_targ)
        probe = split_counts(adj.flat, s_s, l_s, s_l, l_l, tl, lev_u,
                             d_cand=b.d_cand,
                             num_steps=search_steps(b.d_targ))
        for a, c in zip(kern, probe):
            np.testing.assert_array_equal(_np(a), _np(c))
        assert int(l_l.max()) <= b.d_targ and int(l_s.max()) <= b.d_cand


@pytest.mark.parametrize("backend,device,expect", [
    ("auto", "cpu", "torch"),
    ("auto", "cuda", "cuda"),
    ("torch", "cpu", "torch"),
    ("torch", "cuda", "torch"),
    ("cuda", "cuda", "cuda"),
])
def test_resolve_backend_rule(backend, device, expect):
    assert tint.resolve_backend(backend, device) == expect


def test_resolve_backend_refusals():
    with pytest.raises(ValueError, match="needs a CUDA device"):
        tint.resolve_backend("cuda", "cpu")
    with pytest.raises(ValueError, match="intersect_backend must be"):
        tint.resolve_backend("pallas", "cpu")


# --------------------------------------- K1 and K2's work layout and walk


def _item_operands(rng, *, q, n_lists, cand_len, targ_len, id_hi, hubs,
                   n_level=None):
    """Sorted unique id lists as the kernels' operands: ``n_lists``
    candidate lists (the first led by negative ids, the second holding
    sentinel ids past ``level``), ``n_lists`` target lists and ``hubs``
    long ones; ``q`` rows, a third of them against the hubs."""
    n_level = id_hi // 2 if n_level is None else n_level
    lists = [np.unique(rng.integers(0, id_hi, size=rng.integers(1, cand_len)))
             for _ in range(n_lists)]
    lists[0] = np.r_[-7, -1, lists[0]]
    lists[1] = np.unique(np.r_[lists[1], n_level, n_level + 3])
    lists += [np.unique(rng.integers(0, id_hi, size=rng.integers(0, targ_len)))
              for _ in range(n_lists)]
    lists += [np.unique(np.r_[rng.integers(0, id_hi, size=4 * targ_len),
                              n_level])
              for _ in range(hubs)]
    flat = np.concatenate(lists).astype(np.int32)
    starts = np.cumsum([0] + [len(x) for x in lists[:-1]]).astype(np.int32)
    lens = np.array([len(x) for x in lists], np.int32)
    u = rng.integers(0, n_lists, size=q)
    w = rng.integers(n_lists, 2 * n_lists, size=q)
    w[: q // 3] = rng.integers(2 * n_lists, 2 * n_lists + hubs, size=q // 3)
    level = rng.integers(0, 3, size=n_level).astype(np.int32)
    lev_u = rng.integers(0, 3, size=q).astype(np.int32)
    ls, ll = lens[u], lens[w]
    ls[rng.random(q) < 0.05] = 0  # sentinel rows
    return [_t(x) for x in (flat, starts[u], ls, starts[w], ll, level,
                            lev_u)]


ITEM_CASES = {
    # (q, n_lists, cand_len, targ_len, id_hi, hubs, d_cand, d_targ)
    "small_ids": (300, 40, 60, 80, 400, 2, 64, 400),
    "clamped": (400, 40, 120, 200, 3000, 3, 48, 150),
    "wide_rows": (120, 20, 900, 600, 20000, 2, 1024, 5000),
}


@pytest.mark.parametrize("align", [0, 3])
@pytest.mark.parametrize("item_cells", [64, 256, 4096])
@pytest.mark.parametrize("case", sorted(ITEM_CASES))
def test_item_layout_properties(case, item_cells, align, monkeypatch):
    """Each live row lies in exactly one item, the dead rows last; an
    item has one target, at most ``ITEM_CELLS`` cells unless it is one
    row, at most ``ITEM_ROWS`` rows; one target's rows keep their order;
    ``cum`` counts each row's 16-byte groups."""
    monkeypatch.setattr(tkern, "ITEM_CELLS", item_cells)  # many cuts
    monkeypatch.setattr(tkern, "ITEM_ROWS", 5)
    q, nl, cl, tl, hi, hubs, d_cand, d_targ = ITEM_CASES[case]
    ops = _item_operands(np.random.default_rng(len(case)), q=q, n_lists=nl,
                         cand_len=cl, targ_len=tl, id_hi=hi, hubs=hubs)
    flat, s_s, l_s, s_l, l_l = ops[:5]
    lay = tkern.ItemLayout(s_s, l_s, s_l, l_l, d_cand=d_cand, d_targ=d_targ,
                           align=align)
    ls = _np(l_s.clamp(0, d_cand))
    ll = _np(l_l.clamp(0, d_targ))
    perm = _np(lay.perm)
    n_items = int(lay.n_items[0])
    n_live = int((ls > 0).sum())
    assert sorted(perm.tolist()) == list(range(q))
    assert (ls[perm[:n_live]] > 0).all() and not ls[perm[n_live:]].any()
    groups = ((_np(s_s) + align) % 4 + ls + 3) // 4
    np.testing.assert_array_equal(_np(lay.cum)[: n_live + 1], np.r_[
        0, np.cumsum(groups[perm[:n_live]])])  # the dead rows' are unread
    starts = _np(lay.item_start)[: n_items + 1]
    assert starts[0] == 0 and starts[-1] == n_live and (
        np.diff(starts) > 0).all()
    target = np.stack([_np(s_l), ll], 1)
    for a, b in zip(starts[:-1], starts[1:]):
        rows = perm[a:b]
        assert (target[rows] == target[rows[0]]).all()
        assert b - a <= tkern.ITEM_ROWS
        assert b - a == 1 or 4 * groups[rows].sum() <= tkern.ITEM_CELLS
    # stable: one target's rows in their first order
    key = target[perm[:n_live]]
    same = (key[1:] == key[:-1]).all(1)
    assert (perm[1:n_live][same] > perm[:n_live - 1][same]).all()


@pytest.mark.parametrize("q", [60, 99, 100])
@pytest.mark.parametrize("d_cand", [16, 255, 256, 257, 4096])
def test_item_layout_rule_by_width(d_cand, q, monkeypatch):
    """The host's rule: a call wider than ``WALK_MAX_CAND`` and of at
    least ``BITMAP_MIN_ROWS`` rows puts every live row on the bitmap,
    any other builds no layout (every row walks); ``path`` forces either
    side on any shape."""
    monkeypatch.setattr(tkern, "BITMAP_MIN_ROWS", 100)
    ops = _item_operands(np.random.default_rng(d_cand), q=q, n_lists=10,
                         cand_len=40, targ_len=80, id_hi=500, hubs=1)
    kw = dict(d_cand=d_cand, d_targ=400)
    lay = tkern.item_layout(*ops[1:5], **kw)
    assert (lay is None) == (d_cand <= tkern.WALK_MAX_CAND or q < 100)
    assert tkern.item_layout(*ops[1:5], path="walk", **kw) is None
    forced = tkern.item_layout(*ops[1:5], path="bitmap", **kw)
    n_live = int((ops[2].clamp(0, d_cand) > 0).sum())
    assert int(forced.item_start[int(forced.n_items[0])]) == n_live


def _items_vs_plain(ops, *, d_cand, d_targ, path, bitmap_words=None,
                    align=0):
    lay = tkern.item_layout(*ops[1:5], d_cand=d_cand, d_targ=d_targ,
                            path=path, align=align)
    off, hits, c1, c2 = probe_items_ref(
        *ops[:5], lay, d_cand=d_cand, d_targ=d_targ, level=ops[5],
        lev_u=ops[6], bitmap_words=bitmap_words)
    r1, r2 = intersect_levels_ref(*ops, d_cand=d_cand, d_targ=d_targ)
    ro, rh = intersect_hits_ref(*ops[:5], d_cand=d_cand, d_targ=d_targ)
    np.testing.assert_array_equal(_np(c1), _np(r1))
    np.testing.assert_array_equal(_np(c2), _np(r2))
    np.testing.assert_array_equal(_np(off), _np(ro))
    np.testing.assert_array_equal(_np(hits), _np(rh))
    return lay, (c1, c2), hits


@pytest.mark.parametrize("bitmap_words", [None, 2, 7],
                         ids=["full", "w64", "w224"])
@pytest.mark.parametrize("align", [0, 3])
@pytest.mark.parametrize("path", ["auto", "bitmap", "walk"])
@pytest.mark.parametrize("case", sorted(ITEM_CASES))
def test_item_walk_matches_plain(case, path, align, bitmap_words,
                                 monkeypatch):
    """The item walk equals the plain K1 and K2 row for row: negative and
    sentinel candidates, sentinel rows, clamped widths, items cut at two
    alignments of the flat array, and bitmaps of 64 or 224 ids a window
    where the spans are wider (windows)."""
    monkeypatch.setattr(tkern, "ITEM_CELLS", 512)
    monkeypatch.setattr(tkern, "WALK_MAX_CAND", 16)
    monkeypatch.setattr(tkern, "BITMAP_MIN_ROWS", 0)
    q, nl, cl, tl, hi, hubs, d_cand, d_targ = ITEM_CASES[case]
    ops = _item_operands(np.random.default_rng(3 * len(case)), q=q,
                         n_lists=nl, cand_len=cl, targ_len=tl, id_hi=hi,
                         hubs=hubs)
    lay, (c1, c2), hits = _items_vs_plain(
        ops, d_cand=d_cand, d_targ=d_targ, path=path,
        bitmap_words=bitmap_words, align=align)
    assert int(c1.sum()) > 0 and int(c2.sum()) > 0 and not hits.all()
    assert (lay is None) == (path == "walk")
    if lay is not None:
        assert int(lay.n_items[0]) > 1


def test_item_walk_over_a_span_wider_than_the_bitmap():
    """Ids up to ~4 M, so a hub's span takes three windows of the real
    bitmap."""
    ops = _item_operands(np.random.default_rng(5), q=90, n_lists=10,
                         cand_len=3000, targ_len=20000, id_hi=4_000_000,
                         hubs=1)
    lay, *_ = _items_vs_plain(ops, d_cand=4096, d_targ=100_000,
                              path="bitmap", align=1)
    targ = ops[0][int(ops[3][0]):int(ops[3][0]) + int(ops[4][0])]
    assert int(targ[-1] - targ[0]) > tkern.BITMAP_WORDS * 32


@pytest.mark.parametrize("path", ["auto", "bitmap"])
def test_item_walk_matches_plain_on_every_bucket_of_rmat12(path,
                                                           monkeypatch):
    """The count's own operands: every bucket of rmat12's plan, K1 and K2
    by the item walk equal to their plain versions row for row."""
    monkeypatch.setattr(tkern, "WALK_MAX_CAND", 0)
    monkeypatch.setattr(tkern, "BITMAP_MIN_ROWS", 0)
    _, tg, _, tl, _, tq = _engine_inputs(*gen.rmat(12, 16, seed=0))
    h = int(tq[4])
    plan = tint.plan_buckets(_np(tq[2])[:h], _np(tq[3])[:h], layout="desc")
    adj = tint.CsrAdjacency.from_graph(tg)
    assert len(plan.buckets) == 3
    for b, base, qu, qw, bounds in tint.bucket_slices(adj, tq[0], tq[1],
                                                      plan):
        s_s, l_s, s_l, l_l, lev_u = tint.probe_operands(
            adj, qu, qw, bounds, base, b.count, tl)
        lay, _, _ = _items_vs_plain(
            (adj.flat, s_s, l_s, s_l, l_l, tl, lev_u), d_cand=b.d_cand,
            d_targ=b.d_targ, path=path)
        assert int(lay.n_items[0]) > 0


@pytest.mark.parametrize("path", ["bitmap", "walk"])
@pytest.mark.parametrize("d_cand,d_targ", [(16, 200), (64, 24), (40, 100)])
def test_item_walk_matches_pallas(d_cand, d_targ, path):
    """The item walk against the reference's kernels in interpret mode on
    the dense blocks its engine gathers from the same bounds:
    ``intersect_pallas`` (c1, c2) and ``intersect_pallas_hits`` (the mask,
    scattered from the ragged one)."""
    rng = np.random.default_rng(d_cand + d_targ)
    ops = [_t(x) for x in _csr_operands(rng, 48, 100, n=300)]
    lay = tkern.item_layout(*ops[1:5], d_cand=d_cand, d_targ=d_targ,
                            path=path)
    off, hits, c1, c2 = probe_items_ref(
        *ops[:5], lay, d_cand=d_cand, d_targ=d_targ, level=ops[5],
        lev_u=ops[6], bitmap_words=2)
    p1, p2 = _pallas_on_dense(tuple(map(_np, ops)), d_cand=d_cand,
                              d_targ=d_targ, bq=16, bd=128)
    np.testing.assert_array_equal(_np(c1), np.asarray(p1))
    np.testing.assert_array_equal(_np(c2), np.asarray(p2))
    cand, targ, _ = jint._gather_cand_targ(
        *map(jnp.asarray, map(_np, ops[:5])), d_cand=d_cand, d_targ=d_targ,
        need_targ=True)
    ph = np.asarray(intersect_pallas_hits(cand, targ, block_q=16,
                                          block_d=128, interpret=True))
    ls = _np(ops[2].clamp(0, d_cand))
    dense = np.zeros((len(ls), d_cand), bool)
    dense[np.arange(d_cand)[None, :] < ls[:, None]] = _np(hits)
    np.testing.assert_array_equal(dense, ph.astype(bool))


def test_kernel_constants_match_the_wrapper():
    """The layout's item rows and the emulation's bitmap words are the
    CUDA source's ``kItemRows`` and ``kBitmapWords``."""
    import re
    from pathlib import Path

    src = (Path(tkern.__file__).parent / "csrc" / "intersect.cu").read_text()
    got = {k: int(v) for k, v in
           re.findall(r"constexpr int (kItemRows|kBitmapWords) = (\d+);", src)}
    assert got == {"kItemRows": tkern.ITEM_ROWS,
                   "kBitmapWords": tkern.BITMAP_WORDS}


def test_wrapper_refuses_an_unknown_path():
    ops = [_t(x) for x in _csr_operands(np.random.default_rng(1), 8, 16)]
    with pytest.raises(ValueError, match="path must be"):
        tkern.intersect_levels(*ops, d_cand=16, d_targ=16, path="tiles")
    with pytest.raises(ValueError, match="path must be"):
        tkern.intersect_hits(*ops[:5], d_cand=16, d_targ=16, path="tiles")


# ------------------------------------------------ K3's walk and layout


def _tile_operands(rng, *, q, n_short, short_len, hub_len, id_hi,
                   hub_rows, long_rows, long_len=16384):
    """K3's operands with every case its walk meets: ``n_short`` sorted
    lists of up to ``short_len`` ids (one led by negative ids, one
    holding sentinel ids past ``id_hi``, one empty), a hub target of
    ``hub_len`` ids and a long candidate list of ``long_len``; ``q``
    rows, ``hub_rows`` of them against the hub, ``long_rows`` of them
    the long list, about a tenth sentinel rows (l_s = l_l = 0)."""
    lists = [np.unique(rng.integers(0, id_hi, size=rng.integers(0,
                                                                short_len)))
             for _ in range(n_short)]
    lists[0] = np.r_[-9, -1, lists[0]]
    lists[1] = np.unique(np.r_[lists[1], id_hi, id_hi + 7])
    lists[2] = lists[2][:0]
    lists.append(np.unique(rng.integers(0, id_hi, size=hub_len)))
    lists.append(np.unique(rng.integers(0, id_hi, size=long_len)))
    flat = np.concatenate(lists).astype(np.int32)
    starts = np.cumsum([0] + [len(x) for x in lists[:-1]]).astype(np.int32)
    lens = np.array([len(x) for x in lists], np.int32)
    u = rng.integers(0, n_short, size=q)
    w = rng.integers(0, n_short, size=q)
    w[rng.permutation(q)[:hub_rows]] = n_short
    u[rng.permutation(q)[:long_rows]] = n_short + 1
    ls, ll = lens[u], lens[w]
    dead = rng.random(q) < 0.1
    ls[dead] = 0
    ll[dead] = 0
    return [_t(x) for x in (flat, starts[u], ls, starts[w], ll)]


TILE_CASES = {
    # (q, n_short, short_len, hub_len, id_hi, hub_rows, long_rows,
    #  d_cand, d_targ)
    "probe_like": (300, 60, 400, 3000, 20000, 120, 1, 16384, 4096),
    "clamped": (400, 40, 300, 5000, 8000, 150, 2, 100, 1500),
    "narrow_rows": (600, 80, 9, 2000, 4000, 200, 0, 32, 2048),
}


@pytest.mark.parametrize("tile", [tkern.COUNT_TILE, 64, 32],
                         ids=["kernel", "t64", "t32"])
@pytest.mark.parametrize("case", sorted(TILE_CASES))
def test_count_tiles_ref_matches_plain(case, tile):
    """K3's walk, tiles of cells over the rows' running sum, equals the
    plain count row for row: negative and sentinel candidates, empty
    and sentinel rows, clamped widths, one 16,384-candidate row among
    short ones and a hub target shared by many rows; tiles inside one row
    (searching a slice of the target) and tiles of many rows."""
    q, ns, sl, hl, hi, hub, lr, d_cand, d_targ = TILE_CASES[case]
    ops = _tile_operands(np.random.default_rng(len(case) + tile), q=q,
                         n_short=ns, short_len=sl, hub_len=hl, id_hi=hi,
                         hub_rows=hub, long_rows=lr)
    kw = dict(d_cand=d_cand, d_targ=d_targ)
    got, stats = count_tiles_ref(*ops, tile=tile, **kw)
    want = intersect_count_ref(*ops, **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), _np(want))
    assert int(want.sum()) > 0
    assert stats["tiles"] > stats["one_row_tiles"]  # tiles of many rows
    if case == "probe_like":
        # tiles inside the long row, each searching a slice of the hub
        assert 0 < stats["narrowed_tiles"] <= stats["one_row_tiles"]


def _delta_probe_operands(edges, n, *, seed, k=600):
    """The ``(flat, s_s, l_s, s_l, l_l, d_cand, d_targ)`` of every
    level-free probe chunk a stream session runs for one mixed apply of
    ``k`` updates on ``(edges, n)``, built as ``probe_sum`` builds them
    (recorded at ``core.intersect._count_chunk``)."""
    from repro_torch.api import TCOptions, TriangleEngine

    sess = TriangleEngine(device=CPU).stream(
        (edges, n), options=TCOptions(stream_staleness=1e9))
    rng = np.random.default_rng(seed)
    cur = sess.state.edges()
    dels = cur[rng.choice(cur.shape[0], k // 2, replace=False)]
    ins = rng.integers(0, n, size=(k - k // 2, 2))
    ops = np.r_[-np.ones(k // 2, np.int8), np.ones(k - k // 2, np.int8)]
    real, calls = tint._count_chunk, []

    def record(adj, qu, qw, bounds, base, count, *, d_cand, d_targ, level,
               **kw):
        if level is None:
            o = tint.probe_operands(adj, qu, qw, bounds, base, count, None)
            calls.append((adj.flat, *o[:4], d_cand, d_targ))
        return real(adj, qu, qw, bounds, base, count, d_cand=d_cand,
                    d_targ=d_targ, level=level, **kw)

    tint._count_chunk = record
    try:
        sess.apply((ops, np.r_[dels, ins]))
    finally:
        tint._count_chunk = real
    return calls


def test_count_tiles_ref_matches_plain_on_rmat12_delta_probes():
    """The stream's own delta probes at RMAT scale 12 (six a mixed
    apply: three per phase), tiled at the kernel's size and at a small
    one: every row equal to the plain count."""
    calls = _delta_probe_operands(*gen.rmat(12, 16, seed=0), seed=4)
    assert len(calls) == 6
    for flat, s_s, l_s, s_l, l_l, d_cand, d_targ in calls:
        kw = dict(d_cand=d_cand, d_targ=d_targ)
        want = intersect_count_ref(flat, s_s, l_s, s_l, l_l, **kw)
        for tile in (tkern.COUNT_TILE, 32):
            got, _ = count_tiles_ref(flat, s_s, l_s, s_l, l_l, tile=tile,
                                     **kw)
            np.testing.assert_array_equal(_np(got), _np(want))
    assert any(int(c[2].clamp(0, c[5]).sum()) > 1024 for c in calls)


@pytest.mark.parametrize("q,d,bq,bd", SWEEP)
def test_count_tiles_ref_matches_pallas_count(q, d, bq, bd):
    """K3's walk against the reference's count kernel in interpret mode
    on the dense blocks its engine gathers from the same bounds."""
    rng = np.random.default_rng(q + 5 * d)
    ops = _csr_operands(rng, q, d)
    d_targ = max(1, int(ops[4].max()))
    cp = _pallas_count_on_dense(ops, d_cand=d, d_targ=d_targ, bq=bq, bd=bd)
    for tile in (tkern.COUNT_TILE, 32):
        got, _ = count_tiles_ref(*map(_t, ops[:5]), d_cand=d, d_targ=d_targ,
                                 tile=tile)
        np.testing.assert_array_equal(_np(got), np.asarray(cp))


@pytest.mark.parametrize("case", sorted(TILE_CASES))
def test_item_walk_row_sums_match_count_on_k3_layout(case, monkeypatch):
    """The bitmap items on K3's layout (its own row threshold): each
    row's hits summed equal the plain count."""
    monkeypatch.setattr(tkern, "ITEM_CELLS", 512)
    monkeypatch.setattr(tkern, "COUNT_BITMAP_MIN_ROWS", 100)
    q, ns, sl, hl, hi, hub, lr, d_cand, d_targ = TILE_CASES[case]
    ops = _tile_operands(np.random.default_rng(7 * len(case)), q=q,
                         n_short=ns, short_len=sl, hub_len=hl, id_hi=hi,
                         hub_rows=hub, long_rows=lr)
    kw = dict(d_cand=d_cand, d_targ=d_targ)
    lay = tkern.item_layout(*ops[1:5], min_rows=tkern.COUNT_BITMAP_MIN_ROWS,
                            **kw)
    assert (lay is None) == (d_cand <= tkern.WALK_MAX_CAND)
    if lay is None:
        lay = tkern.item_layout(*ops[1:5], path="bitmap", **kw)
    off, hits, c1, c2 = probe_items_ref(*ops, lay, bitmap_words=7, **kw)
    assert c1 is None and c2 is None
    row = torch.searchsorted(off[1:], torch.arange(hits.shape[0]),
                             right=True)
    sums = torch.zeros(q, dtype=torch.int32).index_add_(
        0, row, hits.to(torch.int32))
    np.testing.assert_array_equal(_np(sums),
                                  _np(intersect_count_ref(*ops, **kw)))


@pytest.mark.parametrize("q", [99, 100])
def test_count_layout_takes_its_own_row_threshold(q, monkeypatch):
    """``min_rows`` replaces ``BITMAP_MIN_ROWS`` in the rule by shape."""
    monkeypatch.setattr(tkern, "BITMAP_MIN_ROWS", 10)
    ops = _item_operands(np.random.default_rng(q), q=q, n_lists=10,
                         cand_len=40, targ_len=80, id_hi=500, hubs=1)
    kw = dict(d_cand=1024, d_targ=400)
    assert tkern.item_layout(*ops[1:5], **kw) is not None
    lay = tkern.item_layout(*ops[1:5], min_rows=100, **kw)
    assert (lay is None) == (q < 100)


def test_count_wrapper_takes_a_path_on_the_cpu():
    """``intersect_count(path=...)``: each path is the plain count on CPU
    tensors (no launch); an unknown path is refused."""
    ops = [_t(x) for x in _csr_operands(np.random.default_rng(2), 40, 60)]
    want = intersect_count_ref(*ops[:5], d_cand=60, d_targ=60)
    before = dict(tkern.LAUNCHES)
    for path in tkern.COUNT_PATHS:
        got = tkern.intersect_count(*ops[:5], d_cand=60, d_targ=60,
                                    path=path)
        np.testing.assert_array_equal(_np(got), _np(want))
    assert tkern.LAUNCHES == before
    with pytest.raises(ValueError, match="path must be"):
        tkern.intersect_count(*ops[:5], d_cand=60, d_targ=60, path="rows")


@pytest.mark.parametrize("q,d_cand,want", [
    (2048, 256, "walk"), (10**7, 256, "walk"), (2048, 257, "tiles"),
    (2048, 16384, "tiles"), (32768, 16384, "tiles"),
    (65536, 16384, "bitmap"), (2_921_472, 32768, "bitmap")])
def test_count_path_by_shape(q, d_cand, want):
    """K3's rule: the warp per row up to ``WALK_MAX_CAND``, the bitmap
    from ``COUNT_BITMAP_MIN_ROWS`` rows, the tiles between (the stream
    probes' shapes at RMAT scale 20); a forced path is kept, and the
    rule agrees with K3's ``item_layout``."""
    assert tkern.count_path(q, d_cand) == want
    assert tkern.count_path(q, d_cand, "tiles") == "tiles"
    with pytest.raises(ValueError, match="path must be"):
        tkern.count_path(q, d_cand, "rows")
    assert (want == "bitmap") == (
        d_cand > tkern.WALK_MAX_CAND
        and q >= tkern.COUNT_BITMAP_MIN_ROWS)


def test_count_constants_match_the_kernel():
    """K3's tile and scan block are the CUDA source's ``kTile`` (``kWarp
    * kTileLane``) and ``kScanRows`` (``kScanThreads * kScanPer``)."""
    import re
    from pathlib import Path

    src = (Path(tkern.__file__).parent / "csrc" / "intersect.cu").read_text()
    got = {k: int(v) for k, v in re.findall(
        r"constexpr int (kWarp|kTileLane|kScanThreads|kScanPer) = (\d+);",
        src)}
    assert got["kWarp"] * got["kTileLane"] == tkern.COUNT_TILE
    assert got["kScanThreads"] * got["kScanPer"] == tkern.COUNT_SCAN_ROWS


# ------------------------------------------ kernels/intersect/ops.py


def _karate_queries(xp, csr, bfs, edges_mod):
    """The karate graph's horizontal-edge queries in one package's terms:
    ``(g, qu, qw, level, d_max)``."""
    edges, n = gen.karate()
    g = (csr.from_edges(edges, n) if xp is jnp
         else csr.from_edges(edges, n, device=CPU))
    level = bfs.bfs_levels(g.src, g.dst, n, row_offsets=g.row_offsets)
    h = edges_mod.horizontal_mask(g.src, g.dst, level, n)
    eu, ew, und = csr.undirected_edges(g)
    use = und & h
    return g, xp.where(use, eu, n), xp.where(use, ew, n), level, \
        csr.max_degree(g)


def test_ops_end_to_end_triangle_count_karate():
    """``horizontal_edge_counts`` per edge equal to the reference's on the
    same graph (its kernel in interpret mode and its jnp oracle), and the
    count T = c1 + c2 // 3 = 45 (the reference's
    ``test_end_to_end_triangle_count_karate``)."""
    from repro.kernels.intersect.ops import (
        gather_query_blocks as j_gather,
        horizontal_edge_counts as j_counts,
    )
    from repro_torch.kernels.intersect.ops import (
        gather_query_blocks,
        horizontal_edge_counts,
    )

    jg, jqu, jqw, jl, d_max = _karate_queries(jnp, jcsr, jbfs, jedges)
    tg, tqu, tqw, tl, t_max = _karate_queries(torch, tcsr, tbfs, tedges)
    assert d_max == t_max
    c1, c2 = horizontal_edge_counts(tg, tqu, tqw, tl, d_max=t_max)
    assert c1.dtype == c2.dtype == torch.int32
    assert int(c1.sum() + c2.sum() // 3) == 45
    for use_pallas in (True, False):
        j1, j2 = j_counts(jg, jqu, jqw, jl, d_max=d_max,
                          use_pallas=use_pallas, interpret=True)
        np.testing.assert_array_equal(_np(c1), np.asarray(j1))
        np.testing.assert_array_equal(_np(c2), np.asarray(j2))
    for got, want in zip(
            gather_query_blocks(tg, tqu, tqw, tl, d_cand=8, d_targ=12),
            j_gather(jg, jqu, jqw, jl, d_cand=8, d_targ=12)):
        np.testing.assert_array_equal(_np(got), np.asarray(want))
