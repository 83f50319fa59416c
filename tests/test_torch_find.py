"""Triangle finding in the port, held element for element against the JAX
package: the plain versions of K2 (dense ``hits_ref`` and CSR-bounds
``intersect_hits_ref``) against ``intersect_pallas_hits`` in interpret
mode, ``probe_block`` against the reference's, and
``TriangleEngine(device="cpu").find`` / ``find_triangles_dense`` against
``repro.api.TriangleEngine().find`` / ``find_triangles_dense`` — the
``tri`` array in order, pad rows included, and ``count``.  Inputs are
numpy arrays made from a seed; every comparison is exact."""
from __future__ import annotations

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.core import intersect as jint
from repro.core import sequential as jseq
from repro.graph import csr as jcsr
from repro.kernels.intersect.intersect import intersect_pallas_hits
from repro_torch import api as tapi
from repro_torch.core import intersect as tint
from repro_torch.core import sequential as tseq
from repro_torch.graph import csr as tcsr
from repro_torch.graph import generators as gen
from repro_torch.kernels.intersect import intersect as tkern
from repro_torch.kernels.intersect.ref import hits_ref, intersect_hits_ref

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.int32))


FIXTURES = {
    "karate": (gen.karate(), 45),
    "path": (gen.path(12), 0),
    "star": (gen.star(10), 0),
    "complete": (gen.complete(9), 84),
    "ring_of_cliques": (gen.ring_of_cliques(5, 6), 100),
    "dolphins_like": (gen.dolphins_like(), None),
    "rmat10": (gen.rmat(10, 16, seed=0), 75682),
}


# ------------------------------------------------ K2 plain versions (dense)

def _random_sorted_lists(rng, q, d, hi, pad=-1):
    out = np.full((q, d), pad, dtype=np.int32)
    for i in range(q):
        vals = np.unique(rng.integers(0, hi, size=rng.integers(0, d + 1)))
        out[i, : len(vals)] = vals
    return out


SWEEP = [
    (7, 17, 8, 128),      # sub-block ragged
    (64, 128, 32, 128),   # exact tiles
    (33, 260, 16, 128),   # multi-tile D with remainder
    (128, 64, 128, 64),   # small blocks
]


@pytest.mark.parametrize("q,d,bq,bd", SWEEP)
def test_hits_ref_matches_pallas(q, d, bq, bd):
    rng = np.random.default_rng(q * 1000 + d)
    cand = _random_sorted_lists(rng, q, d, 400)
    targ = _random_sorted_lists(rng, q, d, 400, pad=-2)
    jh = intersect_pallas_hits(jnp.asarray(cand), jnp.asarray(targ),
                               block_q=bq, block_d=bd, interpret=True)
    th = hits_ref(_t(cand), _t(targ))
    assert th.dtype == torch.bool
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))


# ------------------------------------------- K2 plain versions (CSR bounds)

def _csr_operands(rng, q, d, n=400):
    """Flat sorted adjacency of n vertices + q random query rows whose
    candidate/target slices are vertex lists of up to ``d`` entries."""
    lists = [np.unique(rng.integers(0, n, size=rng.integers(0, d + 1)))
             for _ in range(n)]
    flat = np.concatenate(lists).astype(np.int32)
    starts = np.cumsum([0] + [len(x) for x in lists[:-1]]).astype(np.int32)
    lens = np.array([len(x) for x in lists], np.int32)
    u = rng.integers(0, n, size=q)
    w = rng.integers(0, n, size=q)
    return flat, starts[u], lens[u], starts[w], lens[w]


def _dense(offsets, hits, l_s, d_cand):
    """The ragged mask scattered into ``bool[Q, d_cand]``."""
    q = offsets.shape[0] - 1
    out = np.zeros((q, d_cand), bool)
    off, h = offsets.numpy(), hits.numpy()
    for r in range(q):
        out[r, : off[r + 1] - off[r]] = h[off[r]:off[r + 1]]
    assert np.array_equal(np.diff(off), np.minimum(l_s, d_cand))
    return out


def _pallas_hits_on_dense(ops, *, d_cand, d_targ, bq, bd):
    """The reference kernel on the dense blocks its engine gathers from
    the same bounds (``_gather_cand_targ``)."""
    cand, targ, _ = jint._gather_cand_targ(
        *map(jnp.asarray, ops), d_cand=d_cand, d_targ=d_targ,
        need_targ=True)
    return np.asarray(intersect_pallas_hits(cand, targ, block_q=bq,
                                            block_d=bd, interpret=True))


@pytest.mark.parametrize("q,d,bq,bd", SWEEP)
def test_intersect_hits_ref_matches_pallas(q, d, bq, bd):
    rng = np.random.default_rng(q + d)
    ops = _csr_operands(rng, q, d)
    d_targ = int(max(ops[4].max(), 1))
    expect = _pallas_hits_on_dense(ops, d_cand=d, d_targ=d_targ, bq=bq,
                                   bd=bd)
    offsets, hits = intersect_hits_ref(*map(_t, ops), d_cand=d,
                                       d_targ=d_targ)
    assert offsets.dtype == torch.int64 and hits.dtype == torch.bool
    np.testing.assert_array_equal(_dense(offsets, hits, ops[2], d), expect)
    # the wrapper takes the plain version for CPU tensors, uncounted
    before = dict(tkern.LAUNCHES)
    ow, hw = tkern.intersect_hits(*map(_t, ops), d_cand=d, d_targ=d_targ)
    assert tkern.LAUNCHES == before
    assert torch.equal(ow, offsets) and torch.equal(hw, hits)


@pytest.mark.parametrize("d_cand,d_targ", [(16, 200), (64, 24), (8, 8)])
def test_intersect_hits_ref_clamps_like_the_dense_gather(d_cand, d_targ):
    # lists up to 100 long against widths that clamp them
    rng = np.random.default_rng(d_cand * d_targ + 1)
    ops = _csr_operands(rng, 48, 100, n=300)
    assert ops[2].max() > d_cand or ops[4].max() > d_targ
    expect = _pallas_hits_on_dense(ops, d_cand=d_cand, d_targ=d_targ,
                                   bq=16, bd=128)
    offsets, hits = intersect_hits_ref(*map(_t, ops), d_cand=d_cand,
                                       d_targ=d_targ)
    np.testing.assert_array_equal(_dense(offsets, hits, ops[2], d_cand),
                                  expect)


def test_hits_wrapper_rejects_operands_the_kernel_does_not_take():
    ops = [_t(x) for x in _csr_operands(np.random.default_rng(0), 8, 16)]
    with pytest.raises(TypeError, match="int32"):
        tkern.intersect_hits(ops[0].long(), *ops[1:], d_cand=16, d_targ=16)
    with pytest.raises(ValueError, match="rows"):
        tkern.intersect_hits(*ops[:4], ops[4][:3], d_cand=16, d_targ=16)
    with pytest.raises(ValueError, match="one device"):
        tkern.intersect_hits(ops[0].to("meta"), *ops[1:], d_cand=16,
                             d_targ=16)
    with pytest.raises(ValueError, match=">= 0"):
        tkern.intersect_hits(*ops, d_cand=16, d_targ=-1)
    offsets, hits = tkern.intersect_hits(*ops, d_cand=16, d_targ=16)
    plain = intersect_hits_ref(*ops, d_cand=16, d_targ=16)
    assert torch.equal(offsets, plain[0]) and torch.equal(hits, plain[1])


def test_cell_chunks_cover_the_rows_in_order(monkeypatch):
    l_s = _t(np.random.default_rng(5).integers(0, 40, size=300))
    assert tint.cell_chunks(l_s, d_cand=32) == [(0, 300)]
    monkeypatch.setattr(tint, "HIT_CELL_BUDGET", 100)
    chunks = tint.cell_chunks(l_s, d_cand=32)
    assert len(chunks) > 40
    assert chunks[0][0] == 0 and chunks[-1][1] == 300
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    cells = l_s.clamp(max=32)
    assert max(int(cells[a:b].sum()) for a, b in chunks) <= 100 + 32
    assert tint.cell_chunks(l_s[:0], d_cand=32) == []


# ------------------------------------------------------------ probe_block

def _queries(edges, n):
    """Every undirected edge of the graph as a query row (u < w)."""
    jg = jcsr.from_edges(edges, n)
    eu, ew, und = jcsr.undirected_edges(jg)
    qu = np.where(np.asarray(und), np.asarray(eu), n).astype(np.int32)
    qw = np.where(np.asarray(und), np.asarray(ew), n).astype(np.int32)
    return jg, qu, qw


@pytest.mark.parametrize("case,d_cand,d_targ,backend", [
    ("karate", 17, None, "jnp"),
    ("karate", 6, 9, "jnp"),          # clamped candidates, under-search
    ("rmat10", 64, 256, "jnp"),
    ("ring_of_cliques", 8, None, "pallas"),
])
def test_probe_block_matches_reference(case, d_cand, d_targ, backend):
    (edges, n), _ = FIXTURES[case]
    jg, qu, qw = _queries(edges, n)
    ja, jf = jint.probe_block(jg, jnp.asarray(qu), jnp.asarray(qw),
                              d_cand=d_cand, d_targ=d_targ,
                              backend=backend, interpret=True)
    tg = tcsr.from_edges(edges, n, device=CPU)
    ta, tf = tint.probe_block(tg, _t(qu), _t(qw), d_cand=d_cand,
                              d_targ=d_targ)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    pa, pf = tint.probe_common_neighbors(tg, _t(qu), _t(qw), d_max=d_cand,
                                         d_search=d_targ)
    assert torch.equal(pa, ta) and torch.equal(pf, tf)


# -------------------------------------------------------------------- find

def _finds(edges, n, max_triangles, jopts=None, topts=None):
    jt, jc = japi.TriangleEngine(jopts).find((edges, n),
                                             max_triangles=max_triangles)
    tt, tc = tapi.TriangleEngine(topts, device=CPU).find(
        (edges, n), max_triangles=max_triangles)
    return (np.asarray(jt), int(jc)), (tt, tc)


def _assert_finds_equal(j, t):
    (jt, jc), (tt, tc) = j, t
    assert tt.dtype == torch.int32 and tc.dtype == torch.int32
    assert tt.device.type == tc.device.type == "cpu"
    assert int(tc) == jc
    np.testing.assert_array_equal(tt.numpy(), jt)  # order and pad rows


@pytest.mark.parametrize("case", list(FIXTURES))
def test_find_matches_reference_jnp(case):
    (edges, n), expect = FIXTURES[case]
    budget = (expect or 200) + 7  # room to spare: pad rows are compared
    j, t = _finds(edges, n, budget, japi.TCOptions(backend="jnp"))
    _assert_finds_equal(j, t)
    if expect is not None:
        assert int(t[1]) == expect


@pytest.mark.parametrize("case", ["karate", "ring_of_cliques"])
def test_find_matches_reference_pallas_interpret(case):
    (edges, n), expect = FIXTURES[case]
    j, t = _finds(edges, n, expect + 3,
                  japi.TCOptions(backend="pallas", interpret=True))
    _assert_finds_equal(j, t)


@pytest.mark.parametrize("max_triangles", [1, 1000, 40000])
def test_find_buffer_smaller_than_count_matches_reference(max_triangles):
    (edges, n), expect = FIXTURES["rmat10"]
    j, t = _finds(edges, n, max_triangles, japi.TCOptions(backend="jnp"))
    _assert_finds_equal(j, t)
    assert int(t[1]) == expect > max_triangles
    assert (t[0] >= 0).all()


FIND_OPTIONS = {
    "query_chunk": dict(query_chunk=256),
    "bucket_widths": dict(bucket_widths=(8, 64, 512)),
    "d_max": dict(d_max=16),
    "root": dict(root=17),
}


@pytest.mark.parametrize("case", sorted(FIND_OPTIONS))
def test_find_options_match_reference(case):
    kw = FIND_OPTIONS[case]
    (edges, n), _ = FIXTURES["rmat10"]
    j, t = _finds(edges, n, 80000, japi.TCOptions(backend="jnp", **kw),
                  tapi.TCOptions(**kw))
    _assert_finds_equal(j, t)


def test_find_cap_h_warns_and_truncates_like_reference():
    (edges, n), expect = FIXTURES["rmat10"]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        j, t = _finds(edges, n, 80000,
                      japi.TCOptions(backend="jnp", cap_h=500),
                      tapi.TCOptions(cap_h=500))
    _assert_finds_equal(j, t)
    assert int(t[1]) < expect
    assert sum("cap_h=500 dropped" in str(w.message) for w in caught) == 2


@pytest.mark.parametrize("case,d_max", [
    ("karate", None), ("karate", 8), ("dolphins_like", None), ("rmat10", 8),
])
def test_find_triangles_dense_matches_reference(case, d_max):
    (edges, n), expect = FIXTURES[case]
    expect = expect or 200
    jg = jcsr.from_edges(edges, n)
    dm = d_max or jcsr.max_degree(jg)
    budget = expect + 5
    jt, jc = jseq.find_triangles_dense(jg, d_max=dm, max_triangles=budget)
    tt, tc = tseq.find_triangles_dense(tcsr.from_edges(edges, n, device=CPU),
                                       d_max=dm, max_triangles=budget)
    _assert_finds_equal((np.asarray(jt), int(jc)), (tt, tc))
    # and through the engine's compact=False escape hatch
    j, t = _finds(edges, n, budget, japi.TCOptions(compact=False,
                                                   d_max=d_max),
                  tapi.TCOptions(compact=False, d_max=d_max))
    _assert_finds_equal(j, t)


def test_find_is_unchanged_by_a_small_cell_budget(monkeypatch):
    (edges, n), expect = FIXTURES["rmat10"]
    eng = tapi.TriangleEngine(device=CPU)
    tri, cnt = eng.find((edges, n), max_triangles=expect)
    monkeypatch.setattr(tint, "HIT_CELL_BUDGET", 997)
    tri_c, cnt_c = eng.find((edges, n), max_triangles=expect)
    assert int(cnt_c) == int(cnt) == expect
    assert torch.equal(tri_c, tri)


def test_found_triangles_are_unique_and_closed():
    (edges, n), expect = FIXTURES["rmat10"]
    tri, cnt = tapi.TriangleEngine(device=CPU).find((edges, n),
                                                    max_triangles=expect)
    t = np.sort(tri.numpy().astype(np.int64), axis=1)
    keys = (t[:, 0] << 40) | (t[:, 1] << 20) | t[:, 2]
    assert np.unique(keys).shape[0] == expect == int(cnt)
    g = tcsr.from_edges(edges, n, device=CPU)
    slots = set((g.src.numpy().astype(np.int64) * n + g.dst.numpy()).tolist())
    for a, b in ((0, 1), (0, 2), (1, 2)):
        assert all(int(x) in slots for x in t[:, a] * n + t[:, b])


def test_stage_clock_splits_find():
    (edges, n), expect = FIXTURES["rmat10"]
    clock = tseq.StageClock(CPU)
    _, cnt = tapi.TriangleEngine(device=CPU).find(
        (edges, n), max_triangles=10, clock=clock)
    assert int(cnt) == expect
    assert set(clock.seconds) == {"csr", "bfs", "compact", "plan",
                                  "plan.host", "probe", "hit_list", "emit"}
    assert clock.counts["bfs_sweeps"] >= 2
