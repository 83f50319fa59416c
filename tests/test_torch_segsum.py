"""The port's segment sum (K4's plain version, through
``repro_torch.kernels.segsum.ops.segment_sum`` with a layout) held
against the reference's Pallas kernel in interpret mode
(``repro.kernels.segsum.ops.segment_sum(..., layout=build_layout(...),
interpret=True)``) and its ``segment_sum_ref``: the reference kernel
tests' sweep, the zipf-skewed hub case, bf16 messages and empty
segments; the port's ``SegsumLayout`` invariants; the autograd backward
against ``torch.autograd.gradcheck`` in float64 and against ``jax.grad``
of ``segment_sum_ref``; the backend rule.  K4's chunked design: the
layout's chunk tables (every valid edge in exactly one chunk piece, each
chunk's first segment, the crossing flags) and
``segment_sum_chunked_ref``, K4's chunk-then-carry order in plain
PyTorch, against ``segment_sum_ref`` and the Pallas kernel on RMAT and
zipf hubs, one segment owning every edge, every id dropped and F = 70.
Inputs are numpy arrays made from a seed.

Tolerances are the reference kernel tests' own: 1e-5 on the sweep,
1e-4 on the zipf case (sums of up to ~900 terms in another order) and
2e-2 for bf16 messages against float32 sums.  The chunked order is held
to K4's own gate, 1e-5 * (1 + S) with S the segment's sum of |msgs|
(float32 sums of ~10^3 terms in another order)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.segsum import ops as jops
from repro.kernels.segsum.ref import segment_sum_ref as j_ref
from repro_torch.kernels.segsum import ops as tops
from repro_torch.kernels.segsum import segsum as tkern
from repro_torch.graph import generators as tgen
from repro_torch.kernels.segsum.ref import (
    segment_sum_chunked_ref,
    segment_sum_ref,
)

torch.set_num_threads(1)


def _port(msgs: np.ndarray, seg: np.ndarray, n: int,
          dtype=torch.float32) -> np.ndarray:
    m = torch.from_numpy(msgs).to(dtype)
    s = torch.from_numpy(seg)
    lay = tops.build_layout(s, n)
    return tops.segment_sum(m, s, n, layout=lay).numpy()


def _pallas(msgs, seg, n, bn=128, be=256, dtype=jnp.float32) -> np.ndarray:
    lay = jops.build_layout(seg, n, block_n=bn, block_e=be)
    return np.asarray(jops.segment_sum(jnp.asarray(msgs, dtype), None, n,
                                       layout=lay, interpret=True))


# the reference kernel tests' sweep (tests/test_kernel_segsum.py)
@pytest.mark.parametrize("e,n,f,bn,be", [
    (1000, 300, 64, 128, 256),
    (64, 5, 8, 16, 32),
    (4096, 700, 128, 128, 256),
    (513, 129, 32, 64, 64),
    (2048, 64, 256, 128, 512),
])
def test_sweep_matches_pallas_and_ref(e, n, f, bn, be):
    rng = np.random.default_rng(e + n)
    seg = rng.integers(-1, n, size=e).astype(np.int32)
    msgs = rng.standard_normal((e, f)).astype(np.float32)
    got = _port(msgs, seg, n)
    assert got.dtype == np.float32 and got.shape == (n, f)
    np.testing.assert_allclose(got, _pallas(msgs, seg, n, bn, be),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        got, np.asarray(j_ref(jnp.asarray(msgs), jnp.asarray(seg), n)),
        rtol=1e-5, atol=1e-5)


def test_zipf_skewed_hubs():
    rng = np.random.default_rng(0)
    e, n, f = 5000, 257, 16
    # zipf-ish: most edges land on few segments (the GNN hub regime)
    seg = (rng.zipf(1.3, size=e) % n).astype(np.int32)
    msgs = rng.standard_normal((e, f)).astype(np.float32)
    got = _port(msgs, seg, n)
    assert np.bincount(seg, minlength=n).max() > 1000
    np.testing.assert_allclose(got, _pallas(msgs, seg, n, 64, 128),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        got, np.asarray(j_ref(jnp.asarray(msgs), jnp.asarray(seg), n)),
        rtol=1e-4, atol=1e-4)


def test_bf16_messages():
    rng = np.random.default_rng(1)
    e, n, f = 512, 100, 64
    seg = rng.integers(0, n, size=e).astype(np.int32)
    msgs = rng.standard_normal((e, f)).astype(np.float32)
    got = _port(msgs, seg, n, torch.bfloat16)
    assert got.dtype == np.float32
    np.testing.assert_allclose(
        got, np.asarray(j_ref(jnp.asarray(msgs), jnp.asarray(seg), n)),
        rtol=2e-2, atol=2e-2)
    # the same bf16 inputs, summed in float32 by both: one rounding apart
    np.testing.assert_allclose(
        got, _pallas(msgs, seg, n, dtype=jnp.bfloat16), rtol=1e-5,
        atol=1e-5)


def test_empty_segments_and_sentinels_are_zero():
    rng = np.random.default_rng(2)
    e, n, f = 300, 1000, 70
    # ids below 0, the sentinel n and beyond are dropped
    seg = rng.integers(-3, n // 4, size=e).astype(np.int32)
    seg[::7] = n
    seg[::11] = n + 5
    msgs = rng.standard_normal((e, f)).astype(np.float32)
    got = _port(msgs, seg, n)
    used = np.zeros(n, bool)
    used[seg[(seg >= 0) & (seg < n)]] = True
    assert (~used).sum() > n // 2
    assert not got[~used].any()
    np.testing.assert_allclose(got, _pallas(msgs, seg, n), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("e,n", [(0, 5), (7, 1), (50, 3), (400, 97)])
def test_layout_invariants(e, n):
    rng = np.random.default_rng(e * 31 + n)
    seg_np = rng.integers(-2, n + 2, size=e).astype(np.int32)
    lay = tops.build_layout(torch.from_numpy(seg_np), n)
    perm = lay.perm.numpy()
    offsets = lay.offsets.numpy()
    valid = (seg_np >= 0) & (seg_np < n)
    nv = int(valid.sum())
    assert lay.perm.dtype == lay.offsets.dtype == torch.int32
    assert offsets.shape == (n + 1,) and offsets[0] == 0
    assert offsets[-1] == nv
    np.testing.assert_array_equal(np.diff(offsets),
                                  np.bincount(seg_np[valid], minlength=n))
    # the valid ids, sorted by segment, stably; no dropped id among them
    owned = perm[:nv]
    assert valid[owned].all()
    np.testing.assert_array_equal(
        owned, np.argsort(np.where(valid, seg_np, n), kind="stable")[:nv])
    assert sorted(perm.tolist()) == list(range(e))
    np.testing.assert_array_equal(lay.valid.numpy(), valid)


def test_gradcheck_float64():
    rng = np.random.default_rng(3)
    e, n, f = 40, 9, 5
    seg = torch.from_numpy(rng.integers(-1, n + 1, size=e).astype(np.int32))
    msgs = torch.from_numpy(rng.standard_normal((e, f))).requires_grad_()
    lay = tops.build_layout(seg, n)
    assert torch.autograd.gradcheck(
        lambda m: tops.segment_sum(m, seg, n, layout=lay), (msgs,))


def test_backward_matches_jax_grad():
    rng = np.random.default_rng(4)
    e, n, f = 600, 77, 70
    seg = rng.integers(-1, n + 1, size=e).astype(np.int32)
    msgs = rng.standard_normal((e, f)).astype(np.float32)
    w = rng.standard_normal((n, f)).astype(np.float32)
    want = jax.grad(lambda m: jnp.sum(
        j_ref(m, jnp.asarray(seg), n) * w))(jnp.asarray(msgs))
    m = torch.from_numpy(msgs).requires_grad_()
    out = tops.segment_sum(m, torch.from_numpy(seg), n)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(m.grad.numpy(), np.asarray(want))


def test_ref_matches_jax_ref_on_float64():
    rng = np.random.default_rng(5)
    seg = rng.integers(-1, 30, size=200).astype(np.int32)
    msgs = rng.standard_normal((200, 3))
    got = segment_sum_ref(torch.from_numpy(msgs), torch.from_numpy(seg), 25)
    assert got.dtype == torch.float64
    want = j_ref(jnp.asarray(msgs, jnp.float32), jnp.asarray(seg), 25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_backend_rule_on_the_cpu():
    seg = torch.tensor([0, 2, 2, -1], dtype=torch.int32)
    msgs = torch.ones((4, 3))
    before = tkern.LAUNCHES["segment_sum"]
    auto = tops.segment_sum(msgs, seg, 3)
    plain = tops.segment_sum(msgs, seg, 3, backend="torch")
    assert torch.equal(auto, plain)
    assert auto[:, 0].tolist() == [1.0, 0.0, 2.0]
    assert tkern.LAUNCHES["segment_sum"] == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        tops.segment_sum(msgs, seg, 3, backend="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tkern.segment_sum_cuda(msgs, tops.build_layout(seg, 3))
    with pytest.raises(ValueError, match="backend"):
        tops.segment_sum(msgs, seg, 3, backend="pallas")
    with pytest.raises(ValueError, match="segments"):
        tops.segment_sum(msgs, seg, 4, layout=tops.build_layout(seg, 3))
    with pytest.raises(ValueError, match="rows"):
        tops.segment_sum(msgs[:3], None, 3, layout=tops.build_layout(seg, 3))


# ------------------------------------------------------ K4's chunked order

def _ids(kind: str, e: int, n: int, rng) -> np.ndarray:
    if kind == "zipf":
        return (rng.zipf(1.3, size=e) % n).astype(np.int32)
    if kind == "rmat":  # the destinations of an RMAT graph: hub segments
        edges, _ = tgen.rmat(10, 16, seed=0)
        return edges[:e, 1].astype(np.int32) % n
    if kind == "one":  # a single segment owns every edge
        return np.full(e, n // 2, np.int32)
    if kind == "dropped":
        return rng.choice(np.array([-1, n, n + 7], np.int32), size=e)
    return rng.integers(-2, n + 2, size=e).astype(np.int32)


def _pieces(lay) -> list[tuple[int, int, int, int]]:
    """K4's chunk pieces from the layout, in numpy: (chunk, segment, first
    position, end position) for every run of one valid segment inside one
    chunk."""
    seg = lay.sorted_seg.numpy()
    n = lay.num_segments
    out = []
    for c in range(lay.n_chunks):
        p = c * tkern.CHUNK
        end = min(p + tkern.CHUNK, len(seg))
        while p < end and seg[p] < n:
            q = p
            while q < end and seg[q] == seg[p]:
                q += 1
            out.append((c, int(seg[p]), p, q))
            p = q
    return out


CHUNK_CASES = [("zipf", 5000, 257, 16), ("rmat", 4000, 1024, 70),
               ("one", 2500, 9, 70), ("dropped", 300, 40, 70),
               ("uniform", 1000, 300, 64), ("uniform", 97, 1000, 70),
               ("uniform", 0, 5, 8)]


@pytest.mark.parametrize("kind,e,n,f", CHUNK_CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in CHUNK_CASES])
def test_chunk_tables(kind, e, n, f):
    rng = np.random.default_rng(e + n)
    seg_np = _ids(kind, e, n, rng)
    lay = tops.build_layout(torch.from_numpy(seg_np), n)
    offsets = lay.offsets.numpy()
    perm = lay.perm.numpy()
    valid = (seg_np >= 0) & (seg_np < n)
    assert lay.n_chunks == -(-e // tkern.CHUNK)
    assert lay.sorted_seg.dtype == torch.int32 and lay.kind.dtype == torch.int8
    np.testing.assert_array_equal(lay.sorted_seg.numpy(),
                                  np.where(valid, seg_np, n)[perm])
    # every valid edge lies in exactly one chunk piece, of its segment
    pieces = _pieces(lay)
    covered = np.zeros(e, np.int64)
    for c, s, a, b in pieces:
        assert a // tkern.CHUNK == (b - 1) // tkern.CHUNK == c
        assert (seg_np[perm[a:b]] == s).all()
        covered[perm[a:b]] += 1
    np.testing.assert_array_equal(covered, valid.astype(np.int64))
    # each chunk's first segment is a searchsorted of its start in offsets
    starts = np.arange(lay.n_chunks) * tkern.CHUNK
    first = np.searchsorted(offsets, starts, side="right") - 1
    owned = starts < offsets[-1]
    np.testing.assert_array_equal(lay.sorted_seg.numpy()[starts][owned],
                                  first[owned])
    # the crossing flags: a segment with pieces in more than one chunk
    chunks_of = np.zeros(n, np.int64)
    for _, s, _, _ in pieces:
        chunks_of[s] += 1
    want = np.where(chunks_of == 0, tkern.KIND_EMPTY,
                    np.where(chunks_of > 1, tkern.KIND_CROSSING,
                             tkern.KIND_INSIDE))
    np.testing.assert_array_equal(lay.kind.numpy(), want)
    # at most two crossing pieces per chunk: its first and its last run
    for c in range(lay.n_chunks):
        runs = [p for p in pieces if p[0] == c]
        assert all(want[s] != tkern.KIND_CROSSING for _, s, _, _ in
                   runs[1:-1])


def _within_scaled(got, want, msgs, seg, n):
    scale = 1 + np.asarray(j_ref(jnp.asarray(np.abs(msgs)), jnp.asarray(seg),
                                 n))
    err = np.abs(got - want)
    assert (err <= 1e-5 * scale).all(), float((err / scale).max())


@pytest.mark.parametrize("kind,e,n,f", CHUNK_CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in CHUNK_CASES])
def test_chunked_order_matches_ref_and_pallas(kind, e, n, f):
    rng = np.random.default_rng(e * 3 + n)
    seg = _ids(kind, e, n, rng)
    msgs = rng.standard_normal((e, f)).astype(np.float32)
    lay = tops.build_layout(torch.from_numpy(seg), n)
    got = segment_sum_chunked_ref(torch.from_numpy(msgs), lay).numpy()
    assert got.dtype == np.float32 and got.shape == (n, f)
    want = segment_sum_ref(torch.from_numpy(msgs), torch.from_numpy(seg),
                           n).numpy()
    _within_scaled(got, want, msgs, seg, n)
    _within_scaled(got, np.asarray(j_ref(jnp.asarray(msgs), jnp.asarray(seg),
                                         n)), msgs, seg, n)
    valid = (seg >= 0) & (seg < n)
    if valid.any():  # with no valid id the Pallas grid has no tile step
        _within_scaled(got, _pallas(msgs, seg, n), msgs, seg, n)
    empty = np.bincount(seg[valid], minlength=n) == 0
    assert not got[empty].any()
    if kind == "rmat":  # the hub spans many chunks
        assert np.bincount(seg[valid]).max() > 8 * tkern.CHUNK


def test_chunked_order_is_a_fixed_order():
    """The same operands give the same bits; a segment inside one chunk
    is summed in position order, exactly as a float32 loop would."""
    rng = np.random.default_rng(11)
    seg = _ids("zipf", 3000, 200, rng)
    msgs = torch.from_numpy(rng.standard_normal((3000, 70)).astype(
        np.float32))
    lay = tops.build_layout(torch.from_numpy(seg), 200)
    got = segment_sum_chunked_ref(msgs, lay)
    assert torch.equal(got, segment_sum_chunked_ref(msgs, lay))
    inside = np.flatnonzero(lay.kind.numpy() == tkern.KIND_INSIDE)
    perm, offsets = lay.perm.numpy(), lay.offsets.numpy()
    for s in inside[:20]:
        acc = np.zeros(70, np.float32)
        for p in range(offsets[s], offsets[s + 1]):
            acc = acc + msgs.numpy()[perm[p]]
        np.testing.assert_array_equal(got[s].numpy(), acc)
