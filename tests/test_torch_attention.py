"""The port's plain attention (K5's plain version) held against the JAX
package: ``attention_ref`` and the Pallas ``flash_attention`` in interpret
mode, over the reference's mask and shape sweep, bf16, and the decode
form the transformer uses.  Also the wrapper's checks: what the kernel
takes, and that a CPU tensor runs the plain version without a launch.
K5's redesign: the decode split planner, the split-then-combine order in
plain PyTorch (``attention_split_ref``) against ``attention_ref`` and the
JAX package at decode shapes (T = 2,048, a window that starts inside a
split, empty splits, a position on a split boundary), and the 3xTF32
split of the prefill's products emulated in float32 at D = 64 and 256.
Inputs are numpy arrays made from a seed."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash_attention import (
    flash_attention as j_flash,
)
from repro.kernels.flash_attention.ref import attention_ref as j_ref
from repro_torch.kernels.flash_attention import flash_attention as tkern
from repro_torch.kernels.flash_attention import ops as tops
from repro_torch.kernels.flash_attention.ref import (
    attention_ref,
    attention_split_ref,
)

torch.set_num_threads(1)

# (b, hq, hkv, s, t, d, causal, window, kv_offset): the reference's own
# sweep (tests/test_kernel_flash_attention.py)
CASES = [
    (2, 4, 2, 256, 256, 64, True, None, 0),     # GQA causal
    (1, 4, 1, 200, 200, 64, True, 96, 0),       # MQA sliding window
    (1, 2, 2, 128, 384, 32, True, None, 256),   # chunked prefill
    (1, 8, 8, 130, 130, 64, False, None, 0),    # bidirectional, ragged
    (1, 1, 1, 1, 512, 128, True, None, 511),    # decode step (q_len=1)
    (1, 3, 3, 64, 64, 128, True, 17, 0),        # odd heads, tiny window
]
IDS = ["gqa", "mqa-window", "chunked-prefill", "bidirectional", "decode",
       "tiny-window"]

# float32: the reference kernel tests' tolerance (sums in another order);
# bf16: theirs too (one bf16 rounding of the output, 2^-8 relative)
F32_TOL = 2e-5
BF16_TOL = 2e-2


def _operands(case, dtype=np.float32):
    b, hq, hkv, s, t, d = case[:6]
    rng = np.random.default_rng(s * 7 + t)
    return tuple(rng.standard_normal(shape).astype(np.float32).astype(dtype)
                 for shape in ((b, hq, s, d), (b, hkv, t, d), (b, hkv, t, d)))


def _kw(case):
    return dict(causal=case[6], window=case[7], kv_offset=case[8])


def _port(q, k, v, **kw):
    return attention_ref(*(torch.from_numpy(x) for x in (q, k, v)), **kw)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_matches_reference_ref(case):
    q, k, v = _operands(case)
    got = _port(q, k, v, **_kw(case))
    want = j_ref(*(jnp.asarray(x) for x in (q, k, v)), **_kw(case))
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_matches_reference_flash_kernel(case):
    q, k, v = _operands(case)
    got = _port(q, k, v, **_kw(case))
    want = j_flash(*(jnp.asarray(x) for x in (q, k, v)), interpret=True,
                   **_kw(case))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("oracle", ["ref", "flash"])
def test_bf16(oracle):
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((1, 2, 128, 64)).astype(np.float32)
               for _ in range(3))
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = attention_ref(tq, tk, tv, causal=True)
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    fn = j_ref if oracle == "ref" else j_flash
    want = fn(jq, jk, jv, causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, dtype=np.float32),
                               rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("index,window", [(0, None), (7, None), (40, 5),
                                          (63, 16)])
def test_decode_form(index, window):
    """The transformer's decode call: one query row per head at position
    ``index`` over a zero-padded cache (GQA 9:3, as smollm-135m)."""
    rng = np.random.default_rng(index)
    q = rng.standard_normal((2, 9, 1, 64)).astype(np.float32)
    k, v = (rng.standard_normal((2, 3, 64, 64)).astype(np.float32)
            for _ in range(2))
    k[:, :, index + 1:] = 0
    v[:, :, index + 1:] = 0
    kw = dict(causal=True, window=window, kv_offset=index)
    got = _port(q, k, v, **kw)
    want = j_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=F32_TOL, atol=F32_TOL)


def test_strided_views_equal_contiguous():
    """[B, H, S, D] views of [B, S, H, D] tensors, as the transformer
    passes them, give the contiguous operands' result bit for bit."""
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((2, 16, 6, 32)).astype(
        np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 24, 2, 32)).astype(
        np.float32)) for _ in range(2))
    views = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    got = attention_ref(*views, window=7, kv_offset=8)
    want = attention_ref(*(x.contiguous() for x in views), window=7,
                         kv_offset=8)
    assert torch.equal(got, want)


def test_cpu_tensor_runs_plain_version_without_launch():
    q, k, v = (torch.from_numpy(x) for x in _operands(CASES[0]))
    before = dict(tkern.LAUNCHES)
    got = tops.attention(q, k, v, window=40, kv_offset=0)
    assert torch.equal(got, attention_ref(q, k, v, window=40, kv_offset=0))
    assert tkern.LAUNCHES == before


def test_cpu_tensor_of_any_head_width_runs_plain_version():
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 8, 96)).astype(
        np.float32)) for _ in range(3))
    assert torch.equal(tkern.flash_attention(q, k, v), attention_ref(q, k, v))


@pytest.mark.parametrize("d", tkern.HEAD_DIMS)
def test_kernel_takes_its_head_widths(d):
    q = torch.zeros((1, 4, 3, d))
    k = torch.zeros((1, 2, 5, d))
    tkern.check_kernel_operands(q, k, k)
    tkern.check_kernel_operands(q.bfloat16(), k.bfloat16(), k.bfloat16())


@pytest.mark.parametrize("d,dtype", [(96, torch.float32), (24, torch.float32),
                                     (512, torch.float32),
                                     (64, torch.float16)])
def test_kernel_refuses_what_it_was_not_built_for(d, dtype):
    q = torch.zeros((1, 4, 3, d), dtype=dtype)
    k = torch.zeros((1, 2, 5, d), dtype=dtype)
    with pytest.raises((ValueError, TypeError)):
        tkern.check_kernel_operands(q, k, k)


@pytest.mark.parametrize("shapes,kw", [
    (((1, 4, 3, 32), (1, 3, 5, 32), (1, 3, 5, 32)), {}),    # 4 % 3 heads
    (((1, 4, 3, 32), (1, 2, 5, 32), (1, 2, 6, 32)), {}),    # k != v
    (((1, 4, 3, 32), (2, 2, 5, 32), (2, 2, 5, 32)), {}),    # batch
    (((1, 4, 3, 32), (1, 2, 5, 16), (1, 2, 5, 16)), {}),    # head width
    (((4, 3, 32), (1, 2, 5, 32), (1, 2, 5, 32)), {}),       # 3-D q
    (((1, 4, 3, 32), (1, 2, 5, 32), (1, 2, 5, 32)), {"window": 0}),
])
def test_wrapper_rejects_bad_operands(shapes, kw):
    q, k, v = (torch.zeros(s) for s in shapes)
    with pytest.raises(ValueError):
        tkern.flash_attention(q, k, v, **kw)


def test_wrapper_rejects_mixed_dtypes():
    q = torch.zeros((1, 2, 3, 32))
    k = torch.zeros((1, 2, 5, 32), dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        tkern.flash_attention(q, k, k)


# ------------------------------------------------ K5's split decode order

def _live(t, off, window):
    lo = max(0, off - window + 1) if window else 0
    return lo, min(t, off + 1)


@pytest.mark.parametrize("t,off,window,units,d", [
    (2048, 2046, None, 24, 64),    # the long serve's decode: 8 x 3 blocks
    (2048, 1920, None, 24, 64),    # its first step
    (48, 37, None, 12, 64),        # the default request: one tile
    (2048, 2000, 512, 2, 256),     # gemma3-1b local layer
    (2048, 2047, None, 2, 256),    # gemma3-1b global layer
    (70, 69, 16, 2, 48),           # gemma3-1b smoke
    (512, 511, None, 1, 128),      # the reference's decode case
    (300, 0, None, 4, 32),         # the first position: one key
    (64, 63, None, 8, 16),         # qwen2-moe smoke
])
def test_decode_split_plan(t, off, window, units, d):
    start, length, count = tkern.decode_splits(
        t, off, causal=True, window=window, units=units, d=d)
    tile = tkern.DECODE_TILE_KEYS[d]
    lo, hi = _live(t, off, window)
    assert start % tile == 0 and length % tile == 0 and count >= 1
    # the splits cover the live keys, and none of them is empty
    assert start <= lo < start + length
    assert start + (count - 1) * length < hi <= start + count * length
    tiles = -(-(hi - start) // tile)
    # enough splits to fill the card, where the keys allow
    assert units * count >= tkern.DECODE_TARGET_BLOCKS or count == tiles
    if (t, units) == (2048, 24):
        assert 6 <= count <= 12


def test_decode_split_plan_of_an_empty_range():
    # position past the cache and its window: no live key, one split
    assert tkern.decode_splits(100, 700, causal=True, window=512, units=3,
                               d=64) == (0, 64, 1)


def _decode_operands(b, hq, hkv, t, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, hq, 1, d), (b, hkv, t, d), (b, hkv, t, d)))


def _close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert (np.abs(got - want) <= F32_TOL * (1 + np.abs(want))).all(), \
        float(np.abs(got - want).max())


# (b, hq, hkv, t, d, window, kv_offset, splits or None for the planner's)
SPLIT_CASES = {
    "t2048": (2, 9, 3, 2048, 64, None, 2046, None),
    "window-inside-a-split": (1, 4, 1, 2048, 256, 512, 2000, (1024, 384, 3)),
    "planned-window": (1, 4, 1, 2048, 256, 512, 2000, None),
    "empty-splits": (1, 3, 1, 1024, 64, 200, 600, (0, 128, 8)),
    "offset-on-a-boundary": (1, 2, 2, 640, 32, None, 256, (0, 128, 5)),
    "offset-before-a-boundary": (1, 2, 2, 640, 32, None, 255, (0, 128, 5)),
}


@pytest.mark.parametrize("name", list(SPLIT_CASES))
def test_split_then_combine_matches_reference(name):
    b, hq, hkv, t, d, window, off, splits = SPLIT_CASES[name]
    q, k, v = _decode_operands(b, hq, hkv, t, d, seed=t + off)
    if splits is None:
        splits = tkern.decode_splits(t, off, causal=True, window=window,
                                     units=b * hkv, d=d)
    start, length, count = splits
    lo, hi = _live(t, off, window)
    edges = [start + i * length for i in range(count + 1)]
    if name == "window-inside-a-split":
        assert any(a < lo < z for a, z in zip(edges, edges[1:]))
    if name == "empty-splits":  # before the window and past the frontier
        assert sum(z <= lo or a >= hi for a, z in zip(edges, edges[1:])) >= 2
    if name == "offset-on-a-boundary":
        assert off in edges
    kw = dict(causal=True, window=window, kv_offset=off)
    got = attention_split_ref(*(torch.from_numpy(x) for x in (q, k, v)),
                              splits=splits, **kw).numpy()
    _close(got, _port(q, k, v, **kw).numpy())
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    _close(got, j_ref(jq, jk, jv, **kw))
    if b * hq * t <= 8192:  # the Pallas kernel in interpret mode
        _close(got, j_flash(jq, jk, jv, interpret=True, **kw))


def test_split_then_combine_of_no_live_key_is_zero():
    q, k, v = (torch.from_numpy(x)
               for x in _decode_operands(1, 2, 1, 100, 64, seed=1))
    splits = tkern.decode_splits(100, 700, causal=True, window=512,
                                 units=1, d=64)
    got = attention_split_ref(q, k, v, splits=splits, window=512,
                              kv_offset=700)
    assert torch.equal(got, torch.zeros_like(got))


# -------------------------------------------- the prefill's 3xTF32 products

def _tf32(x: np.ndarray) -> np.ndarray:
    """``cvt.rna.tf32.f32``: float32 rounded to 10 mantissa bits, to
    nearest with ties away from zero."""
    bits = x.astype(np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _split(x: np.ndarray):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


@pytest.mark.parametrize("d", [64, 256])
def test_3xtf32_split_keeps_float32_accuracy(d):
    """q.k^T as a tensor-core prefill would form it in float32 accuracy:
    operands split into TF32 hi and lo, products lo.hi + hi.lo + hi.hi
    summed in float32 ("3xTF32").  Each product is within 2^-21 of the
    exact one (a float32 FMA's within 2^-24), a row of scores within ~2x
    the float32 FMA dot's error on these operands, and one TF32 product
    alone is ~2^-11 off.  The 8x coarser product is why K5's float32
    prefill stays on FMA: on the served model's larger activations the
    3xTF32 kernel missed the 2e-5 gate (PERF.md)."""
    rng = np.random.default_rng(d)
    q = rng.standard_normal((64, d)).astype(np.float32)
    k = rng.standard_normal((64, d)).astype(np.float32)
    exact = q.astype(np.float64) @ k.astype(np.float64).T
    qh, ql = _split(q)
    kh, kl = _split(k)
    # hi and lo are exact TF32 values and recover x to 2^-22
    assert np.array_equal(qh, _tf32(qh)) and np.array_equal(ql, _tf32(ql))
    assert np.abs(qh + ql - q).max() <= 2.0 ** -22 * np.abs(q).max()
    prod = (ql[:, None, :].astype(np.float64) * kh[None]
            + qh[:, None, :].astype(np.float64) * kl[None]
            + qh[:, None, :].astype(np.float64) * kh[None])
    terms = q[:, None, :].astype(np.float64) * k[None]
    assert (np.abs(prod - terms) <= 2.0 ** -21 * np.abs(terms)).all()
    three = prod.astype(np.float32).sum(-1, dtype=np.float32)
    fma = (q @ k.T).astype(np.float32)
    one = (qh[:, None, :].astype(np.float64) * kh[None]).astype(
        np.float32).sum(-1, dtype=np.float32)
    scale = np.abs(terms).sum(-1)
    err3 = np.abs(three - exact) / scale
    err_fma = np.abs(fma - exact) / scale
    err1 = np.abs(one - exact) / scale
    assert err3.max() <= 2 * err_fma.max() + 2.0 ** -22
    assert err1.max() > 16 * err3.max()
    # the softmax rows the kernel forms from them stay inside K5's gate
    s = three / np.sqrt(d)
    p = np.exp(s - s.max(-1, keepdims=True))
    want = np.exp(exact / np.sqrt(d) - (exact / np.sqrt(d)).max(
        -1, keepdims=True))
    assert np.abs(p / p.sum(-1, keepdims=True) - want / want.sum(
        -1, keepdims=True)).max() <= F32_TOL
