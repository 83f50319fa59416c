"""K5's gradient held against the reference on the CPU: the port's
``FlashAttention`` (its backward the plain
``ref.attention_bwd_ref``, FlashAttention-2's backward from the
forward's output and log-sum-exp) against ``jax.vjp`` of
``repro.kernels.flash_attention.ref.attention_ref`` and of
``repro.models.transformer._attend`` (the reference's training
attention, which XLA differentiates), on the same numpy inputs made from
a seed: causal with and without a window, GQA 3:1 and 4:1, D 32, 48 and
64.  Also the plain backward against torch's autograd through the plain
forward in float64, the forward's log-sum-exp, and when the output
carries a ``grad_fn``."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref as jax_attention
from repro.models.transformer import _attend
from repro_torch.kernels.flash_attention import flash_attention as tkern
from repro_torch.kernels.flash_attention.ops import attention
from repro_torch.kernels.flash_attention.ref import (
    attention_bwd_ref,
    attention_ref,
)

torch.set_num_threads(1)

# float32: the port's backward (D = rowsum(dO * O), P from the saved
# log-sum-exp) sums in another order than XLA's autodiff of the softmax;
# |port - ref| <= TOL * (1 + |ref|).  The largest gap seen here is
# 1.45e-6 (against attention_ref's vjp).
TOL = 2e-5
# float64: the plain backward against torch's autograd of the plain
# forward, the same function in another order of operations
TOL64 = 1e-10

B, S = 2, 24
HEADS = {"gqa3": (6, 2), "gqa4": (8, 2)}
MASKS = {"causal": (True, None), "causal_window7": (True, 7)}


def _inputs(hq, hkv, d, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, hq, S, d)).astype(dtype)
    k = rng.standard_normal((B, hkv, S, d)).astype(dtype)
    v = rng.standard_normal((B, hkv, S, d)).astype(dtype)
    do = rng.standard_normal((B, hq, S, d)).astype(dtype)
    return q, k, v, do


def _port_grads(q, k, v, do, causal, window):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = attention(qt, kt, vt, causal=causal, window=window)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(do))
    return out.detach().numpy(), [x.grad.numpy() for x in (qt, kt, vt)]


def _close(got, want, tol):
    gap = np.abs(got - want) / (1 + np.abs(want))
    assert gap.max() <= tol, gap.max()
    return float(gap.max())


@pytest.mark.parametrize("d", [32, 48, 64])
@pytest.mark.parametrize("heads", list(HEADS))
@pytest.mark.parametrize("mask", list(MASKS))
def test_grads_equal_vjp_of_reference_attention_ref(d, heads, mask):
    hq, hkv = HEADS[heads]
    causal, window = MASKS[mask]
    q, k, v, do = _inputs(hq, hkv, d)
    out, grads = _port_grads(q, k, v, do, causal, window)
    jout, vjp = jax.vjp(lambda a, b, c: jax_attention(
        a, b, c, causal=causal, window=window), q, k, v)
    _close(out, np.asarray(jout), TOL)
    for got, want in zip(grads, vjp(jnp.asarray(do))):
        _close(got, np.asarray(want), TOL)


@pytest.mark.parametrize("d", [32, 48, 64])
@pytest.mark.parametrize("heads", list(HEADS))
@pytest.mark.parametrize("mask", list(MASKS))
def test_grads_equal_vjp_of_reference_attend(d, heads, mask):
    """``_attend`` takes [B, S, H, D] operands and returns [B, S, Hq*D];
    its window is an int (>= T: every causal key)."""
    hq, hkv = HEADS[heads]
    causal, window = MASKS[mask]
    q, k, v, do = _inputs(hq, hkv, d, seed=1)
    _, grads = _port_grads(q, k, v, do, causal, window)

    def f(a, b, c):
        return _attend(a.transpose(0, 2, 1, 3), b.transpose(0, 2, 1, 3),
                       c.transpose(0, 2, 1, 3), kv_offset=0,
                       window=S if window is None else window)

    _, vjp = jax.vjp(f, q, k, v)
    ct = jnp.asarray(do).transpose(0, 2, 1, 3).reshape(B, S, hq * d)
    for got, want in zip(grads, vjp(ct)):
        _close(got, np.asarray(want), TOL)


@pytest.mark.parametrize("causal,window,hq,hkv,kv_offset", [
    (True, None, 6, 2, 0), (True, 5, 8, 2, 0), (False, None, 4, 4, 0),
    (False, 6, 6, 3, 0), (True, None, 4, 1, 3)])
def test_plain_backward_equals_autograd_in_float64(causal, window, hq, hkv,
                                                   kv_offset):
    rng = np.random.default_rng(2)
    s, t, d = 13, 16 if kv_offset else 13, 16
    q, k, v = (torch.from_numpy(rng.standard_normal(shape)).requires_grad_()
               for shape in ((2, hq, s, d), (2, hkv, t, d), (2, hkv, t, d)))
    kw = dict(causal=causal, window=window, kv_offset=kv_offset)
    out, lse = attention_ref(q, k, v, return_lse=True, **kw)
    assert out.dtype == lse.dtype == torch.float64
    do = torch.from_numpy(rng.standard_normal(out.shape))
    want = torch.autograd.grad(out, (q, k, v), do)
    got = attention_bwd_ref(q, k, v, out.detach(), do, lse.detach(), **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        torch.testing.assert_close(g, w, rtol=0, atol=TOL64)


def test_lse_is_the_rows_log_sum_exp():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(6, 2, 32))
    out, lse = attention_ref(q, k, v, window=7, return_lse=True)
    assert lse.shape == (B, 6, S) and lse.dtype == torch.float32
    kr = k.repeat_interleave(3, dim=1)
    logits = torch.einsum("bhsd,bhtd->bhst", q, kr) * 32 ** -0.5
    i, j = torch.arange(S)[:, None], torch.arange(S)[None, :]
    logits = logits.masked_fill(~((j <= i) & (i - j < 7)), float("-inf"))
    torch.testing.assert_close(lse, torch.logsumexp(logits, -1), rtol=0,
                               atol=1e-5)
    torch.testing.assert_close(out, attention_ref(q, k, v, window=7),
                               rtol=0, atol=0)


@pytest.mark.parametrize("which", ["q", "k", "v", "none"])
def test_output_has_grad_fn_when_an_input_requires_grad(which):
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(6, 2, 32))
    ts = {"q": q, "k": k, "v": v}
    if which != "none":
        ts[which].requires_grad_()
    out = tkern.flash_attention(ts["q"], ts["k"], ts["v"])
    assert (out.grad_fn is not None) == (which != "none")
    with torch.no_grad():
        assert tkern.flash_attention(ts["q"], ts["k"], ts["v"]).grad_fn is None
    if which != "none":
        out.sum().backward()
        assert ts[which].grad is not None and ts[which].grad.shape == \
            ts[which].shape


def test_cpu_backward_launches_no_kernel():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(8, 2, 48))
    before = dict(tkern.LAUNCHES)
    q.requires_grad_()
    tkern.flash_attention(q, k, v).backward(do)
    assert tkern.LAUNCHES == before
    assert set(before) == {"flash_attention", "flash_attention_bwd"}


def test_backward_operands_refuse_what_the_kernel_does_not_take():
    q = torch.zeros(1, 2, 4, 32)
    k = torch.zeros(1, 2, 6, 32)
    with pytest.raises(ValueError, match="S = T and kv_offset 0"):
        tkern.check_backward_operands(q, k, 0)
    with pytest.raises(ValueError, match="S = T and kv_offset 0"):
        tkern.check_backward_operands(q, q, 2)
    tkern.check_backward_operands(q, q, 0)
