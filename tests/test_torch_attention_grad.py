"""K5's gradient held against the reference on the CPU: the port's
``FlashAttention`` (its backward the plain
``ref.attention_bwd_ref``, FlashAttention-2's backward from the
forward's output and log-sum-exp) against ``jax.vjp`` of
``repro.kernels.flash_attention.ref.attention_ref`` and of
``repro.models.transformer._attend`` (the reference's training
attention, which XLA differentiates), on the same numpy inputs made from
a seed: causal with and without a window, GQA 3:1 and 4:1, D 32, 48 and
64.  Also the plain backward against torch's autograd through the plain
forward in float64, the forward's log-sum-exp, when the output carries
a ``grad_fn``, and an emulation of the bf16 kernel's tensor-core
rounding against float64 within the card tests' bf16 gate."""
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
    attention_mask,
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

# bf16: K5's backward on the card against float64 (the card tests' gate)
BF16_TOL = 2e-2

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


# the card tests' bf16 cases (tests/test_torch_cuda.py, BWD_CASES):
# (b, hq, hkv, s, d, causal, window)
BF16_CASES = [(2, 9, 3, 300, 64, True, None), (1, 4, 1, 257, 256, True, 40),
              (2, 6, 2, 130, 48, True, 17), (1, 2, 2, 96, 32, False, None),
              (1, 4, 4, 200, 128, False, 33), (2, 4, 2, 70, 16, True, 24)]


def _tensor_core_bwd(q, k, v, o, do, lse, causal, window):
    """K5's bf16 backward's arithmetic in plain PyTorch: products of bf16
    operands summed in float32, P and dS rounded to bf16 before they enter
    dV, dK and dQ, each gradient rounded to bf16 once.  The plain version
    rounds only its outputs, so it says nothing of the kernel's own
    rounding."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    rep = hq // hkv
    scale = d ** -0.5
    qf, kf, vf, of, dof = (x.float() for x in (q, k, v, o, do))
    kf, vf = (x.repeat_interleave(rep, dim=1) for x in (kf, vf))
    mask = attention_mask(s, s, causal=causal, window=window, kv_offset=0,
                          device=q.device)
    logits = torch.einsum("bhsd,bhtd->bhst", qf, kf) * scale
    p = torch.where(mask, torch.exp(logits - lse[..., None]), 0.0)
    delta = (dof * of).sum(-1, keepdim=True)
    ds = p * (torch.einsum("bhsd,bhtd->bhst", dof, vf) - delta)
    pb, dsb = (x.bfloat16().float() for x in (p, ds))
    dv = torch.einsum("bhst,bhsd->bhtd", pb, dof)
    dk = torch.einsum("bhst,bhsd->bhtd", dsb, qf)
    dq = torch.einsum("bhst,bhtd->bhsd", dsb, kf) * scale
    dk = dk.view(b, hkv, rep, s, d).sum(2) * scale
    dv = dv.view(b, hkv, rep, s, d).sum(2)
    return tuple(x.bfloat16() for x in (dq, dk, dv))


@pytest.mark.parametrize("case", BF16_CASES, ids=lambda c: "x".join(
    str(x) for x in c[:5]) + f"-{c[5]}-{c[6]}")
def test_tensor_core_rounding_is_within_the_bf16_gate(case):
    """The kernel's rounding, and the wrapper's plain version on bf16 CPU
    tensors, both within the card tests' bf16 gate of float64."""
    b, hq, hkv, s, d, causal, window = case
    rng = np.random.default_rng(3)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).bfloat16() for shape in (
            (b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d), (b, hq, s, d)))
    kw = dict(causal=causal, window=window)
    o, lse = attention_ref(q, k, v, return_lse=True, **kw)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    want = attention_bwd_ref(*(x.double() for x in (q, k, v, o, do)),
                             lse.double(), **kw)
    before = dict(tkern.LAUNCHES)
    plain = tkern.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    assert tkern.LAUNCHES == before
    emulated = _tensor_core_bwd(q, k, v, o, do, lse, causal, window)
    for got in (plain, emulated):
        for x, y in zip(got, want):
            assert x.dtype == torch.bfloat16 and x.shape == y.shape
            _close(x.double().numpy(), y.numpy(), BF16_TOL)


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
