"""The port's plain attention (K5's plain version) held against the JAX
package: ``attention_ref`` and the Pallas ``flash_attention`` in interpret
mode, over the reference's mask and shape sweep, bf16, and the decode
form the transformer uses.  Also the wrapper's checks: what the kernel
takes, and that a CPU tensor runs the plain version without a launch.
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
from repro_torch.kernels.flash_attention.ref import attention_ref

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


@pytest.mark.parametrize("d,dtype", [(96, torch.float32), (16, torch.float32),
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
