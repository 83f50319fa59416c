"""The port's segment ops (``repro_torch.graph.segment``) held against
``repro.graph.segment``: ``segment_max``, ``segment_mean`` and
``segment_softmax`` on the reference's own cases
(``tests/test_segment_ops.py``: empty segments, sentinel and negative
ids, int dtypes) and on seeded numpy inputs (multi-head scores, matrix
rows, all ``-inf`` segments), the softmax with and without a K4 layout
(its plain version on the CPU) and its gradient; the integer
``segment_sum`` of the triangle engine as it was.

Tolerances: max and mean of the same float32 operands are exact in both
packages (one comparison, or one sum of a few terms and one division,
in the same order); the softmax and its gradient in float32 through
``exp`` and sums in other orders: |port - ref| <= TOL * (1 + |ref|),
TOL = 1e-6."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graph import segment as jseg
from repro_torch.graph import segment as tseg
from repro_torch.kernels.segsum import segsum as tsegk
from repro_torch.kernels.segsum.ops import build_layout

torch.set_num_threads(1)

TOL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want)
    assert (err <= tol * (1 + np.abs(want))).all(), float(err.max())


# ------------------------------------------------ the reference's own cases

def test_segment_max_empty_segment_holds_identity():
    out = tseg.segment_max(_t([3.0, 7.0]).float(), _t([0, 0]), 2)
    assert float(out[0]) == 7.0
    assert np.isneginf(float(out[1]))  # empty float segment -> -inf
    out_i = tseg.segment_max(_t(np.array([3, 7], np.int32)), _t([0, 0]), 2)
    assert out_i.dtype == torch.int32
    assert int(out_i[1]) == np.iinfo(np.int32).min


def test_segment_mean_correct_means():
    out = tseg.segment_mean(_t([2.0, 4.0, 9.0]).float(), _t([0, 0, 1]), 2)
    np.testing.assert_allclose(out.numpy(), [3.0, 9.0])


def test_segment_mean_empty_segment_is_exactly_zero():
    got = tseg.segment_mean(_t([5.0, 7.0]).float(), _t([0, 0]), 3).numpy()
    assert got[0] == 6.0  # exact, not 12 / (2 + eps)
    assert got[1] == 0.0 and got[2] == 0.0
    assert np.isfinite(got).all()


def test_segment_mean_matrix_rows_empty_rows_zero():
    data = _t([[2.0, 4.0], [6.0, 8.0]]).float()
    out = tseg.segment_mean(data, _t([2, 2]), 3)
    np.testing.assert_array_equal(out.numpy(),
                                  [[0.0, 0.0], [0.0, 0.0], [4.0, 6.0]])


def test_segment_softmax_normalizes_per_segment():
    out = tseg.segment_softmax(_t([1.0, 2.0, 3.0, 1.0]).float(),
                               _t([0, 0, 1, 1]), 2).numpy()
    assert out[0] + out[1] == pytest.approx(1.0)
    assert out[2] + out[3] == pytest.approx(1.0)
    assert out[1] > out[0] and out[2] > out[3]


@pytest.mark.parametrize("with_layout", [False, True],
                         ids=["plain", "layout"])
def test_segment_softmax_all_neg_inf_segment_is_finite(with_layout):
    scores = _t([-np.inf, -np.inf, 1.0, 2.0]).float()
    ids = _t([0, 0, 1, 1])
    layout = build_layout(ids, 2) if with_layout else None
    out = tseg.segment_softmax(scores, ids, 2, layout=layout).numpy()
    assert np.isfinite(out).all()
    np.testing.assert_array_equal(out[:2], [0.0, 0.0])
    assert out[2] + out[3] == pytest.approx(1.0)
    want = np.asarray(jseg.segment_softmax(jnp.asarray(scores.numpy()),
                                           jnp.asarray(ids.numpy()), 2))
    np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("with_layout", [False, True],
                         ids=["plain", "layout"])
def test_segment_softmax_sentinel_rows_excluded_from_normalizer(with_layout):
    ids = _t([0, 0, 5])  # the third row is padding (>= num_segments)
    layout = build_layout(ids, 2) if with_layout else None
    out = tseg.segment_softmax(_t([0.0, 0.0, 100.0]).float(), ids, 2,
                               layout=layout).numpy()
    assert out[0] == pytest.approx(0.5) and out[1] == pytest.approx(0.5)


# ------------------------------------------- seeded inputs against the JAX

# (name, E, N, trailing shape, id range [lo, hi)): ids below 0 and from N
# up are dropped
CASES = {
    "vector": (40, 7, (), (0, 7)),
    "heads8": (300, 50, (8,), (-3, 53)),
    "heads1": (120, 30, (1,), (0, 31)),
    "matrix": (64, 9, (3, 4), (-1, 10)),
    "empty-segments": (10, 40, (2,), (0, 40)),
    "all-dropped": (16, 4, (2,), (4, 9)),
}


def _case(name, dtype=np.float32, seed=0):
    e, n, trail, (lo, hi) = CASES[name]
    rng = np.random.default_rng(seed)
    ids = rng.integers(lo, hi, e).astype(np.int32)
    if np.issubdtype(dtype, np.integer):
        data = rng.integers(-1000, 1000, (e, *trail)).astype(dtype)
    else:
        data = (rng.standard_normal((e, *trail)) * 3).astype(dtype)
    return data, ids, n


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.int64],
                         ids=["f32", "i32", "i64"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_segment_max_equals_reference(name, dtype):
    if dtype is np.int64:
        jax.config.update("jax_enable_x64", True)
    try:
        data, ids, n = _case(name, dtype)
        want = np.asarray(jseg.segment_max(jnp.asarray(data),
                                           jnp.asarray(ids), n))
    finally:
        jax.config.update("jax_enable_x64", False)
    got = tseg.segment_max(_t(data), _t(ids), n).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_segment_mean_equals_reference(name):
    data, ids, n = _case(name)
    want = np.asarray(jseg.segment_mean(jnp.asarray(data), jnp.asarray(ids),
                                        n))
    got = tseg.segment_mean(_t(data), _t(ids), n).numpy()
    assert got.dtype == want.dtype
    _close(got, want)
    empty = np.bincount(ids[(ids >= 0) & (ids < n)], minlength=n) == 0
    assert (got[empty] == 0).all()


@pytest.mark.parametrize("with_layout", [False, True],
                         ids=["plain", "layout"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_segment_softmax_equals_reference(name, with_layout):
    data, ids, n = _case(name)
    data[::7] = -np.inf  # masked scores, some segments all -inf
    want = np.asarray(jseg.segment_softmax(jnp.asarray(data),
                                           jnp.asarray(ids), n))
    t_ids = _t(ids)
    layout = build_layout(t_ids, n) if with_layout else None
    before = tsegk.LAUNCHES["segment_sum"]
    got = tseg.segment_softmax(_t(data), t_ids, n, layout=layout).numpy()
    assert tsegk.LAUNCHES["segment_sum"] == before  # the CPU: no launch
    assert got.dtype == want.dtype and np.isfinite(got).all()
    _close(got, want)


@pytest.mark.parametrize("with_layout", [False, True],
                         ids=["plain", "layout"])
@pytest.mark.parametrize("name", ["heads8", "matrix", "vector"])
def test_segment_softmax_gradient_equals_reference(name, with_layout):
    """The port takes the max without gradient; the reference
    differentiates through it.  The softmax does not depend on the shift,
    so the gradients agree to rounding."""
    data, ids, n = _case(name, seed=1)
    w = np.random.default_rng(2).standard_normal(data.shape).astype(
        np.float32)
    keep = ((ids >= 0) & (ids < n)).reshape(-1, *([1] * (data.ndim - 1)))

    def jloss(x):
        return jnp.sum(jseg.segment_softmax(x, jnp.asarray(ids), n) * w
                       * keep)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(data)))
    x = _t(data).requires_grad_(True)
    t_ids = _t(ids)
    layout = build_layout(t_ids, n) if with_layout else None
    (tseg.segment_softmax(x, t_ids, n, layout=layout) * _t(w)
     * _t(keep)).sum().backward()
    _close(x.grad.numpy(), want)


def test_integer_segment_sum_is_unchanged():
    """The triangle engine's credit scatter: int32, sentinel and negative
    ids dropped, the reference's values."""
    data = np.array([1, 10, 100, 1000, 5], np.int32)
    ids = np.array([0, 3, 1, 7, -1], np.int32)
    got = tseg.segment_sum(_t(data), _t(ids), 3)
    assert got.dtype == torch.int32
    want = np.asarray(jseg.segment_sum(jnp.asarray(data), jnp.asarray(ids),
                                       3))
    np.testing.assert_array_equal(got.numpy(), want)
