"""Wedge-sampled approximate triangle counting (counterpart of
``repro.core.approx``): the one-shot :func:`wedge_sample_estimate`, the
engine's ``route="approx"`` and the serving layer's degraded lane, and
the reservoir-sampled :class:`StreamingWedgeEstimator`, the stream
route's approximate lane.

Wedge sampling (the estimator family of *Parallel Triangle Counting in
Massive Streaming Graphs*, arXiv 1308.2166, and Seshadhri–Pinar): the
number of closed wedges is exactly ``3T``, so sampling ``k`` wedges
uniformly from the ``W = Σ_v C(d_v, 2)`` total and measuring the closed
fraction ``p̂`` gives the unbiased estimate ``T̂ = p̂ · W / 3`` with a
binomial error bar.

Host numpy, as in the reference, and drawn in the same order from the
same ``numpy.random.Generator``: the same ``seed`` and the same input
give the same :class:`ApproxEstimate` in both packages, field for
field.  The degraded lane stays on the host on purpose: it answers
while the device path is saturated or failing, so it must not join the
device queue it routes around.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = [
    "ApproxEstimate",
    "StreamingWedgeEstimator",
    "wedge_sample_estimate",
]


@dataclasses.dataclass(frozen=True)
class ApproxEstimate:
    """A triangle-count estimate with its error bar.

    ``triangles`` is the point estimate ``p̂·W/3`` (a float — rounding is
    the caller's presentation choice); ``stderr`` its binomial standard
    error and ``ci95`` the ±1.96σ half-width; ``exact`` marks the two
    cases where sampling collapses to certainty (no wedges at all, or a
    sample that covered every wedge).  ``samples``/``closed`` are the
    raw tallies and ``wedges`` the exact wedge total the estimate scales.
    """

    triangles: float
    stderr: float
    ci95: float
    samples: int
    closed: int
    wedges: float
    exact: bool = False

    @property
    def rel_ci(self) -> float:
        """ci95 / max(estimate, 1) — the honest relative error bar."""
        return self.ci95 / max(self.triangles, 1.0)


def _unique_keys(edges: np.ndarray, n_nodes: int) -> np.ndarray:
    """The sorted unique packed keys ``lo * n + hi`` of the undirected
    edges, self-loops dropped; raises on endpoints outside ``[0, n)``."""
    e = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    if e.size and (e.min() < 0 or e.max() >= int(n_nodes)):
        raise ValueError(
            f"edge endpoints must lie in [0, {int(n_nodes)}); "
            f"got [{e.min()}, {e.max()}]"
        )
    e = e[e[:, 0] != e[:, 1]]
    if not e.size:
        return np.zeros(0, dtype=np.int64)
    lo = np.minimum(e[:, 0], e[:, 1])
    hi = np.maximum(e[:, 0], e[:, 1])
    # np.unique by hand: a sort and a mask of first occurrences give the
    # same array, and numpy 2.3's np.unique is many times slower than its
    # sort on integer keys
    key = np.sort(lo * np.int64(n_nodes) + hi)
    return key[np.concatenate([[True], key[1:] != key[:-1]])]


def _normalize_host(edges: np.ndarray, n_nodes: int) -> np.ndarray:
    """Unique undirected ``(lo, hi)`` edges, self-loops dropped, sorted
    by packed key — the reference's ``_normalize_host``, on the host."""
    n = np.int64(n_nodes)
    key = _unique_keys(edges, n_nodes)
    return np.stack([key // n, key % n], axis=1)


def wedge_sample_estimate(
    edges: np.ndarray,
    n_nodes: int,
    *,
    samples: int = 8192,
    seed: int = 0,
) -> ApproxEstimate:
    """Estimate the triangle count of ``(edges, n_nodes)`` from
    ``samples`` uniformly-sampled wedges.

    A wedge is sampled by picking its apex ``v`` with probability
    ``C(d_v,2)/W`` and then two distinct neighbors uniformly; closure is
    a binary search of the sorted edge-key table.  Graphs with ``W = 0``
    (empty graphs, matchings — no vertex of degree ≥ 2) have zero
    triangles by construction and return the exact answer with a
    zero-width interval.

    The reference's arrays and draws, in its order: each vertex's
    neighbour list is its higher neighbours and then its lower ones,
    each ascending (the reference's stable argsort of the symmetrized
    list), here from one sort of tagged keys.
    """
    if samples <= 0:
        raise ValueError(f"samples must be positive; got {samples}")
    n = int(n_nodes)
    n64 = np.int64(n)
    keys = _unique_keys(edges, n)  # sorted: the closure table
    lo, hi = keys // n64, keys % n64
    deg = (np.bincount(lo, minlength=n)
           + np.bincount(hi, minlength=n)).astype(np.int64)
    w_v = deg * (deg - 1) // 2
    wedges = float(w_v.sum())
    if wedges == 0.0:
        return ApproxEstimate(
            triangles=0.0, stderr=0.0, ci95=0.0, samples=0, closed=0,
            wedges=0.0, exact=True,
        )

    # CSR adjacency of the symmetrized edge list, host-side: the tag
    # (2 * src + 0 for a higher neighbour, + 1 for a lower one) orders
    # each source's two halves as the reference's stable argsort does
    tagged = np.sort(np.concatenate([(2 * lo) * n64 + hi,
                                     (2 * hi + 1) * n64 + lo]))
    dst = tagged % n64
    starts = np.concatenate([[0], np.cumsum(deg)])

    rng = np.random.default_rng(seed)
    k = int(samples)
    apex = rng.choice(n, size=k, p=w_v / w_v.sum())
    d = deg[apex]
    # two distinct neighbor positions, uniform over C(d, 2) pairs
    i1 = rng.integers(0, d)
    i2 = rng.integers(0, d - 1)
    i2 = np.where(i2 >= i1, i2 + 1, i2)
    u = dst[starts[apex] + i1]
    x = dst[starts[apex] + i2]
    q = np.minimum(u, x) * n64 + np.maximum(u, x)
    pos = np.searchsorted(keys, q)
    closed = int(np.sum((pos < keys.size)
                        & (keys[np.minimum(pos, keys.size - 1)] == q)))

    p_hat = closed / k
    est = p_hat * wedges / 3.0
    stderr = (wedges / 3.0) * math.sqrt(max(p_hat * (1.0 - p_hat), 0.0) / k)
    return ApproxEstimate(
        triangles=est, stderr=stderr, ci95=1.96 * stderr,
        samples=k, closed=closed, wedges=wedges,
    )


class StreamingWedgeEstimator:
    """Reservoir-sampled wedge estimator for edge-mutation streams — the
    stream route's approximate lane (arXiv 1308.2166's edge-sampling
    scheme, adapted to the session setting).

    An **edge reservoir** of fixed capacity ``r`` is maintained over the
    insertion stream with Algorithm R (each arriving edge replaces a
    uniform slot with probability ``r / t``), so at any point the
    reservoir is a uniform sample of the edges inserted since the last
    reseed.  Deletions evict their edge from the reservoir if sampled;
    when eviction has hollowed the reservoir below half capacity the
    caller reseeds it from the live edge set (``reseed`` — an O(m) host
    pass, the documented resync of the deletion bias).

    **Estimation**: every unordered pair of reservoir edges that shares
    exactly one endpoint is a uniformly-sampled *wedge* (a wedge IS a
    pair of adjacent edges, and the reservoir pair distribution is
    uniform over edge pairs), so the closed fraction ``p̂`` of those
    wedges — closure checked against the caller's sorted packed-key
    table, the one exact structure a stream session always has —
    estimates ``3T / W``.  ``W`` itself is computed *exactly* from the
    live degree array, so the only sampling error is in ``p̂``:
    ``T̂ = p̂ · W / 3`` with the usual binomial error bar.  Wedge-starved
    reservoirs (fewer shared-endpoint pairs than ``min_wedges``) top up
    with apex-sampled wedges from ``wedge_sample_estimate``'s scheme so
    the lane never answers from a handful of samples.
    """

    def __init__(self, n_nodes: int, *, reservoir: int = 1024,
                 seed: int = 0):
        if reservoir <= 0:
            raise ValueError(f"reservoir must be positive; got {reservoir}")
        self.n_nodes = int(n_nodes)
        self.capacity = int(reservoir)
        self._rng = np.random.default_rng(seed)
        self._keys: list[int] = []   # sampled packed edge keys lo*n+hi
        self._seen = 0               # insertions since last reseed

    # ------------------------------------------------------ maintenance
    def _key(self, u: int, v: int) -> int:
        lo, hi = (u, v) if u < v else (v, u)
        return lo * self.n_nodes + hi

    def insert(self, u: int, v: int) -> None:
        """Offer one inserted edge to the reservoir (Algorithm R)."""
        self._seen += 1
        k = self._key(int(u), int(v))
        if len(self._keys) < self.capacity:
            self._keys.append(k)
        else:
            j = int(self._rng.integers(0, self._seen))
            if j < self.capacity:
                self._keys[j] = k

    def delete(self, u: int, v: int) -> None:
        """Evict one deleted edge (if it was sampled)."""
        k = self._key(int(u), int(v))
        self._keys = [x for x in self._keys if x != k]

    @property
    def hollow(self) -> bool:
        """True when deletions have shrunk the reservoir below half its
        capacity (relative to what the stream could have filled) — the
        caller should :meth:`reseed` from the live edge set."""
        want = min(self.capacity, self._seen)
        return want > 0 and len(self._keys) < (want + 1) // 2

    def reseed(self, sorted_keys: np.ndarray) -> None:
        """Resample the reservoir uniformly from the live edge set
        (``sorted_keys`` — the session's packed-key table)."""
        m = int(sorted_keys.shape[0])
        take = min(self.capacity, m)
        if take:
            pick = self._rng.choice(m, size=take, replace=False)
            self._keys = [int(k) for k in sorted_keys[pick]]
        else:
            self._keys = []
        self._seen = m

    # ------------------------------------------------------- estimation
    def estimate(self, sorted_keys: np.ndarray, deg: np.ndarray,
                 *, min_wedges: int = 256) -> ApproxEstimate:
        """Estimate the live triangle count.

        ``sorted_keys`` is the exact sorted packed-key table of the
        current edge set (closure oracle); ``deg`` the live int degree
        array (exact wedge total).  Returns the unified
        :class:`ApproxEstimate` contract — same fields, same error-bar
        semantics as the one-shot ``wedge_sample_estimate``.
        """
        n = self.n_nodes
        d = np.asarray(deg, dtype=np.int64)
        w_v = d * (d - 1) // 2
        wedges = float(w_v.sum())
        if wedges == 0.0:
            return ApproxEstimate(
                triangles=0.0, stderr=0.0, ci95=0.0, samples=0, closed=0,
                wedges=0.0, exact=True,
            )
        qlo, qhi = self._reservoir_wedges()
        if qlo.shape[0] < min_wedges:
            extra = self._apex_wedges(
                sorted_keys, d, w_v, min_wedges - qlo.shape[0]
            )
            if extra is not None:
                qlo = np.concatenate([qlo, extra[0]])
                qhi = np.concatenate([qhi, extra[1]])
        k = int(qlo.shape[0])
        if k == 0:  # degenerate: no wedge sample at all — exact-by-zero
            return ApproxEstimate(
                triangles=0.0, stderr=wedges / 3.0, ci95=1.96 * wedges / 3.0,
                samples=0, closed=0, wedges=wedges,
            )
        q = qlo * np.int64(n) + qhi
        pos = np.searchsorted(sorted_keys, q)
        hit = (pos < sorted_keys.size) & (
            sorted_keys[np.minimum(pos, sorted_keys.size - 1)] == q
        )
        closed = int(hit.sum())
        p_hat = closed / k
        est = p_hat * wedges / 3.0
        stderr = (wedges / 3.0) * math.sqrt(
            max(p_hat * (1.0 - p_hat), 0.0) / k
        )
        return ApproxEstimate(
            triangles=est, stderr=stderr, ci95=1.96 * stderr,
            samples=k, closed=closed, wedges=wedges,
        )

    def _reservoir_wedges(self) -> tuple[np.ndarray, np.ndarray]:
        """Closure queries ``(lo, hi)`` of every shared-endpoint pair of
        reservoir edges — each pair is one uniformly-sampled wedge, and
        the query is its missing third side."""
        n = np.int64(self.n_nodes)
        keys = np.asarray(self._keys, dtype=np.int64)
        if keys.shape[0] < 2:
            z = np.zeros(0, dtype=np.int64)
            return z, z
        lo, hi = keys // n, keys % n
        ends = np.concatenate([lo, hi])
        eid = np.concatenate([np.arange(keys.size), np.arange(keys.size)])
        other = np.concatenate([hi, lo])
        order = np.argsort(ends, kind="stable")
        ends, eid, other = ends[order], eid[order], other[order]
        q1, q2 = [], []
        i = 0
        while i < ends.size:
            j = i
            while j < ends.size and ends[j] == ends[i]:
                j += 1
            for a in range(i, j):
                for b in range(a + 1, j):
                    if eid[a] == eid[b]:
                        continue  # same edge listed from both endpoints
                    x, y = int(other[a]), int(other[b])
                    if x == y:
                        continue  # parallel pair, not a wedge
                    q1.append(min(x, y))
                    q2.append(max(x, y))
            i = j
        return (np.asarray(q1, dtype=np.int64),
                np.asarray(q2, dtype=np.int64))

    def _apex_wedges(self, sorted_keys, d, w_v, count: int):
        """Top-up wedges apex-sampled from the exact degree distribution
        (the ``wedge_sample_estimate`` scheme) when the reservoir alone
        is wedge-starved."""
        total = int(w_v.sum())
        if total == 0 or count <= 0 or sorted_keys.size == 0:
            return None
        n = self.n_nodes
        src = np.concatenate(
            [sorted_keys // n, sorted_keys % n]
        )
        dst = np.concatenate(
            [sorted_keys % n, sorted_keys // n]
        )
        order = np.argsort(src, kind="stable")
        src, dst = src[order], dst[order]
        starts = np.searchsorted(src, np.arange(n + 1))
        apex = self._rng.choice(n, size=count, p=w_v / w_v.sum())
        da = d[apex]
        i1 = self._rng.integers(0, da)
        i2 = self._rng.integers(0, da - 1)
        i2 = np.where(i2 >= i1, i2 + 1, i2)
        u = dst[starts[apex] + i1]
        x = dst[starts[apex] + i2]
        return np.minimum(u, x), np.maximum(u, x)
