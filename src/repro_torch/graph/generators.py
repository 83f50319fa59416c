"""Deterministic host-side graph generators.

A verbatim copy of ``repro.graph.generators`` (pure numpy): the port
imports nothing of ``repro``, and the same seed gives the same edges.

Offline container: no SNAP downloads.  We provide

  * ``rmat``      — Graph500 R-MAT (a=0.57, b=0.19, c=0.19, d=0.05, m=16n
                    by default), the paper's synthetic workload (§V-C),
  * ``erdos_renyi``, ``ring_of_cliques``, ``complete`` — controlled
    fixtures with known triangle counts,
  * ``karate``    — Zachary's karate club (34 vertices, 78 edges, 45
                    triangles), the standard small real graph,
  * ``dolphins_like`` — a seeded 62-vertex social-style fixture standing in
    for the paper's dolphin walkthrough (the original edge list is not
    shipped offline).

All generators return ``(edges ndarray[int64, e, 2], n_nodes)`` and are
pure functions of their seeds.
"""
from __future__ import annotations

import numpy as np

GRAPH500_A, GRAPH500_B, GRAPH500_C, GRAPH500_D = 0.57, 0.19, 0.19, 0.05


def rmat(
    scale: int,
    edge_factor: int = 16,
    *,
    a: float = GRAPH500_A,
    b: float = GRAPH500_B,
    c: float = GRAPH500_C,
    seed: int = 0,
) -> tuple[np.ndarray, int]:
    """Graph500 R-MAT generator (Chakrabarti et al., SDM'04).

    ``a, b, c`` are the upper-left / upper-right / lower-left quadrant
    probabilities (``d = 1 - a - b - c`` implied).  They must be
    non-negative and sum to at most 1 — otherwise the recursive
    quadrant-picking below normalizes into a nonsense distribution
    (``c_norm > 1`` etc.) and silently produces a graph from no valid
    R-MAT model, so invalid inputs fail loudly instead.
    """
    # the epsilon admits valid triples whose float sum lands a few ulps
    # above 1 (e.g. 0.33 + 0.56 + 0.11) while still rejecting real
    # violations like the motivating a=0.9, b=0.3, c=0.3
    if min(a, b, c) < 0 or a + b + c > 1 + 1e-9:
        raise ValueError(
            f"rmat probabilities must satisfy a, b, c >= 0 and "
            f"a + b + c <= 1; got a={a}, b={b}, c={c} "
            f"(sum {a + b + c})"
        )
    n = 1 << scale
    m = edge_factor * n
    rng = np.random.default_rng(seed)
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    ab = a + b
    # degenerate-but-valid corners: ab == 1 forces c == 0, ab == 0 puts
    # all left-quadrant mass on c — either way the conditional is constant
    c_norm = c / (1.0 - ab) if ab < 1.0 else 0.0
    a_norm = a / ab if ab > 0.0 else 0.0
    for bit in range(scale):
        r1 = rng.random(m)
        r2 = rng.random(m)
        src_bit = r1 > ab
        dst_bit = np.where(src_bit, r2 > c_norm, r2 > a_norm)
        src |= src_bit.astype(np.int64) << bit
        dst |= dst_bit.astype(np.int64) << bit
    # Graph500 permutes vertex labels to break degree-locality.
    perm = rng.permutation(n)
    return np.stack([perm[src], perm[dst]], axis=1), n


def erdos_renyi(n: int, p: float, *, seed: int = 0) -> tuple[np.ndarray, int]:
    rng = np.random.default_rng(seed)
    # sample i<j pairs via geometric skipping for sparse p
    max_pairs = n * (n - 1) // 2
    keep = rng.random(max_pairs) < p
    idx = np.nonzero(keep)[0]
    # invert the linear index of the strictly-upper-triangular enumeration
    i = (n - 2 - np.floor(np.sqrt(-8 * idx + 4 * n * (n - 1) - 7) / 2 - 0.5)).astype(
        np.int64
    )
    j = (idx + i + 1 - n * (n - 1) // 2 + (n - i) * ((n - i) - 1) // 2).astype(np.int64)
    return np.stack([i, j], axis=1), n


def complete(n: int) -> tuple[np.ndarray, int]:
    i, j = np.triu_indices(n, k=1)
    return np.stack([i, j], axis=1).astype(np.int64), n


def path(n: int) -> tuple[np.ndarray, int]:
    """Path graph 0-1-...-(n-1): zero triangles, and every BFS from an
    endpoint yields zero horizontal edges (k = 0) — a §V-B degenerate
    fixture for baseline cross-checks."""
    i = np.arange(max(0, n - 1), dtype=np.int64)
    return np.stack([i, i + 1], axis=1), n


def star(n: int) -> tuple[np.ndarray, int]:
    """Star K_{1,n-1} centered on vertex 0: zero triangles; rooted at a
    leaf, all other leaves land on one level (k = (n-2)/(n-1)) — the
    opposite horizontal-fraction extreme from ``path``."""
    leaves = np.arange(1, n, dtype=np.int64)
    return np.stack([np.zeros_like(leaves), leaves], axis=1), n


def ring_of_cliques(n_cliques: int, clique_size: int) -> tuple[np.ndarray, int]:
    """Known count: n_cliques * C(clique_size, 3) triangles."""
    edges = []
    for ci in range(n_cliques):
        base = ci * clique_size
        for i in range(clique_size):
            for j in range(i + 1, clique_size):
                edges.append((base + i, base + j))
        nxt = ((ci + 1) % n_cliques) * clique_size
        edges.append((base, nxt))
    return np.asarray(edges, dtype=np.int64), n_cliques * clique_size


_KARATE = (
    "0-1 0-2 0-3 0-4 0-5 0-6 0-7 0-8 0-10 0-11 0-12 0-13 0-17 0-19 0-21 0-31 "
    "1-2 1-3 1-7 1-13 1-17 1-19 1-21 1-30 2-3 2-7 2-8 2-9 2-13 2-27 2-28 2-32 "
    "3-7 3-12 3-13 4-6 4-10 5-6 5-10 5-16 6-16 8-30 8-32 8-33 9-33 13-33 14-32 "
    "14-33 15-32 15-33 18-32 18-33 19-33 20-32 20-33 22-32 22-33 23-25 23-27 "
    "23-29 23-32 23-33 24-25 24-27 24-31 25-31 26-29 26-33 27-33 28-31 28-33 "
    "29-32 29-33 30-32 30-33 31-32 31-33 32-33"
)


def karate() -> tuple[np.ndarray, int]:
    """Zachary karate club: n=34, m=78, 45 triangles."""
    edges = [tuple(map(int, e.split("-"))) for e in _KARATE.split()]
    return np.asarray(edges, dtype=np.int64), 34


def dolphins_like(seed: int = 7) -> tuple[np.ndarray, int]:
    """62-vertex, ~159-edge social-style stand-in for the dolphin graph."""
    rng = np.random.default_rng(seed)
    n = 62
    # small-world base ring + random chords gives social-network-ish k
    edges = [(i, (i + 1) % n) for i in range(n)] + [(i, (i + 2) % n) for i in range(n)]
    extra = rng.integers(0, n, size=(60, 2))
    edges += [tuple(e) for e in extra if e[0] != e[1]]
    return np.asarray(edges, dtype=np.int64), n


def random_geometric(n: int, radius: float, *, seed: int = 0) -> tuple[np.ndarray, int]:
    """Points in the unit cube joined under ``radius`` — molecule-style
    fixture for SchNet/DimeNet (positions regenerated by the caller with the
    same seed)."""
    rng = np.random.default_rng(seed)
    pos = rng.random((n, 3))
    d2 = ((pos[:, None, :] - pos[None, :, :]) ** 2).sum(-1)
    i, j = np.nonzero(np.triu(d2 < radius * radius, k=1))
    return np.stack([i, j], axis=1).astype(np.int64), n


def positions_for(n: int, *, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.random((n, 3)).astype(np.float32)
