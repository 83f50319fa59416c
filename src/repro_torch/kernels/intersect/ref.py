"""Plain PyTorch versions of the intersect kernels K1, K2 and K3.

K1, the level-split intersection, in two forms of one function:

* :func:`intersect_ref` takes the *dense* blocks the TPU kernel takes
  (counterpart of ``repro.kernels.intersect.ref.intersect_ref``):

    cand   int32[Q, Dc]  sorted candidate neighbour lists (pad = -1)
    targ   int32[Q, Dt]  sorted target neighbour lists   (pad = -2)
    lev_c  int32[Q, Dc]  BFS level of each candidate
    lev_u  int32[Q]      BFS level of the horizontal edge's endpoints

* :func:`intersect_levels_ref` takes the CSR-bounds form the Hopper
  kernel takes: one flat sorted adjacency array, per row the candidate
  slice ``flat[s_s : s_s + l_s]`` and the target slice
  ``flat[s_l : s_l + l_l]``, each clamped to the bucket's width
  (``d_cand`` / ``d_targ``) exactly as the reference's dense gather
  clamps them.  It never holds more than ``_CELL_BUDGET`` cells of
  ``[rows, d_cand]`` intermediates at once: it works through the rows in
  chunks.

Both return per-row ``(c1, c2)`` int32: c1 counts the candidates found
in the target row whose level differs from ``lev_u``, c2 those on the
same level — the two counters of Theorem 1.

K2, the membership mask, in the same two forms: :func:`hits_ref` on the
dense blocks (counterpart of ``intersect_pallas_hits``'s body), and
:func:`intersect_hits_ref` on CSR bounds, which returns the mask
*ragged* — only each row's real (clamped) candidates, row after row —
because the dense ``bool[Q, Dc]`` does not fit at Graph500 scale 20.

K3, the level-free count ``|cand ∩ targ|`` per row, on CSR bounds:
:func:`intersect_count_ref` (on the dense blocks it is the row sum of
:func:`hits_ref`); :func:`count_tiles_ref` is its walk as the kernel
does it (tiles of cells, slices of the target).
"""
from __future__ import annotations

import math

import torch

from repro_torch.graph.csr import bounded_binary_search, gather_rows

CAND_PAD = -1
TARG_PAD = -2

#: Upper bound on the ``[rows, d_cand]`` cells one chunk of the plain
#: CSR-bounds path materializes (each cell costs a few int32 temporaries).
_CELL_BUDGET = 1 << 24


def intersect_ref(cand, targ, lev_c, lev_u):
    """Dense all-pairs form; ``Dc`` and ``Dt`` may differ."""
    hit = hits_ref(cand, targ)
    same = lev_c == lev_u[:, None]
    return (
        (hit & ~same).sum(dim=1, dtype=torch.int32),
        (hit & same).sum(dim=1, dtype=torch.int32),
    )


def search_steps(d_targ: int) -> int:
    """Binary-search depth that converges on any list of ``<= d_targ``
    entries: ``max(1, ceil(log2(d_targ + 1)))``."""
    return max(1, math.ceil(math.log2(int(d_targ) + 1)))


def _found_chunks(flat, s_s, l_s, s_l, l_search, *, d_cand: int,
                  num_steps: int):
    """Yield ``(r0, r1, ls, cand, found)`` for row chunks of at most
    ``_CELL_BUDGET`` cells: the dense candidate gather (clamped to
    ``d_cand``, pad ``CAND_PAD``) and its membership by a bounded binary
    search of ``num_steps`` halvings over ``flat[s_l : s_l +
    l_search]``.  A ``l_search`` longer than ``2**num_steps - 1``
    under-searches the way the reference's jnp probe does."""
    q = s_s.shape[0]
    step = max(1, _CELL_BUDGET // max(1, d_cand))
    for r0 in range(0, q, step):
        r1 = min(q, r0 + step)
        ls = l_s[r0:r1].clamp(max=d_cand)
        cand = gather_rows(flat, s_s[r0:r1], ls, width=d_cand, pad=CAND_PAD)
        rows = cand.shape[0]
        found = bounded_binary_search(
            flat,
            s_l[r0:r1, None].expand(rows, d_cand),
            l_search[r0:r1, None].expand(rows, d_cand),
            cand,
            num_steps=num_steps,
        ) & (cand >= 0)
        yield r0, r1, ls, cand, found


def split_counts(flat, s_s, l_s, s_l, l_search, level, lev_u, *,
                 d_cand: int, num_steps: int):
    """Per-row ``(c1, c2)`` by dense candidate gather + bounded binary
    search over ``flat[s_l : s_l + l_search]``, in row chunks
    (:func:`_found_chunks`).  The candidate level is ``level[cand]``
    (``-7`` for an id outside ``level``, the TPU kernel's pad)."""
    q = s_s.shape[0]
    dev = s_s.device
    c1 = torch.zeros(q, dtype=torch.int32, device=dev)
    c2 = torch.zeros(q, dtype=torch.int32, device=dev)
    if q == 0 or d_cand <= 0:
        return c1, c2
    n = level.shape[0]
    lev_ext = torch.cat([
        level, torch.full((1,), -7, dtype=torch.int32, device=dev)
    ])
    for r0, r1, _, cand, found in _found_chunks(
        flat, s_s, l_s, s_l, l_search, d_cand=d_cand, num_steps=num_steps
    ):
        same = lev_ext[cand.clamp(0, n)] == lev_u[r0:r1, None]
        c1[r0:r1] = (found & ~same).sum(dim=1, dtype=torch.int32)
        c2[r0:r1] = (found & same).sum(dim=1, dtype=torch.int32)
    return c1, c2


def found_counts(flat, s_s, l_s, s_l, l_search, *, d_cand: int,
                 num_steps: int):
    """Per-row hit count int32[Q]: the row sums of :func:`_found_chunks`
    (no level split) — the reference's jnp probe without ``level``.  Only
    the rows with candidates are probed (a row without any counts 0):
    Algorithm 2's hedge blocks are mostly padding."""
    q = s_s.shape[0]
    cnt = torch.zeros(q, dtype=torch.int32, device=s_s.device)
    if q == 0 or d_cand <= 0:
        return cnt
    live = (l_s > 0).nonzero().squeeze(1)
    s_s, l_s, s_l, l_search = (x[live] for x in (s_s, l_s, s_l, l_search))
    for r0, r1, _, _, found in _found_chunks(
        flat, s_s, l_s, s_l, l_search, d_cand=d_cand, num_steps=num_steps
    ):
        cnt[live[r0:r1]] = found.sum(dim=1, dtype=torch.int32)
    return cnt


def intersect_levels_ref(flat, s_s, l_s, s_l, l_l, level, lev_u, *,
                         d_cand: int, d_targ: int):
    """CSR-bounds form of K1: ``(c1, c2)`` int32[Q] for candidate lists
    ``flat[s_s : s_s + min(l_s, d_cand)]`` against target lists
    ``flat[s_l : s_l + min(l_l, d_targ)]`` (sorted), split by
    ``level[cand] == lev_u``.  Equal to ``intersect_ref`` on the dense
    blocks the reference's ``_gather_cand_targ`` builds from the same
    bounds."""
    return split_counts(
        flat, s_s, l_s, s_l, l_l.clamp(max=d_targ), level, lev_u,
        d_cand=d_cand, num_steps=search_steps(d_targ),
    )


# --------------------------------------------------------------- K2


def hits_ref(cand, targ):
    """Dense form of K2: ``bool[Q, Dc]``, true where ``cand[r, j]`` (not
    a pad) appears in ``targ[r]`` — the function of
    ``intersect_pallas_hits``."""
    eq = cand[:, :, None] == targ[:, None, :]
    return eq.any(dim=2) & (cand >= 0)


def hit_offsets(l_s, *, d_cand: int):
    """int64[Q + 1] start of each row's ragged mask: the running sum of
    the clamped candidate counts ``min(l_s, d_cand)``."""
    off = torch.zeros(l_s.shape[0] + 1, dtype=torch.int64,
                      device=l_s.device)
    torch.cumsum(l_s.clamp(0, max(0, d_cand)), 0, out=off[1:])
    return off


def probe_hits(flat, s_s, l_s, s_l, l_search, *, d_cand: int,
               num_steps: int):
    """Ragged membership mask ``(offsets int64[Q + 1], hits
    bool[offsets[-1]])`` by dense candidate gather + bounded binary
    search over ``flat[s_l : s_l + l_search]`` in row chunks
    (:func:`_found_chunks`): row r's mask is ``hits[offsets[r] :
    offsets[r + 1]]``, one entry per candidate ``flat[s_s[r] + j]``,
    ``j < min(l_s[r], d_cand)``, in candidate order."""
    offsets = hit_offsets(l_s, d_cand=d_cand)
    parts = [torch.zeros(0, dtype=torch.bool, device=s_s.device)]
    if s_s.shape[0] and d_cand > 0:
        pos = torch.arange(d_cand, device=s_s.device)
        for _, _, ls, _, found in _found_chunks(
            flat, s_s, l_s, s_l, l_search, d_cand=d_cand,
            num_steps=num_steps,
        ):
            parts.append(found[pos[None, :] < ls[:, None]])
    return offsets, torch.cat(parts)


def intersect_hits_ref(flat, s_s, l_s, s_l, l_l, *, d_cand: int,
                       d_targ: int):
    """CSR-bounds form of K2: ``(offsets int64[Q + 1], hits
    bool[offsets[-1]])``, the candidates ``flat[s_s : s_s + min(l_s,
    d_cand)]`` found in the sorted target ``flat[s_l : s_l + min(l_l,
    d_targ)]``, row after row (:func:`probe_hits`).  Scattered back into
    ``[Q, d_cand]`` it equals :func:`hits_ref` on the dense blocks the
    reference's ``_gather_cand_targ`` builds from the same bounds."""
    return probe_hits(
        flat, s_s, l_s, s_l, l_l.clamp(max=d_targ),
        d_cand=d_cand, num_steps=search_steps(d_targ),
    )


# --------------------------------------------------------------- K3


def intersect_count_ref(flat, s_s, l_s, s_l, l_l, *, d_cand: int,
                        d_targ: int):
    """CSR-bounds form of K3: ``int32[Q]``, how many of the candidates
    ``flat[s_s : s_s + min(l_s, d_cand)]`` are found in the sorted target
    ``flat[s_l : s_l + min(l_l, d_targ)]``, by the search-depth rule of
    :func:`intersect_levels_ref` — so it is K1's ``c1 + c2`` row for row,
    and the row sum of :func:`hits_ref` on the dense blocks the
    reference's ``_gather_cand_targ`` builds from the same bounds."""
    return found_counts(
        flat, s_s, l_s, s_l, l_l.clamp(max=d_targ),
        d_cand=d_cand, num_steps=search_steps(d_targ),
    )


def _upper_bound(flat, base, n, key):
    """Per element: how many of ``flat[base : base + n]`` (sorted) are
    ``<= key`` — the first index past them."""
    lo = torch.zeros_like(n)
    hi = n.clone()
    top = max(0, flat.shape[0] - 1)
    while bool((lo < hi).any()):
        on = lo < hi
        mid = (lo + hi) // 2
        le = flat[(base + mid).clamp(0, top)] <= key
        lo = torch.where(on & le, mid + 1, lo)
        hi = torch.where(on & ~le, mid, hi)
    return lo


def _find_halving(flat, base, n, v):
    """Whether ``v`` is in ``flat[base : base + n]`` (sorted), by the
    kernel's halving: keep the last entry ``<= v`` in range, ``n -= n //
    2`` a step, then compare the one left (``n < 1``: a miss)."""
    top = max(0, flat.shape[0] - 1)
    while bool((n > 1).any()):
        on = n > 1
        h = n >> 1
        x = flat[torch.where(on, base + h, 0).clamp(0, top)]
        base = torch.where(on & (x <= v), base + h, base)
        n = torch.where(on, n - h, n)
    one = n == 1
    return one & (flat[torch.where(one, base, 0).clamp(0, top)] == v)


def count_tiles_ref(flat, s_s, l_s, s_l, l_l, *, d_cand: int, d_targ: int,
                    tile: int | None = None):
    """K3's walk as the kernel does it, in plain PyTorch: ``(cnt
    int32[Q], stats)``, equal to :func:`intersect_count_ref`.

    The clamped candidate cells, row after row, are cut into tiles of
    ``tile`` cells (default ``COUNT_TILE``) by their running sum
    (:func:`hit_offsets`), whatever rows they fall in; a tile's first
    row and each cell's row are the first row whose running sum passes
    the cell.  A tile inside one row searches only the slice of the
    target in ``[vmin, vmax]``, its least and greatest candidate ``>=
    0`` (two searches give that slice); a tile of several rows searches
    each cell's whole target.  Each search is the kernel's halving; the
    hits are summed per row, tile by tile.  ``stats``: the tiles, those
    inside one row, and those whose slice is shorter than their
    target."""
    from repro_torch.kernels.intersect.intersect import COUNT_TILE

    tile = COUNT_TILE if tile is None else int(tile)
    q = s_s.shape[0]
    dev = s_s.device
    cnt = torch.zeros(q, dtype=torch.int32, device=dev)
    ends = hit_offsets(l_s, d_cand=d_cand)[1:]
    cells = int(ends[-1]) if q else 0
    stats = dict(tiles=-(-cells // tile), one_row_tiles=0, narrowed_tiles=0)
    if cells == 0:
        return cnt, stats
    cell = torch.arange(cells, dtype=torch.int64, device=dev)
    t = cell // tile
    first = torch.arange(stats["tiles"], device=dev) * tile
    last = torch.clamp(first + tile, max=cells) - 1
    t_row = torch.searchsorted(ends, first, right=True)
    one = t_row == torch.searchsorted(ends, last, right=True)
    row = torch.searchsorted(ends, cell, right=True)
    ls = l_s.clamp(0, max(0, int(d_cand))).long()
    ll = l_l.clamp(0, max(0, int(d_targ))).long()
    v = flat[s_s[row].long() + cell - (ends[row] - ls[row])].long()
    # a tile inside one row: its candidates' span and the target's slice
    real = v >= 0
    vmin = torch.full((stats["tiles"],), 2**40, dtype=torch.int64,
                      device=dev).scatter_reduce(
        0, t, torch.where(real, v, 2**40), "amin")
    vmax = torch.full((stats["tiles"],), -1, dtype=torch.int64,
                      device=dev).scatter_reduce(
        0, t, torch.where(real, v, -1), "amax")
    tb, tl = s_l[t_row].long(), ll[t_row]
    s0 = _upper_bound(flat, tb, tl, vmin - 1)
    m = _upper_bound(flat, tb, tl, vmax) - s0
    live = one & (vmax >= 0)
    stats["one_row_tiles"] = int(one.sum())
    stats["narrowed_tiles"] = int((live & (m < tl)).sum())
    inside = one[t]
    base = torch.where(inside, (tb + s0)[t], s_l[row].long())
    n = torch.where(real, torch.where(inside, m[t], ll[row]), 0)
    found = _find_halving(flat, base, n, v)
    # per (tile, row) sums, then their sum per row (the kernel's atomics)
    key, part = torch.unique(t[found] * q + row[found], return_counts=True)
    cnt.index_add_(0, key % q, part.to(torch.int32))
    return cnt, stats


# ---------------------------------------------- K1 and K2's item walk


def probe_items_ref(flat, s_s, l_s, s_l, l_l, layout, *, d_cand: int,
                    d_targ: int, level=None, lev_u=None,
                    bitmap_words: int | None = None):
    """K1's and K2's work as the kernels do it, in plain PyTorch:
    ``(offsets, hits, c1, c2)``, the ragged mask of
    :func:`intersect_hits_ref` and, given ``level`` and ``lev_u``, the
    per-row counts of :func:`intersect_levels_ref` (else None).

    ``layout`` is the call's
    :class:`~repro_torch.kernels.intersect.intersect.ItemLayout`, or None
    where every row walks (the binary search of :func:`_found_chunks`).
    Each item's target is set into a bitmap of ``bitmap_words`` 32-bit
    words (default ``BITMAP_WORDS``) over its span ``[targ[0],
    targ[-1]]``, in windows where the span is wider; every cell is looked
    up in the window that holds its id (below the first: the first;
    above the last: the last), and a hit's level split reads
    ``level[cand]``."""
    from repro_torch.kernels.intersect.intersect import BITMAP_WORDS

    win = 32 * (BITMAP_WORDS if bitmap_words is None else int(bitmap_words))
    dev = s_s.device
    q = s_s.shape[0]
    offsets = hit_offsets(l_s, d_cand=d_cand)
    if layout is None:
        ops = (s_s, l_s, s_l, l_l.clamp(max=d_targ))
        steps = search_steps(d_targ)
        hits = probe_hits(flat, *ops, d_cand=d_cand, num_steps=steps)[1]
        if level is None:
            return offsets, hits, None, None
        return (offsets, hits, *split_counts(flat, *ops, level, lev_u,
                                             d_cand=d_cand, num_steps=steps))
    hits = torch.zeros(int(offsets[-1]), dtype=torch.bool, device=dev)
    c1 = c2 = None
    if level is not None:
        c1 = torch.zeros(q, dtype=torch.int32, device=dev)
        c2 = torch.zeros(q, dtype=torch.int32, device=dev)
        lev_ext = torch.cat([
            level, torch.full((1,), -7, dtype=torch.int32, device=dev)
        ])
    perm = layout.perm.long()
    starts = layout.item_start.long()
    for i in range(int(layout.n_items[0])):
        rows = perm[int(starts[i]):int(starts[i + 1])]
        r0 = int(rows[0])
        ll = max(0, min(int(l_l[r0]), d_targ))
        targ = flat[int(s_l[r0]):int(s_l[r0]) + ll].long()
        t_lo, t_hi = (int(targ[0]), int(targ[-1])) if ll else (0, -1)
        span = t_hi - t_lo + 1
        n_win = -(-span // win) if span > win else 1
        ls = l_s[rows].clamp(0, d_cand)
        cand = gather_rows(flat, s_s[rows], ls, width=int(ls.max()),
                           pad=CAND_PAD).long()
        valid = torch.arange(cand.shape[1], device=dev)[None, :] < ls[:, None]
        found = torch.zeros_like(valid)
        for w in range(n_win):
            lo = t_lo + w * win
            hi = min(lo + win, t_hi + 1)
            bm = torch.zeros(win + 1, dtype=torch.bool, device=dev)
            bm[targ[(targ >= 0) & (targ >= lo) & (targ < hi)] - lo] = True
            own = (valid & ((w == 0) | (cand >= lo))
                   & ((w == n_win - 1) | (cand < hi)))
            inside = own & (cand >= 0) & (cand >= lo) & (cand < hi)
            found |= inside & bm[torch.where(inside, cand - lo, win)]
        at = offsets[rows][:, None] + torch.arange(cand.shape[1], device=dev)
        hits[at[valid]] = found[valid]
        if level is not None:
            n = level.shape[0]
            lc = lev_ext[torch.where((cand >= 0) & (cand < n), cand, n)]
            same = lc == lev_u[rows, None]
            c1[rows] = (found & ~same).sum(dim=1, dtype=torch.int32)
            c2[rows] = (found & same).sum(dim=1, dtype=torch.int32)
    return offsets, hits, c1, c2
