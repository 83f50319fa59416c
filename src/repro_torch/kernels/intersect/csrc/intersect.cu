// K1, K2 and K3 for Hopper: sorted-list intersection over CSR bounds.
//
// K1 (intersect_levels_launch) replaces
// repro/kernels/intersect/intersect.py:intersect_pallas (its Pallas body
// _kernel).  K2 (intersect_hits_launch) replaces intersect_pallas_hits
// (its body _hits_kernel).  K3 (intersect_count_launch) replaces
// intersect_pallas_count (its body _count_kernel).  All three read, per
// query row r,
//
//   cand = flat[s_s[r] : s_s[r] + min(l_s[r], d_cand)]   (sorted)
//   targ = flat[s_l[r] : s_l[r] + min(l_l[r], d_targ)]   (sorted)
//
// and test each candidate for membership in targ.  K1 counts the hits,
//
//   c1[r] = #{c in cand : c in targ, level[c] != lev_u[r]}
//   c2[r] = #{c in cand : c in targ, level[c] == lev_u[r]}
//
// which is what intersect_pallas computes on the dense [Q, d_cand] /
// [Q, d_targ] blocks the reference gathers from the same bounds.  K2
// writes the membership mask itself, ragged: candidate j of row r sets
// hits[offsets[r] + j] to 1 (found) or 0, where offsets (int64[Q + 1],
// from the wrapper) is the running sum of min(l_s, d_cand).  That is
// intersect_pallas_hits' bool[Q, d_cand] with the padding cells left
// out.  K3 counts the hits with no level split,
//
//   cnt[r] = #{c in cand : c in targ}  (= K1's c1[r] + c2[r])
//
// the level-free probe of the stream route's batch deltas and of
// Algorithm 2's hedge rounds; it reads no level and writes no mask.
//
// The TPU form (a tiled all-pairs equality cube over the dense blocks)
// does not carry over: at Graph500 scale 18-20 the dense blocks alone
// would be 0.15-1.1 TB and K2's dense mask at scale 20 ~97 GB.  These
// kernels read the adjacency straight from the CSR array instead, and
// nothing of size [Q, d_cand] exists.
//
// What bounds K1 and K2 on this card.  A binary search of the target
// in global memory, one candidate per thread, is 12-16 *dependent*
// loads from L2 or HBM per candidate: latency, not bandwidth.  At RMAT
// scale 20 the widest bucket (2.9 M rows, 3.45e9 candidate cells) made
// 4.3e10 such probes, and its rows share only ~21 k distinct targets
// (~137 rows each), each of which a block-per-row walk staged or
// searched again for every row.  What the inputs need is one test per
// candidate cell and one read of each distinct target: the candidates'
// bytes, streamed, bound the work.
//
// The design.  The wrapper chooses by the call's shape: a bucket no
// wider than WALK_MAX_CAND (256; its rows are short, ~8 share a target
// at scale 20), or a call of fewer than BITMAP_MIN_ROWS (4,096) rows (a
// stream probe's, ~1 row a target), keeps the row walk on every row
// with no layout.  A wider and longer one builds an ItemLayout on the
// card (plain torch ops, no read-back) and sends every live row to the
// bitmap:
//
//   * the live rows (min(l_s, d_cand) > 0) are stably sorted by target
//     (s_l, clamped l_l); each run of one target is cut into work items
//     of whole rows, at most ITEM_CELLS (2**18) cells and kItemRows rows
//     each (a row that crosses a multiple of ITEM_CELLS is an item of
//     its own);
//   * intersect_items (a persistent grid, one 1,024-thread block per SM,
//     that reads the item count from the card) reads an item's target
//     once, coalesced, into a bitmap in shared memory (kBitmapWords
//     words, one bit per vertex id over the target's span [targ[0],
//     targ[last]]), then streams the item's candidates in 16-byte groups
//     aligned in memory, each lane one group per load (scalar loads at a
//     row's two ends), each warp a contiguous run of the item's groups,
//     the next groups in flight while these are looked up, and tests
//     each candidate with one shared-memory lookup: one unsigned compare
//     against the span (a negative id wraps past it), one word.  It
//     clears the words it used (vector stores) before the next item.  A
//     span wider than the bitmap is walked in windows of its size: each
//     candidate is tested in the window that holds its id (ids below
//     the first window in the first, above the last in the last).  K1's
//     level split reads level[c] per hit, a block's reads all in flight
//     at once.  Row counts gather in shared memory (integer adds: their
//     order does not change them) and each row's c1, c2 is written once.
//
// The row walk: a warp per row, the lanes striding over the candidates
// and binary-searching the target in global memory (d_cand <=
// kWarpMaxCand), or a block per row that stages a target of at most
// kStageCap entries in shared memory and searches a longer one in
// global memory.
//
// Every output is written once by one thread, with a plain store: no
// atomics on the outputs (only on shared memory: the bitmap's bits and
// the row counts), and the same bits on every launch.  Sentinel
// and masked rows carry l_s = l_l = 0 and touch nothing (the K1 wrapper
// zeroes its outputs).  Index math within the adjacency is int32:
// offsets into flat stay below the slot count (< 2**31, enforced when
// the graph is built); K2's output index is int64 (one bucket's mask at
// scale 20 holds 3.45e9 cells).  The windows' bounds are int64, so any
// id below 2**31 is reached.
//
// K3 (intersect_count_launch) keeps the row walk alone, a warp or a
// block per row, one per row of its grid.
//
// Plain C interface (built with nvcc into a shared library, bound with
// ctypes); each entry point launches on the given stream and returns
// cudaGetLastError() so a refused launch is never silent.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerWarpBlock = 8;       // warp kernels: 256 threads
constexpr int kBlockThreads = 512;         // block kernels
constexpr int kWarpMaxCand = 256;          // widest bucket run warp-per-row
constexpr int kStageCap = 4096;            // block kernels' staged target
                                           // (16 KB: four blocks per SM)
constexpr int kItemThreads = 1024;         // bitmap kernels: one block/SM
constexpr int kItemWarps = kItemThreads / kWarp;
constexpr int kItemRows = 512;             // = intersect.py ITEM_ROWS
constexpr int kBitmapWords = 53248;        // = intersect.py BITMAP_WORDS:
                                           // 208 KB, 1,703,936 ids a window
constexpr int kBitmapBytes = kBitmapWords * 4;
constexpr int kGroups = 2;                 // 16-byte groups a lane loads
                                           // ahead

// Lower-bound membership test of key in a[0:len] (a sorted).
__device__ __forceinline__ bool contains_global(const int* __restrict__ a,
                                                int len, int key) {
  int lo = 0, hi = len;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (__ldg(a + mid) < key) lo = mid + 1; else hi = mid;
  }
  return lo < len && __ldg(a + lo) == key;
}

__device__ __forceinline__ bool contains_shared(const int* a, int len,
                                                int key) {
  int lo = 0, hi = len;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (a[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo < len && a[lo] == key;
}

// The two row walks.  Each calls visit(j, c, found) once for every
// candidate j < ls of the row (c = cand[j]), from the thread that owns j.

// Warp mapping: the 32 lanes stride over the candidates; d_cand <=
// kWarpMaxCand, so each lane takes at most 8.
template <class Visit>
__device__ __forceinline__ void warp_walk(const int* __restrict__ cand,
                                          int ls,
                                          const int* __restrict__ targ,
                                          int ll, int lane, Visit visit) {
  for (int j = lane; j < ls; j += kWarp) {
    const int c = __ldg(cand + j);
    visit(j, c, c >= 0 && contains_global(targ, ll, c));
  }
}

// Block mapping: the target slice is staged in shared memory when it has
// at most kStageCap entries (a block-uniform branch), and the block's
// threads stride over the candidates.
template <class Visit>
__device__ __forceinline__ void block_walk(int* stage,
                                           const int* __restrict__ cand,
                                           int ls,
                                           const int* __restrict__ targ,
                                           int ll, Visit visit) {
  if (ll <= kStageCap) {
#pragma unroll 4
    for (int j = threadIdx.x; j < ll; j += kBlockThreads)
      stage[j] = __ldg(targ + j);
    __syncthreads();
    for (int j = threadIdx.x; j < ls; j += kBlockThreads) {
      const int c = __ldg(cand + j);
      visit(j, c, c >= 0 && contains_shared(stage, ll, c));
    }
  } else {
    for (int j = threadIdx.x; j < ls; j += kBlockThreads) {
      const int c = __ldg(cand + j);
      visit(j, c, c >= 0 && contains_global(targ, ll, c));
    }
  }
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ void tally(int c, const int* __restrict__ level,
                                      int n_level, int lu, int& a, int& b) {
  int lc = (c < n_level) ? __ldg(level + c) : -7;
  if (lc == lu) ++b; else ++a;
}

// level[c], -7 for an id outside level (the TPU kernel's pad).
__device__ __forceinline__ int level_of(const int* __restrict__ level,
                                        int n_level, int c) {
  return (c >= 0 && c < n_level) ? __ldg(level + c) : -7;
}

// ------------------------------------------------------------ K1 and K2

// One launch's operands: the rows, the wrapper's ItemLayout and the
// outputs of K1 (c1, c2) or K2 (hits).
struct Probe {
  const int* flat;
  const int* s_s;
  const int* l_s;
  const int* s_l;
  const int* l_l;
  int q, d_cand, d_targ;
  const int* perm;        // the live rows by target (null: no layout,
                          // every row walks)
  const int64_t* cum;     // 16-byte groups before each position of perm
  const int* item_start;  // item i owns perm[item_start[i] : ...[i + 1]]
  const int* n_items;     // the item count (on the card)
  const int* level;       // K1
  int n_level;
  const int* lev_u;
  int* c1;
  int* c2;
  const int64_t* offsets;  // K2
  uint8_t* hits;
};

// Set the bits of the target entries with ids in the window [lo, hi).
__device__ __forceinline__ void set_target(uint32_t* bm,
                                           const int* __restrict__ targ,
                                           int ll, int64_t lo, int64_t hi) {
  for (int j = threadIdx.x; j < ll; j += kItemThreads) {
    const int t = __ldg(targ + j);
    if (t < 0 || t < lo || t >= hi) continue;
    const uint32_t pos = static_cast<uint32_t>(t - lo);
    atomicOr(bm + (pos >> 5), 1u << (pos & 31));
  }
}

// Zero the words that ids [0, n) of a window use, 16 bytes a store
// (cheaper than reading the target again).
__device__ __forceinline__ void clear_words(uint32_t* bm, int64_t n) {
  const int words = static_cast<int>(
      min((n + 127) / 128 * 4, static_cast<int64_t>(kBitmapWords)));
  uint4* v = reinterpret_cast<uint4*>(bm);
  for (int i = threadIdx.x; i < words / 4; i += kItemThreads)
    v[i] = make_uint4(0u, 0u, 0u, 0u);
}

// An item's rows in shared memory.  The item's candidates are cut into
// 16-byte groups aligned in memory: with F = flat index + align (align =
// the flat pointer's offset from 16 bytes, in ints), group G holds F in
// [4 G, 4 G + 4).  Row i owns the item's groups pre[i] .. pre[i + 1] - 1,
// group g of them is G = gb[i] + g, and its candidates are F in [beg[i],
// end[i]).
template <bool kLevels>
struct ItemRows {
  int pre[kItemRows + 1];
  int gb[kItemRows];
  int beg[kItemRows];
  int end[kItemRows];
  int rid[kLevels ? kItemRows : 1];            // K1: the row's id
  int lus[kLevels ? kItemRows : 1];            // K1: its lev_u
  unsigned long long cnt[kLevels ? kItemRows : 1];  // K1: c1 | c2 << 32
  long long out[kLevels ? 1 : kItemRows];      // K2: F's byte, hits[out + F]
};

// One warp's run [g_begin, g_end) of an item's groups against the bitmap
// of the window [lo, hi).  Lane l takes groups g_begin
// + l, + 32, ..., so each load of the warp reads 512 consecutive bytes of
// a row, one 16-byte load a lane (scalar loads at a row's two ends), and
// it follows its rows by stepping (an item holds at most kItemRows
// rows).  The next kGroups groups load while this block's are looked
// up, and a block's level reads are all issued before any is used.
// kOne: one window and lo >= 0, where one unsigned compare tests the
// span (a negative id wraps past it).
template <bool kLevels, bool kOne>
__device__ __forceinline__ void probe_groups(
    const Probe& a, int align, const uint32_t* bm,
    ItemRows<kLevels>& sr, int rows, int g_begin, int g_end, int64_t lo,
    int64_t hi, bool first_win, bool last_win) {
  constexpr int kStep = kWarp * kGroups;
  const int g_first = g_begin + static_cast<int>(threadIdx.x % kWarp);
  if (g_first >= g_end) return;  // no warp-wide step below
  int row = 0, top = rows;  // the last row i with pre[i] <= g_first
  while (top - row > 1) {
    const int mid = (row + top) >> 1;
    if (sr.pre[mid] <= g_first) row = mid; else top = mid;
  }
  int next = sr.pre[row + 1], base = sr.gb[row];
  int beg = sr.beg[row], end = sr.end[row];
  const int4* __restrict__ flat4 =
      reinterpret_cast<const int4*>(a.flat - align);
  // the row, group and candidates (-1 outside the row) of this lane's
  // kGroups groups from g0
  auto fetch = [&](int g0, int (&rw)[kGroups], int (&grp)[kGroups],
                   int4 (&c)[kGroups]) {
#pragma unroll
    for (int u = 0; u < kGroups; ++u) {
      const int g = g0 + u * kWarp;
      c[u] = make_int4(-1, -1, -1, -1);
      rw[u] = row;
      grp[u] = 0;
      if (g < g_end) {
        while (next <= g) {
          ++row;
          next = sr.pre[row + 1];
          base = sr.gb[row];
          beg = sr.beg[row];
          end = sr.end[row];
        }
        const int G = base + g;
        rw[u] = row;
        grp[u] = G;
        if (4 * G >= beg && 4 * G + 4 <= end) {
          c[u] = __ldg(flat4 + G);
        } else {
          const int* f = a.flat - align + 4 * G;
          if (4 * G + 0 >= beg && 4 * G + 0 < end) c[u].x = __ldg(f + 0);
          if (4 * G + 1 >= beg && 4 * G + 1 < end) c[u].y = __ldg(f + 1);
          if (4 * G + 2 >= beg && 4 * G + 2 < end) c[u].z = __ldg(f + 2);
          if (4 * G + 3 >= beg && 4 * G + 3 < end) c[u].w = __ldg(f + 3);
        }
      }
    }
  };
  const uint32_t lo32 = static_cast<uint32_t>(lo);
  const uint32_t span32 = static_cast<uint32_t>(hi - lo);
  auto lookup = [&](int v) -> uint32_t {  // the id's bit, at bit 0
    uint32_t d;
    bool in;
    if constexpr (kOne) {
      d = static_cast<uint32_t>(v) - lo32;
      in = d < span32;
    } else {
      in = v >= 0 && v >= lo && v < hi;
      d = static_cast<uint32_t>(v - lo);
    }
    return in ? bm[d >> 5] >> (d & 31) : 0u;
  };
  int rn[kGroups], gn[kGroups];
  int4 cn[kGroups];
  fetch(g_first, rn, gn, cn);
  int cur = -1, lu_cur = 0;
  unsigned long long acc = 0ull;  // c1 | c2 << 32 of row cur, this lane
  for (int g0 = g_first; g0 < g_end; g0 += kStep) {
    int rw[kGroups], grp[kGroups];
    int4 c[kGroups];
#pragma unroll
    for (int u = 0; u < kGroups; ++u) {
      rw[u] = rn[u];
      grp[u] = gn[u];
      c[u] = cn[u];
    }
    if (g0 + kStep < g_end) fetch(g0 + kStep, rn, gn, cn);
#pragma unroll
    for (int u = 0; u < kGroups; ++u) {
      const int v[4] = {c[u].x, c[u].y, c[u].z, c[u].w};
      uint32_t word[4];  // 0: a miss, outside the row, or a tail group
#pragma unroll
      for (int e = 0; e < 4; ++e) word[e] = lookup(v[e]);
      if constexpr (kLevels) {
        int lv[4];  // level[c] of the hits, all in flight
#pragma unroll
        for (int e = 0; e < 4; ++e)
          lv[e] = (word[e] & 1u) ? level_of(a.level, a.n_level, v[e]) : 0;
        if ((word[0] | word[1] | word[2] | word[3]) & 1u) {
          if (rw[u] != cur) {
            if (acc) atomicAdd(sr.cnt + cur, acc);
            cur = rw[u];
            lu_cur = sr.lus[cur];
            acc = 0ull;
          }
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (word[e] & 1u) acc += lv[e] == lu_cur ? (1ull << 32) : 1ull;
        }
      } else {
        if (g0 + u * kWarp >= g_end) continue;
        const int r = rw[u];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int f = 4 * grp[u] + e;
          if (f >= sr.beg[r] && f < sr.end[r] &&
              (kOne || ((first_win || v[e] >= lo) && (last_win || v[e] < hi))))
            a.hits[sr.out[r] + f] = word[e] & 1u;
        }
      }
    }
  }
  if constexpr (kLevels) {
    if (acc) atomicAdd(sr.cnt + cur, acc);
  }
}

// The bitmap items: a persistent grid reads the item count from the
// card and each block takes items blockIdx.x, + gridDim.x, ...
template <bool kLevels>
__global__ void __launch_bounds__(kItemThreads, 1)
intersect_items(const Probe a) {
  extern __shared__ __align__(16) uint32_t bm[];  // zero between items
  __shared__ ItemRows<kLevels> sr;
  const int tid = threadIdx.x;
  const int warp = tid / kWarp;
  const int align = static_cast<int>(
      (reinterpret_cast<uintptr_t>(a.flat) / sizeof(int)) % 4);
  for (int i = tid; i < kBitmapWords; i += kItemThreads) bm[i] = 0u;
  const int n_items = a.n_items[0];
  for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
    const int p0 = a.item_start[it];
    const int rows = a.item_start[it + 1] - p0;
    const int64_t c0 = a.cum[p0];
    const int groups = static_cast<int>(a.cum[p0 + rows] - c0);
    const int first = a.perm[p0];
    const int* __restrict__ targ = a.flat + a.s_l[first];
    const int ll = max(0, min(a.l_l[first], a.d_targ));
    for (int i = tid; i <= rows; i += kItemThreads) {
      const int g = static_cast<int>(a.cum[p0 + i] - c0);
      sr.pre[i] = g;
      if (i < rows) {
        const int r = a.perm[p0 + i];
        const int f = a.s_s[r] + align;
        sr.gb[i] = (f >> 2) - g;
        sr.beg[i] = f;
        sr.end[i] = f + max(0, min(a.l_s[r], a.d_cand));
        if constexpr (kLevels) {
          sr.rid[i] = r;
          sr.lus[i] = a.lev_u[r];
          sr.cnt[i] = 0ull;
        } else {
          sr.out[i] = a.offsets[r] - f;
        }
      }
    }
    const int t_lo = ll > 0 ? __ldg(targ) : 0;
    const int t_hi = ll > 0 ? __ldg(targ + ll - 1) : -1;
    const int64_t span = static_cast<int64_t>(t_hi) - t_lo + 1;
    constexpr int64_t win = static_cast<int64_t>(kBitmapWords) * 32;
    const int n_win =
        span > win ? static_cast<int>((span + win - 1) / win) : 1;
    // each warp a contiguous run of the item's groups, a multiple of 32
    const int per_warp =
        ((groups + kItemWarps - 1) / kItemWarps + kWarp - 1) / kWarp * kWarp;
    const int g_begin = min(groups, warp * per_warp);
    const int g_end = min(groups, g_begin + per_warp);
    for (int w = 0; w < n_win; ++w) {
      const int64_t lo = t_lo + w * win;
      const int64_t hi = min(lo + win, static_cast<int64_t>(t_hi) + 1);
      __syncthreads();  // rows staged; the last window's bits cleared
      set_target(bm, targ, ll, lo, hi);
      __syncthreads();
      if (n_win == 1 && t_lo >= 0)
        probe_groups<kLevels, true>(a, align, bm, sr, rows, g_begin, g_end,
                                    lo, hi, true, true);
      else
        probe_groups<kLevels, false>(a, align, bm, sr, rows, g_begin, g_end,
                                     lo, hi, w == 0, w == n_win - 1);
      __syncthreads();
      clear_words(bm, hi - lo);
    }
    if constexpr (kLevels) {
      for (int i = tid; i < rows; i += kItemThreads) {
        a.c1[sr.rid[i]] = static_cast<int>(sr.cnt[i] & 0xffffffffull);
        a.c2[sr.rid[i]] = static_cast<int>(sr.cnt[i] >> 32);
      }
    }
    __syncthreads();  // before the next item stages its rows
  }
}

// The row walk, over every row: a warp per row ...
template <bool kLevels>
__global__ void __launch_bounds__(kWarp * kRowsPerWarpBlock)
walk_rows_warp(const Probe a) {
  const int row = blockIdx.x * kRowsPerWarpBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= a.q) return;  // uniform across the warp
  const int* cand = a.flat + a.s_s[row];
  const int ls = min(a.l_s[row], a.d_cand);
  const int* targ = a.flat + a.s_l[row];
  const int ll = min(a.l_l[row], a.d_targ);
  if constexpr (kLevels) {
    const int lu = a.lev_u[row];
    int x = 0, y = 0;
    warp_walk(cand, ls, targ, ll, lane, [&](int, int c, bool found) {
      if (found) tally(c, a.level, a.n_level, lu, x, y);
    });
    x = warp_sum(x);
    y = warp_sum(y);
    if (lane == 0) {
      a.c1[row] = x;
      a.c2[row] = y;
    }
  } else {
    uint8_t* __restrict__ o = a.hits + a.offsets[row];
    warp_walk(cand, ls, targ, ll, lane,
              [&](int j, int, bool found) { o[j] = found; });
  }
}

// ... or a block per row.
template <bool kLevels>
__global__ void __launch_bounds__(kBlockThreads)
walk_rows_block(const Probe a) {
  __shared__ int stage[kStageCap];
  __shared__ int red_a[kBlockThreads / kWarp];
  __shared__ int red_b[kBlockThreads / kWarp];
  const int row = blockIdx.x;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int* cand = a.flat + a.s_s[row];
  const int ls = min(a.l_s[row], a.d_cand);
  const int* targ = a.flat + a.s_l[row];
  const int ll = min(a.l_l[row], a.d_targ);
  if constexpr (kLevels) {
    const int lu = a.lev_u[row];
    int x = 0, y = 0;
    block_walk(stage, cand, ls, targ, ll, [&](int, int c, bool found) {
      if (found) tally(c, a.level, a.n_level, lu, x, y);
    });
    x = warp_sum(x);
    y = warp_sum(y);
    if (lane == 0) {
      red_a[warp] = x;
      red_b[warp] = y;
    }
    __syncthreads();
    if (warp == 0) {
      x = warp_sum(lane < kBlockThreads / kWarp ? red_a[lane] : 0);
      y = warp_sum(lane < kBlockThreads / kWarp ? red_b[lane] : 0);
      if (lane == 0) {
        a.c1[row] = x;
        a.c2[row] = y;
      }
    }
  } else {
    uint8_t* __restrict__ o = a.hits + a.offsets[row];
    block_walk(stage, cand, ls, targ, ll,
               [&](int j, int, bool found) { o[j] = found; });
  }
}

int sm_count() {
  static const int n = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v > 0 ? v : 132;
  }();
  return n;
}

// The bitmap items with a layout, else the row walk over every row: one
// launch either way.
template <bool kLevels>
int launch_probe(const Probe& a, cudaStream_t st) {
  const int q = a.q;
  if (a.perm) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        intersect_items<kLevels>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kBitmapBytes);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    intersect_items<kLevels><<<min(q, sm_count()), kItemThreads,
                               kBitmapBytes, st>>>(a);
  } else if (a.d_cand <= kWarpMaxCand) {
    const int blocks = (q + kRowsPerWarpBlock - 1) / kRowsPerWarpBlock;
    walk_rows_warp<kLevels><<<blocks, kWarp * kRowsPerWarpBlock, 0, st>>>(a);
  } else {
    walk_rows_block<kLevels><<<q, kBlockThreads, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------------ K3

__global__ void __launch_bounds__(kWarp * kRowsPerWarpBlock)
intersect_count_warp(const int* __restrict__ flat,
                     const int* __restrict__ s_s,
                     const int* __restrict__ l_s,
                     const int* __restrict__ s_l,
                     const int* __restrict__ l_l, int q, int d_cand,
                     int d_targ, int* __restrict__ cnt) {
  const int row = blockIdx.x * kRowsPerWarpBlock + (threadIdx.x / kWarp);
  const int lane = threadIdx.x % kWarp;
  if (row >= q) return;  // uniform across the warp
  int a = 0;
  warp_walk(flat + s_s[row], min(l_s[row], d_cand), flat + s_l[row],
            min(l_l[row], d_targ), lane,
            [&](int, int, bool found) { a += found; });
  a = warp_sum(a);
  if (lane == 0) cnt[row] = a;
}

__global__ void __launch_bounds__(kBlockThreads)
intersect_count_block(const int* __restrict__ flat,
                      const int* __restrict__ s_s,
                      const int* __restrict__ l_s,
                      const int* __restrict__ s_l,
                      const int* __restrict__ l_l, int d_cand, int d_targ,
                      int* __restrict__ cnt) {
  __shared__ int stage[kStageCap];
  __shared__ int red[kBlockThreads / kWarp];
  const int row = blockIdx.x;
  int a = 0;
  block_walk(stage, flat + s_s[row], min(l_s[row], d_cand), flat + s_l[row],
             min(l_l[row], d_targ),
             [&](int, int, bool found) { a += found; });
  a = warp_sum(a);
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (lane == 0) red[warp] = a;
  __syncthreads();
  if (warp == 0) {
    a = warp_sum(lane < kBlockThreads / kWarp ? red[lane] : 0);
    if (lane == 0) cnt[row] = a;
  }
}

}  // namespace

extern "C" {

// Launch K1 over q rows, laid out by the wrapper's ItemLayout (perm,
// cum, item_start, n_items), or all on the row walk where perm is null.
// c1 and c2 hold zeros on entry.  Returns a
// cudaError_t (0 = launched).
int intersect_levels_launch(const int* flat, const int* s_s, const int* l_s,
                            const int* s_l, const int* l_l,
                            const int* level, int n_level, const int* lev_u,
                            const int* perm, const int64_t* cum,
                            const int* item_start, const int* n_items,
                            int q, int d_cand, int d_targ, int* c1, int* c2,
                            void* stream) {
  if (q <= 0) return 0;
  Probe a{};
  a.flat = flat;
  a.s_s = s_s;
  a.l_s = l_s;
  a.s_l = s_l;
  a.l_l = l_l;
  a.q = q;
  a.d_cand = d_cand;
  a.d_targ = d_targ;
  a.perm = perm;
  a.cum = cum;
  a.item_start = item_start;
  a.n_items = n_items;
  a.level = level;
  a.n_level = n_level;
  a.lev_u = lev_u;
  a.c1 = c1;
  a.c2 = c2;
  return launch_probe<true>(a, static_cast<cudaStream_t>(stream));
}

// Launch K2 over q rows into hits[0 : offsets[q]] (one byte per clamped
// candidate), laid out as K1.  Returns a cudaError_t (0 = launched).
int intersect_hits_launch(const int* flat, const int* s_s, const int* l_s,
                          const int* s_l, const int* l_l,
                          const int64_t* offsets, const int* perm,
                          const int64_t* cum, const int* item_start,
                          const int* n_items, int q, int d_cand, int d_targ,
                          uint8_t* hits, void* stream) {
  if (q <= 0) return 0;
  Probe a{};
  a.flat = flat;
  a.s_s = s_s;
  a.l_s = l_s;
  a.s_l = s_l;
  a.l_l = l_l;
  a.q = q;
  a.d_cand = d_cand;
  a.d_targ = d_targ;
  a.perm = perm;
  a.cum = cum;
  a.item_start = item_start;
  a.n_items = n_items;
  a.offsets = offsets;
  a.hits = hits;
  return launch_probe<false>(a, static_cast<cudaStream_t>(stream));
}

// Launch K3 over q rows into cnt[0 : q].  Returns a cudaError_t (0 =
// launched).
int intersect_count_launch(const int* flat, const int* s_s, const int* l_s,
                           const int* s_l, const int* l_l, int q, int d_cand,
                           int d_targ, int* cnt, void* stream) {
  if (q <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d_cand <= kWarpMaxCand) {
    const int blocks = (q + kRowsPerWarpBlock - 1) / kRowsPerWarpBlock;
    intersect_count_warp<<<blocks, kWarp * kRowsPerWarpBlock, 0, st>>>(
        flat, s_s, l_s, s_l, l_l, q, d_cand, d_targ, cnt);
    return static_cast<int>(cudaGetLastError());
  }
  intersect_count_block<<<q, kBlockThreads, 0, st>>>(
      flat, s_s, l_s, s_l, l_l, d_cand, d_targ, cnt);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
