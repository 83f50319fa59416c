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
// K1's and K2's outputs are written once by one thread, with a plain
// store: no atomics on them (only on shared memory: the bitmap's bits and
// the row counts), and the same bits on every launch.  Sentinel
// and masked rows carry l_s = l_l = 0 and touch nothing (the K1 wrapper
// zeroes its outputs).  Index math within the adjacency is int32:
// offsets into flat stay below the slot count (< 2**31, enforced when
// the graph is built); K2's output index is int64 (one bucket's mask at
// scale 20 holds 3.45e9 cells).  The windows' bounds are int64, so any
// id below 2**31 is reached.
//
// K3 (intersect_count_launch) counts with no level split, at two kinds
// of call: the stream route's delta probes (2,048 rows at the default
// buffer, 32,768 at a 65,536-update one; d_cand up to 16,384 and
// d_targ 65,536 at RMAT scale 20, yet a median row of ~139 candidates)
// and the count's buckets run level-free (Algorithm 2's hedge rounds).
// What bound its first form, a warp or a 512-thread block per row chosen
// by the bucket's width: a block idled on a short row; every row staged
// a target of up to 4,096 entries for a few lookups; a longer target was
// binary-searched in global memory (12-16 dependent loads a candidate,
// a third of a delete probe's cells); rows that share a target read it
// again each (a 32,768-row probe: 132 M target entries summed over the
// rows, 15 M read once).  Now the wrapper chooses by the call's shape
// (intersect.py:count_path), with three kernels.  A call no wider than
// WALK_MAX_CAND keeps the warp per row (the count's narrow and middle
// buckets: on rows of at most 256 candidates it beat the tiles below).
// A wider call of at least COUNT_BITMAP_MIN_ROWS rows builds an
// ItemLayout and runs the bitmap items (a third instance that gathers
// each row's count in shared memory with no level read and writes it
// once).  Any other wider call (a stream probe's) runs a walk balanced
// by the rows' own lengths (count_tiles): the call's clamped candidate
// cells cut into tiles of kTile, by the running sum of the rows' counts,
// whatever rows they fall in, so a short row costs a few lanes and a hub
// row many warps.  A tile inside one row bounds its candidates and finds
// the slice of the target they span with two searches; each lane then
// searches its six cells in that slice, or in a tile of several rows in
// each cell's own target, the six searches in step (six loads in
// flight).  The running sum is the launch's own: one cooperative launch
// sums, syncs its grid and walks, with no read-back.  Counts are added
// with integer atomics, so each row's is exact and the same on every
// launch.  The block per row stays for a forced row walk.
//
// Plain C interface (built with nvcc into a shared library, bound with
// ctypes); each entry point launches on the given stream and returns
// cudaGetLastError() so a refused launch is never silent.

#include <algorithm>
#include <climits>
#include <cooperative_groups.h>
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
constexpr int kTileLane = 6;               // K3's walk: cells a lane takes
constexpr int kTile = kWarp * kTileLane;   // = intersect.py COUNT_TILE
constexpr int kTileWarps = 8;              // its 256-thread blocks
constexpr int kScanThreads = 256;          // K3's running sum of the rows'
constexpr int kScanPer = 8;                // cells: rows a thread takes,
constexpr int kScanRows = kScanThreads * kScanPer;  // = COUNT_SCAN_ROWS
constexpr unsigned kFull = 0xffffffffu;

// What an instance of the bitmap items computes: K1's c1 and c2, K2's
// mask or K3's count.
enum : int { kK1, kK2, kK3 };

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
  int* cnt;                // K3
  const long long* ends;   // K3's walk: ends[r], the running sum of the
                           // clamped candidate counts of rows 0..r, so
                           // cell c is candidate c - ends[r - 1] of the
                           // row r with ends[r - 1] <= c < ends[r]
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
template <int M>
struct ItemRows {
  int pre[kItemRows + 1];
  int gb[kItemRows];
  int beg[kItemRows];
  int end[kItemRows];
  int rid[M != kK2 ? kItemRows : 1];           // K1, K3: the row's id
  int lus[M == kK1 ? kItemRows : 1];           // K1: its lev_u
  unsigned long long cnt[M != kK2 ? kItemRows : 1];  // K1: c1 | c2 << 32;
                                                     // K3: the count
  long long out[M == kK2 ? kItemRows : 1];     // K2: F's byte, hits[out + F]
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
template <int M, bool kOne>
__device__ __forceinline__ void probe_groups(
    const Probe& a, int align, const uint32_t* bm,
    ItemRows<M>& sr, int rows, int g_begin, int g_end, int64_t lo,
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
      if constexpr (M != kK2) {
        int lv[4];  // K1: level[c] of the hits, all in flight
#pragma unroll
        for (int e = 0; e < 4; ++e)
          lv[e] = (M == kK1 && (word[e] & 1u))
                      ? level_of(a.level, a.n_level, v[e]) : 0;
        if ((word[0] | word[1] | word[2] | word[3]) & 1u) {
          if (rw[u] != cur) {
            if (acc) atomicAdd(sr.cnt + cur, acc);
            cur = rw[u];
            if constexpr (M == kK1) lu_cur = sr.lus[cur];
            acc = 0ull;
          }
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (word[e] & 1u)
              acc += (M == kK1 && lv[e] == lu_cur) ? (1ull << 32) : 1ull;
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
  if constexpr (M != kK2) {
    if (acc) atomicAdd(sr.cnt + cur, acc);
  }
}

// The bitmap items: a persistent grid reads the item count from the
// card and each block takes items blockIdx.x, + gridDim.x, ...
template <int M>
__global__ void __launch_bounds__(kItemThreads, 1)
intersect_items(const Probe a) {
  extern __shared__ __align__(16) uint32_t bm[];  // zero between items
  __shared__ ItemRows<M> sr;
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
        if constexpr (M != kK2) {
          sr.rid[i] = r;
          if constexpr (M == kK1) sr.lus[i] = a.lev_u[r];
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
        probe_groups<M, true>(a, align, bm, sr, rows, g_begin, g_end, lo, hi,
                              true, true);
      else
        probe_groups<M, false>(a, align, bm, sr, rows, g_begin, g_end, lo,
                               hi, w == 0, w == n_win - 1);
      __syncthreads();
      clear_words(bm, hi - lo);
    }
    if constexpr (M == kK1) {
      for (int i = tid; i < rows; i += kItemThreads) {
        a.c1[sr.rid[i]] = static_cast<int>(sr.cnt[i] & 0xffffffffull);
        a.c2[sr.rid[i]] = static_cast<int>(sr.cnt[i] >> 32);
      }
    } else if constexpr (M == kK3) {
      for (int i = tid; i < rows; i += kItemThreads)
        a.cnt[sr.rid[i]] = static_cast<int>(sr.cnt[i] & 0xffffffffull);
    }
    __syncthreads();  // before the next item stages its rows
  }
}

// The row walk, over every row: a warp per row ...
template <int M>
__global__ void __launch_bounds__(kWarp * kRowsPerWarpBlock)
walk_rows_warp(const Probe a) {
  const int row = blockIdx.x * kRowsPerWarpBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= a.q) return;  // uniform across the warp
  const int* cand = a.flat + a.s_s[row];
  const int ls = min(a.l_s[row], a.d_cand);
  const int* targ = a.flat + a.s_l[row];
  const int ll = min(a.l_l[row], a.d_targ);
  if constexpr (M == kK1) {
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
  } else if constexpr (M == kK3) {
    int x = 0;
    warp_walk(cand, ls, targ, ll, lane,
              [&](int, int, bool found) { x += found; });
    x = warp_sum(x);
    if (lane == 0) a.cnt[row] = x;
  } else {
    uint8_t* __restrict__ o = a.hits + a.offsets[row];
    warp_walk(cand, ls, targ, ll, lane,
              [&](int j, int, bool found) { o[j] = found; });
  }
}

// ... or a block per row.
template <int M>
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
  if constexpr (M != kK2) {
    const int lu = M == kK1 ? a.lev_u[row] : 0;
    int x = 0, y = 0;  // K3: y stays 0
    block_walk(stage, cand, ls, targ, ll, [&](int, int c, bool found) {
      if (!found) return;
      if constexpr (M == kK1) tally(c, a.level, a.n_level, lu, x, y);
      else ++x;
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
        if constexpr (M == kK1) {
          a.c1[row] = x;
          a.c2[row] = y;
        } else {
          a.cnt[row] = x;
        }
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

// ------------------------------------------------------------------ K3

__device__ __forceinline__ int cells_of(const int* __restrict__ l_s, int r,
                                        int q, int d_cand) {
  return r < q ? max(0, min(__ldg(l_s + r), d_cand)) : 0;
}

// Over a block of kScanThreads: the sum of v over the threads before this
// one, and in total over all of them.  sh holds kScanThreads / kWarp
// words of shared memory, free again on return.
__device__ __forceinline__ long long scan_block(long long v, long long* sh,
                                                long long& total) {
  const int lane = threadIdx.x % kWarp, w = threadIdx.x / kWarp;
  long long inc = v;
#pragma unroll
  for (int o = 1; o < kWarp; o <<= 1) {
    const long long y = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == kWarp - 1) sh[w] = inc;
  __syncthreads();
  long long before = 0;
  total = 0;
#pragma unroll
  for (int i = 0; i < kScanThreads / kWarp; ++i) {
    before += i < w ? sh[i] : 0;
    total += sh[i];
  }
  __syncthreads();
  return before + inc - v;
}

// The first i in (lo, hi] with key < a[i], given a[lo] <= key < a[hi]
// (lo may be -1 and hi the array's length: those two are never read).
// Each half of the warp searches with its own key, lo and hi, 16 ways a
// round: one load a lane, one ballot.
// Loads for the searches: the target read-only (__ldg); the running sum,
// which the launch writes itself, through L2 (__ldcg).
__device__ __forceinline__ int ld(const int* p) { return __ldg(p); }
__device__ __forceinline__ long long ld(const long long* p) {
  return __ldcg(p);
}

template <class T>
__device__ __forceinline__ int upper_bound16(const T* __restrict__ a, int lo,
                                             int hi, T key) {
  const int sub = threadIdx.x % 16;
  const int half = threadIdx.x % kWarp & 16;
  while (__any_sync(kFull, hi - lo > 1)) {
    const int p = lo + static_cast<int>(
                           (static_cast<int64_t>(hi - lo) * (sub + 1)) >> 4);
    const bool le = sub != 15 && (p == lo || ld(a + p) <= key);
    const unsigned k = __popc((__ballot_sync(kFull, le) >> half) & 0xffffu);
    const int nlo =
        __shfl_sync(kFull, p, half + max(static_cast<int>(k) - 1, 0));
    hi = __shfl_sync(kFull, p, half + k);
    lo = k ? nlo : lo;
  }
  return hi;
}

// Whether each cell's v[k] is in p[base[k] : base[k] + len[k]] (sorted):
// every range halved in step with the others, so all of a lane's loads of
// one step are in flight at once.  A cell with len[k] < 1 is a miss.
__device__ __forceinline__ unsigned find_cells(const int* __restrict__ p,
                                               const int (&v)[kTileLane],
                                               int (&base)[kTileLane],
                                               int (&len)[kTileLane]) {
  auto at = [&](int i) { return __ldg(p + i); };
  for (bool more = true; more;) {
    int x[kTileLane];
#pragma unroll
    for (int k = 0; k < kTileLane; ++k)
      x[k] = len[k] > 1 ? at(base[k] + (len[k] >> 1)) : 0;
    more = false;
#pragma unroll
    for (int k = 0; k < kTileLane; ++k) {
      if (len[k] > 1) {
        const int h = len[k] >> 1;
        if (x[k] <= v[k]) base[k] += h;  // the last entry <= v stays in
        len[k] -= h;
        more |= len[k] > 1;
      }
    }
  }
  unsigned hit = 0;
#pragma unroll
  for (int k = 0; k < kTileLane; ++k)
    if (len[k] == 1 && at(base[k]) == v[k]) hit |= 1u << k;
  return hit;
}

// The walk, one cooperative launch in three phases.  1: each chunk of
// kScanRows rows writes its rows' running sum of clamped cells (ends,
// inclusive, within the chunk), its total and its rows' zero counts.  2:
// each chunk after the first adds the totals of the chunks before it.
// Each phase ends in a grid-wide sync.  3: the call's cells cut into
// tiles of kTile, whatever rows they fall in, and the warps of the grid
// (all resident at once: a cooperative launch) taking tiles t = warp, +
// warps, ....  Lane l takes a tile's cells l, l + 32, ... (coalesced
// within a row).  A warp finds the row of its tile's first cell by a
// search of ends, then resolves its cells' rows a window of 32 rows at a
// time (each lane loads one row's bounds; a cell finds its lane by five
// shuffles, and a slot k that every lane has resolved is skipped); the
// next window is the next 32 rows, or a search where a window resolved
// nothing (a run of sentinel rows).  A tile inside one row bounds its
// candidates [vmin, vmax] (vmin the least id >= 0) and finds the slice of
// the target in that range with two searches (one per half-warp); each
// cell then searches that slice alone.  A tile of several rows searches
// each cell's own target, all in global memory.  Row counts are added
// with integer atomics (a tile inside one row: one add), so the order in
// which warps finish does not change them.
__global__ void __launch_bounds__(kTileWarps * kWarp)
count_tiles(const Probe a, long long* __restrict__ totals) {
  static_assert(kScanThreads == kTileWarps * kWarp, "one block size");
  namespace cg = cooperative_groups;
  __shared__ long long sh[kScanThreads / kWarp];
  long long* ends = const_cast<long long*>(a.ends);
  const int nb = (a.q + kScanRows - 1) / kScanRows;
  for (int b = blockIdx.x; b < nb; b += gridDim.x) {  // 1
    const int r0 = b * kScanRows + threadIdx.x * kScanPer;
    int c[kScanPer];
    long long t = 0, total;
#pragma unroll
    for (int i = 0; i < kScanPer; ++i) {
      c[i] = cells_of(a.l_s, r0 + i, a.q, a.d_cand);
      t += c[i];
    }
    long long run = scan_block(t, sh, total);
#pragma unroll
    for (int i = 0; i < kScanPer; ++i) {
      run += c[i];
      if (r0 + i < a.q) {
        ends[r0 + i] = run;
        a.cnt[r0 + i] = 0;
      }
    }
    if (threadIdx.x == 0) totals[b] = total;
  }
  cg::this_grid().sync();
  if (nb > 1) {  // 2
    for (int b = blockIdx.x; b < nb; b += gridDim.x) {
      if (b == 0) continue;
      long long off = 0;
      for (int i = threadIdx.x; i < b; i += kScanThreads)
        off += __ldcg(totals + i);
      scan_block(off, sh, off);
      const int r0 = b * kScanRows + threadIdx.x * kScanPer;
#pragma unroll
      for (int i = 0; i < kScanPer; ++i)
        if (r0 + i < a.q) ends[r0 + i] += off;
    }
    cg::this_grid().sync();
  }
  const int lane = threadIdx.x % kWarp;  // 3
  const long long cells = ld(a.ends + a.q - 1);
  const long long tiles = (cells + kTile - 1) / kTile;
  const long long warps = static_cast<long long>(gridDim.x) * kTileWarps;
  for (long long t = static_cast<long long>(blockIdx.x) * kTileWarps +
                     threadIdx.x / kWarp;
       t < tiles; t += warps) {
    const long long c0 = t * kTile;
    const int n = static_cast<int>(min(static_cast<long long>(kTile),
                                       cells - c0));
    int v[kTileLane], base[kTileLane], len[kTileLane], row[kTileLane];
    unsigned todo = 0;
#pragma unroll
    for (int k = 0; k < kTileLane; ++k) {
      v[k] = -1;
      base[k] = len[k] = 0;
      row[k] = -1;
      if (lane + kWarp * k < n) todo |= 1u << k;
    }
    for (int r = -1, search = 1;;) {
      // the window: 32 rows from r
      const int first = __reduce_min_sync(
          kFull, todo ? lane + kWarp * (__ffs(todo) - 1) : kTile);
      if (first >= kTile) break;
      if (search)
        r = upper_bound16<long long>(a.ends, max(r, 0) - 1, a.q - 1,
                                     c0 + first);
      const int rr = r + lane;
      const bool in = rr < a.q;
      const long long e = in ? ld(a.ends + rr) : LLONG_MAX;
      long long b = __shfl_up_sync(kFull, e, 1);
      if (lane == 0) b = r > 0 ? ld(a.ends + r - 1) : 0;
      // the row's end and its first candidate's flat index, both counted
      // from the tile's first cell
      const int end = static_cast<int>(max(-1ll, min(e - c0, kTile + 1ll)));
      const int from =
          in ? static_cast<int>(__ldg(a.s_s + rr) + (c0 - b)) : 0;
      const int tb = in ? __ldg(a.s_l + rr) : 0;
      const int tl = in ? max(0, min(__ldg(a.l_l + rr), a.d_targ)) : 0;
      const unsigned open = todo;
#pragma unroll
      for (int k = 0; k < kTileLane; ++k) {
        if (!__any_sync(kFull, todo >> k & 1u)) continue;
        const int x = lane + kWarp * k;
        int l = 0;  // the first lane whose row ends past x (31 at most)
#pragma unroll
        for (int s = 16; s > 0; s >>= 1)
          if (__shfl_sync(kFull, end, l + s - 1) <= x) l += s;
        const int c_end = __shfl_sync(kFull, end, l);
        const int c_from = __shfl_sync(kFull, from, l);
        const int c_tb = __shfl_sync(kFull, tb, l);
        const int c_tl = __shfl_sync(kFull, tl, l);
        if ((todo >> k & 1u) && x < c_end) {
          todo &= ~(1u << k);
          row[k] = r + l;
          v[k] = __ldg(a.flat + c_from + x);
          base[k] = c_tb;
          len[k] = c_tl;
        }
      }
      search = !__any_sync(kFull, todo != open);
      if (!search) r += kWarp;
    }
    int r_last = -1;
#pragma unroll
    for (int k = 0; k < kTileLane; ++k) r_last = max(r_last, row[k]);
    r_last = __reduce_max_sync(kFull, r_last);
    const int r0 = __shfl_sync(kFull, row[0], 0);
    unsigned hit;
    if (r0 == r_last) {  // a tile inside one row
      int vmin = INT_MAX, vmax = -1;
#pragma unroll
      for (int k = 0; k < kTileLane; ++k) {
        if (v[k] >= 0) {
          vmin = min(vmin, v[k]);
          vmax = max(vmax, v[k]);
        }
      }
      vmin = __reduce_min_sync(kFull, vmin);
      vmax = __reduce_max_sync(kFull, vmax);
      if (vmax < 0) continue;  // no candidate can be found
      const int tb = __shfl_sync(kFull, base[0], 0);
      const int tl = __shfl_sync(kFull, len[0], 0);
      // [s0, s0 + m): the target's entries in [vmin, vmax]
      const int bound = upper_bound16<int>(a.flat + tb, -1, tl,
                                           lane < 16 ? vmin - 1 : vmax);
      const int s0 = __shfl_sync(kFull, bound, 0);
      const int m = __shfl_sync(kFull, bound, 16) - s0;
#pragma unroll
      for (int k = 0; k < kTileLane; ++k) {
        base[k] = tb + s0;
        len[k] = v[k] >= 0 ? m : 0;
      }
      hit = find_cells(a.flat, v, base, len);
      const int tot = __reduce_add_sync(kFull, __popc(hit));
      if (lane == 0 && tot) atomicAdd(a.cnt + r0, tot);
    } else {
#pragma unroll
      for (int k = 0; k < kTileLane; ++k)
        if (v[k] < 0) len[k] = 0;
      hit = find_cells(a.flat, v, base, len);
      int cur = -1, acc = 0;  // this lane's hits in row cur
#pragma unroll
      for (int k = 0; k < kTileLane; ++k) {
        if (hit >> k & 1u) {
          if (row[k] != cur) {
            if (acc) atomicAdd(a.cnt + cur, acc);
            cur = row[k];
            acc = 0;
          }
          ++acc;
        }
      }
      if (acc) atomicAdd(a.cnt + cur, acc);
    }
  }
}

// Blocks of count_tiles that fit on the card at once.
int tile_blocks() {
  static const int n = [] {
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, count_tiles,
                                                  kTileWarps * kWarp, 0);
    return std::max(1, per_sm) * sm_count();
  }();
  return n;
}

// The bitmap items with a layout; else K3's tiles where scratch is given;
// else the row walk over every row.  One launch each (K3's items: a
// memset first).
template <int M>
int launch_probe(const Probe& a, long long* scratch, cudaStream_t st) {
  const int q = a.q;
  if (a.perm) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        intersect_items<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kBitmapBytes);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    if constexpr (M == kK3) {  // the rows no item writes: zeros
      const cudaError_t zero = cudaMemsetAsync(a.cnt, 0, sizeof(int) * q, st);
      if (zero != cudaSuccess) return static_cast<int>(zero);
    }
    intersect_items<M><<<min(q, sm_count()), kItemThreads, kBitmapBytes,
                         st>>>(a);
  } else if (M == kK3 && scratch) {
    // the running sum in scratch[0 : q], the chunks' totals after it; a
    // grid no larger than the cells could need (q * d_cand at most) nor
    // than fits on the card at once
    const int64_t tiles =
        (static_cast<int64_t>(q) * std::max(a.d_cand, 0) + kTile - 1) /
        kTile;
    int blocks = static_cast<int>(
        std::min(std::max(int64_t{1}, (tiles + kTileWarps - 1) / kTileWarps),
                 static_cast<int64_t>(tile_blocks())));
    Probe w = a;
    w.ends = scratch;
    long long* totals = scratch + q;
    void* args[] = {&w, &totals};
    const cudaError_t err = cudaLaunchCooperativeKernel(
        reinterpret_cast<void*>(count_tiles), dim3(blocks),
        dim3(kTileWarps * kWarp), args, 0, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else if (a.d_cand <= kWarpMaxCand) {
    const int blocks = (q + kRowsPerWarpBlock - 1) / kRowsPerWarpBlock;
    walk_rows_warp<M><<<blocks, kWarp * kRowsPerWarpBlock, 0, st>>>(a);
  } else {
    walk_rows_block<M><<<q, kBlockThreads, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
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
  return launch_probe<kK1>(a, nullptr, static_cast<cudaStream_t>(stream));
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
  return launch_probe<kK2>(a, nullptr, static_cast<cudaStream_t>(stream));
}

// Launch K3 over q rows into cnt[0 : q]: the bitmap items where perm is
// not null (laid out as K1); else the tiles where scratch (int64[q +
// ceil(q / kScanRows)]: the running sum of the rows' cells, then the
// chunks' totals) is not null; else the row walk (a warp per row up to
// kWarpMaxCand, a block per row above).  cnt needs no zeros on entry.
// Returns a cudaError_t (0 = launched).
int intersect_count_launch(const int* flat, const int* s_s, const int* l_s,
                           const int* s_l, const int* l_l,
                           long long* scratch, const int* perm,
                           const int64_t* cum, const int* item_start,
                           const int* n_items, int q, int d_cand, int d_targ,
                           int* cnt, void* stream) {
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
  a.cnt = cnt;
  return launch_probe<kK3>(a, scratch, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
