// K1, K2 and K3 for Hopper: sorted-list intersection over CSR bounds,
// with three epilogues on one row walk.
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
// would be 0.15-1.1 TB, K2's dense mask at scale 20 ~97 GB, and one
// stream-delta probe at scale 20 (2,048 rows against targets 65,536
// wide) ~0.5 GB.  These kernels read the adjacency straight from the
// CSR array instead; each row walks its real candidate list and
// binary-searches the target slice, so the work is sum(l_s * log2(l_l))
// and nothing of size [Q, d_cand] exists.
//
// What bounds them on this card: memory.  The bytes a row must move are
// its candidates (and, for K1, their levels) and its target list, plus
// five int32 operands in and two int32 out (K1), four int32 operands
// and an int64 offset in and one byte out per candidate (K2), or four
// int32 operands in and one int32 out (K3); the operations are a few
// integer compares per binary-search step, far below the card's integer
// rate.  The design does the simple thing about it:
//
//   * narrow buckets (d_cand <= 256): one warp per row, lanes stride over
//     the candidates, each lane binary-searches the target slice in
//     global memory (hub rows stay hot in the 50 MB L2);
//   * wide buckets: one block per row; the target slice is staged in
//     16 KB of shared memory (kStageCap entries) when it fits, otherwise
//     searched in global memory.  A larger stage leaves fewer blocks per
//     SM and measured slower on the card (PERF.md).
//
// K1 and K3 write each row's counts, K2 each candidate's byte: no
// atomics, deterministic.  Sentinel and masked rows carry l_s = l_l = 0
// and touch nothing.  Index math within the adjacency is int32: offsets
// into flat stay below the slot count (< 2**31, enforced when the graph
// is built).  K2's output index is int64: one bucket's mask at scale 20
// holds 3.45e9 cells.
//
// Plain C interface (built with nvcc into a shared library, bound with
// ctypes); each entry point launches on the given stream and returns
// cudaGetLastError() so a refused launch is never silent.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerWarpBlock = 8;       // warp kernels: 256 threads
constexpr int kBlockThreads = 512;         // block kernels
constexpr int kWarpMaxCand = 256;          // widest bucket run warp-per-row
constexpr int kStageCap = 4096;            // block kernels' staged target
                                           // (16 KB: four blocks per SM)

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

// ------------------------------------------------------------------ K1

__global__ void __launch_bounds__(kWarp * kRowsPerWarpBlock)
intersect_levels_warp(const int* __restrict__ flat,
                      const int* __restrict__ s_s,
                      const int* __restrict__ l_s,
                      const int* __restrict__ s_l,
                      const int* __restrict__ l_l,
                      const int* __restrict__ level, int n_level,
                      const int* __restrict__ lev_u, int q, int d_cand,
                      int d_targ, int* __restrict__ c1,
                      int* __restrict__ c2) {
  const int row = blockIdx.x * kRowsPerWarpBlock + (threadIdx.x / kWarp);
  const int lane = threadIdx.x % kWarp;
  if (row >= q) return;  // uniform across the warp
  const int lu = lev_u[row];
  int a = 0, b = 0;
  warp_walk(flat + s_s[row], min(l_s[row], d_cand), flat + s_l[row],
            min(l_l[row], d_targ), lane, [&](int, int c, bool found) {
              if (found) tally(c, level, n_level, lu, a, b);
            });
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) {
    c1[row] = a;
    c2[row] = b;
  }
}

__global__ void __launch_bounds__(kBlockThreads)
intersect_levels_block(const int* __restrict__ flat,
                       const int* __restrict__ s_s,
                       const int* __restrict__ l_s,
                       const int* __restrict__ s_l,
                       const int* __restrict__ l_l,
                       const int* __restrict__ level, int n_level,
                       const int* __restrict__ lev_u, int d_cand,
                       int d_targ, int* __restrict__ c1,
                       int* __restrict__ c2) {
  __shared__ int stage[kStageCap];
  __shared__ int red_a[kBlockThreads / kWarp];
  __shared__ int red_b[kBlockThreads / kWarp];
  const int row = blockIdx.x;
  const int lu = lev_u[row];
  int a = 0, b = 0;
  block_walk(stage, flat + s_s[row], min(l_s[row], d_cand), flat + s_l[row],
             min(l_l[row], d_targ), [&](int, int c, bool found) {
               if (found) tally(c, level, n_level, lu, a, b);
             });
  a = warp_sum(a);
  b = warp_sum(b);
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (lane == 0) {
    red_a[warp] = a;
    red_b[warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    a = lane < kBlockThreads / kWarp ? red_a[lane] : 0;
    b = lane < kBlockThreads / kWarp ? red_b[lane] : 0;
    a = warp_sum(a);
    b = warp_sum(b);
    if (lane == 0) {
      c1[row] = a;
      c2[row] = b;
    }
  }
}

// ------------------------------------------------------------------ K2

__global__ void __launch_bounds__(kWarp * kRowsPerWarpBlock)
intersect_hits_warp(const int* __restrict__ flat,
                    const int* __restrict__ s_s,
                    const int* __restrict__ l_s,
                    const int* __restrict__ s_l,
                    const int* __restrict__ l_l,
                    const int64_t* __restrict__ offsets, int q, int d_cand,
                    int d_targ, uint8_t* __restrict__ hits) {
  const int row = blockIdx.x * kRowsPerWarpBlock + (threadIdx.x / kWarp);
  if (row >= q) return;  // uniform across the warp
  uint8_t* __restrict__ out = hits + offsets[row];
  warp_walk(flat + s_s[row], min(l_s[row], d_cand), flat + s_l[row],
            min(l_l[row], d_targ), threadIdx.x % kWarp,
            [&](int j, int, bool found) { out[j] = found; });
}

__global__ void __launch_bounds__(kBlockThreads)
intersect_hits_block(const int* __restrict__ flat,
                     const int* __restrict__ s_s,
                     const int* __restrict__ l_s,
                     const int* __restrict__ s_l,
                     const int* __restrict__ l_l,
                     const int64_t* __restrict__ offsets, int d_cand,
                     int d_targ, uint8_t* __restrict__ hits) {
  __shared__ int stage[kStageCap];
  const int row = blockIdx.x;
  uint8_t* __restrict__ out = hits + offsets[row];
  block_walk(stage, flat + s_s[row], min(l_s[row], d_cand), flat + s_l[row],
             min(l_l[row], d_targ),
             [&](int j, int, bool found) { out[j] = found; });
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

// Launch K1 over q rows.  Returns a cudaError_t (0 = launched).
int intersect_levels_launch(const int* flat, const int* s_s, const int* l_s,
                            const int* s_l, const int* l_l,
                            const int* level, int n_level, const int* lev_u,
                            int q, int d_cand, int d_targ, int* c1,
                            int* c2, void* stream) {
  if (q <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d_cand <= kWarpMaxCand) {
    const int blocks = (q + kRowsPerWarpBlock - 1) / kRowsPerWarpBlock;
    intersect_levels_warp<<<blocks, kWarp * kRowsPerWarpBlock, 0, st>>>(
        flat, s_s, l_s, s_l, l_l, level, n_level, lev_u, q, d_cand, d_targ,
        c1, c2);
    return static_cast<int>(cudaGetLastError());
  }
  intersect_levels_block<<<q, kBlockThreads, 0, st>>>(
      flat, s_s, l_s, s_l, l_l, level, n_level, lev_u, d_cand, d_targ, c1,
      c2);
  return static_cast<int>(cudaGetLastError());
}

// Launch K2 over q rows into hits[0 : offsets[q]] (one byte per clamped
// candidate).  Returns a cudaError_t (0 = launched).
int intersect_hits_launch(const int* flat, const int* s_s, const int* l_s,
                          const int* s_l, const int* l_l,
                          const int64_t* offsets, int q, int d_cand,
                          int d_targ, uint8_t* hits, void* stream) {
  if (q <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d_cand <= kWarpMaxCand) {
    const int blocks = (q + kRowsPerWarpBlock - 1) / kRowsPerWarpBlock;
    intersect_hits_warp<<<blocks, kWarp * kRowsPerWarpBlock, 0, st>>>(
        flat, s_s, l_s, s_l, l_l, offsets, q, d_cand, d_targ, hits);
    return static_cast<int>(cudaGetLastError());
  }
  intersect_hits_block<<<q, kBlockThreads, 0, st>>>(
      flat, s_s, l_s, s_l, l_l, offsets, d_cand, d_targ, hits);
  return static_cast<int>(cudaGetLastError());
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
