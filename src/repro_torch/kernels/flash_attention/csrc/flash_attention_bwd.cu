// K5's backward for Hopper: the gradient of causal, windowed, grouped-
// query attention (FlashAttention-2's backward), deterministic.
//
// Replaces no TPU kernel: the reference trains through
// repro/models/transformer.py:_attend, which XLA differentiates, and its
// Pallas kernel (repro/kernels/flash_attention/flash_attention.py) has no
// backward.  The port runs every attention on the card through K5, so its
// gradient is a kernel too.  For each batch b and query head h (kv head
// g = h / (Hq / Hkv)), with S = T and query i at position i:
//
//   P[i, t]  = exp(scale * q_i . k_t - lse_i) on the live keys, else 0
//   D_i      = sum_d dO[i, d] O[i, d]
//   dV[t]   += sum_i P[i, t] dO[i]            (over the group's heads)
//   dS[i, t] = P[i, t] (dO_i . v_t - D_i)
//   dQ[i]    = scale sum_t dS[i, t] k_t
//   dK[t]   += scale sum_i dS[i, t] q_i       (over the group's heads)
//
// live: t <= i (causal) and i - t < window (when given).  lse is the
// forward's log-sum-exp of each row (flash_attention.cu, written when a
// gradient is wanted), so P is recomputed tile by tile and never stored.
//
// Three launches, no atomics, every sum in a fixed order (equal bits
// across launches):
//
//   1. attn_bwd_delta: D, a warp per row, into float32 scratch;
//   2. attn_bwd_dkdv: a block per (key tile, kv head, batch) owns its
//      keys' dK and dV.  It stages its K and V tile once, then walks the
//      group's query heads and, for each, the query tiles that see its
//      keys (the causal frontier and the window bound the walk), forms
//      the scores and dP against each, and adds P^T dO and dS^T Q;
//   3. attn_bwd_dq: a block per (query tile, query head, batch) stages
//      its Q and dO once, walks the key tiles its rows see, recomputes P
//      and dS and adds dS K.
//
// Both grids are one-dimensional and start with the heaviest blocks (the
// first key tiles of pass 2 and the last query tiles of pass 3 see the
// most of the causal triangle), so the short ones fill the tail.  Tiles
// are staged by cp.async, rows past S zero-filled and never read from
// memory.  A tile (float32) or a 16 x 16 sub-tile (bfloat16) that lies
// wholly inside the causal frontier and the window skips the live test;
// a sub-tile wholly outside is skipped.
//
// Bound: by operations.  The work is five S x T x D products over the
// live (row, key) pairs (S, dP, dV, dS^T Q, dS K); the S and dP that pass
// 3 recomputes make seven.  The bytes (q, k, v, o, dO and lse read, dq,
// dk, dv written, once each) are far below that at the training shapes.
//
//   * bfloat16: every product on the tensor cores (mma.sync m16n8k16, bf16
//     operands, float32 sums; bound 989 TFLOP/s).  Operands stay bf16 in
//     shared memory, rows padded by 8 elements so the ldmatrix reads of 8
//     rows are free of bank conflicts, and the tiles a pass walks come
//     through a ring of two stages, the next tile's copy in flight while
//     the current one is used (one __syncthreads a tile).  Pass 2: a warp
//     owns 16 keys (4 warps, 64 keys a block) and, for each 16-query
//     sub-tile, forms S^T = K Q^T and dP^T = V dO^T; P^T and dS^T =
//     P^T (dP^T - D) then sit in the accumulator layout, which is the A
//     operand of dV += P^T dO and dK += dS^T Q as it is (the forward's
//     register reuse), P and dS rounded to bf16 as the forward rounds p.
//     Pass 3: a warp owns 16 query rows (8 warps) and dS is the A operand
//     of dQ += dS K.  ldmatrix feeds every B operand (.trans for dO, Q
//     and K read along their other axis) and the A operands K, V (pass 2,
//     D <= 64) or Q, dO (pass 3, D <= 128) are held in registers for the
//     whole block.  At D = 256 two warps share a strip of 16 keys, each
//     accumulating half of its dK and dV dims (128 floats a thread; both
//     form the strip's scores), so the accumulators fit in registers.
//   * float32: the CUDA cores' FMA (67 TFLOP/s), so the sums keep
//     float32's 24 bits (3xTF32 on the tensor cores keeps ~22 and missed
//     the forward's gate, flash_attention.cu).  Operands are staged as
//     float32 with rows padded by 4 floats.  A thread holds a 4 x 8 tile
//     of S and of dP at D = 16, 32 and 64 (128 threads), else 4 x 4 (256),
//     its warp on 16 rows x 8 keys so each float4 read is shared by 4 or 8
//     lanes, and 4 x 4 units of its dK, dV or dQ accumulators that share
//     their dims (8 x 4 at D = 64); P and dS pass through shared memory.
//     The FMA loop reads shared memory at ~11 FMA a float4 load, so that
//     bandwidth and not the FMA rate bounds it.  Only at D = 256 do the
//     walked tiles come through a ring of two stages: below it the ring's
//     shared memory would leave one block on an SM, and a second resident
//     block hides the copy better.
//
// dQ stays a pass of its own: fusing it into pass 2 with equal bits needs
// either a float32 partial per (query tile, key tile) pair written and
// summed in order (1.2 GB of scratch at smollm-135m's training shape,
// ~0.7 ms of traffic, more than bf16's whole bound) or an ordered wait
// between blocks.  Left for later with wgmma and TMA.
//
// Plain C interface (built with nvcc into a shared library, bound with
// ctypes).  The entry point launches on the given stream, allocates
// nothing, sets each kernel's shared-memory limit once, and returns
// cudaGetLastError() so a refused launch is never silent.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarp = 32;
constexpr int kDeltaThreads = 256;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // [B, Hq, S]
  float* delta;      // [B, Hq, S] scratch: D of each row
  void* dq;
  void* dk;
  void* dv;
  // element strides of each operand's batch, head and position axes
  long long q_b, q_h, q_s, k_b, k_h, k_t, v_b, v_h, v_t;
  long long o_b, o_h, o_s, do_b, do_h, do_s;
  long long dq_b, dq_h, dq_s, dk_b, dk_h, dk_t, dv_b, dv_h, dv_t;
  int s_len, hq, group;  // S = T; group = Hq / Hkv
  int causal, window;    // window <= 0: none
  float scale;
};

// ------------------------------------------------------------- helpers

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 x =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 y =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(x.x, x.y, y.x, y.y);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float elem(float4 x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// Copy 16 (4) bytes from global to shared memory asynchronously; when
// !pred they are zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(pred ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until none of this thread's committed groups is in flight
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Stage rows [0, kRows) of a tile of D elements each, from g (row r at
// g + r * stride) into smem rows of kStride elements, 16 bytes per
// cp.async; rows from n_live on are zero-filled.
template <int D, int kRows, int kStride, typename T>
__device__ __forceinline__ void stage_rows(T* smem, const T* g,
                                           long long stride, int n_live) {
  constexpr int kE = 16 / sizeof(T);
  constexpr int kU = D / kE;
  for (int e = threadIdx.x; e < kRows * kU; e += blockDim.x) {
    const int r = e / kU, c = (e % kU) * kE;
    const bool live = r < n_live;
    cp_async16(smem + r * kStride + c,
               g + (live ? static_cast<long long>(r) * stride : 0) + c, live);
  }
}

// lse and D of rows [r0, r0 + kRows) of one (batch, head) into ls and dl,
// zeros from n_live on
template <int kRows>
__device__ __forceinline__ void stage_stats(float* ls, float* dl,
                                            const Args& a, long long r0,
                                            int n_live) {
  for (int i = threadIdx.x; i < kRows; i += blockDim.x) {
    const bool live = i < n_live;
    const long long r = live ? r0 + i : 0;
    cp_async4(ls + i, a.lse + r, live);
    cp_async4(dl + i, a.delta + r, live);
  }
}

// The ring's step at tile j of n_tiles: wait for tile j (and make it
// visible), then start tile j + 1's copy into the other stage.  One stage:
// tile j is copied here, after the last tile's reads.
template <int kStages, typename F>
__device__ __forceinline__ void ring_step(int j, int n_tiles, F stage) {
  if constexpr (kStages == 2) {
    cp_async_wait_all();
    __syncthreads();  // tile j landed; tile j - 1's reads are done
    if (j + 1 < n_tiles) stage(j + 1);
    cp_async_commit();
  } else {
    if (j > 0) {
      __syncthreads();  // tile j - 1's reads are done
      stage(j);
      cp_async_commit();
    }
    cp_async_wait_all();
    __syncthreads();
  }
}

// query qi sees key kj (both inside [0, S))
__device__ __forceinline__ bool sees(int qi, int kj, const Args& a) {
  return (!a.causal || kj <= qi) && (a.window <= 0 || qi - kj < a.window);
}

// queries [q0, q0 + nq) against keys [k0, k0 + nk), nq, nk counted inside
// [0, S): every pair live, or none
__device__ __forceinline__ bool all_live(int q0, int nq, int k0, int nk,
                                         const Args& a) {
  return (!a.causal || k0 + nk - 1 <= q0) &&
         (a.window <= 0 || q0 + nq - 1 - k0 < a.window);
}
__device__ __forceinline__ bool none_live(int q0, int nq, int k0, int nk,
                                          const Args& a) {
  return nq <= 0 || nk <= 0 || (a.causal && k0 > q0 + nq - 1) ||
         (a.window > 0 && q0 - (k0 + nk - 1) >= a.window);
}

// ---------------------------------------------------- tensor-core helpers

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 bf16 matrices from shared memory, lane l giving the address
// of a row of matrix l / 8; .trans hands each lane the transpose's share
__device__ __forceinline__ void ldsm4(unsigned (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
__device__ __forceinline__ void ldsm4_t(unsigned (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&x);
}

// m16n8k16 (PTX ISA), g = lane / 4, t = lane % 4: A (row g or g + 8, k
// 2t, 2t + 1 or 2t + 8, 2t + 9), B (k 2t, 2t + 1 or 2t + 8, 2t + 9, col
// g), C (row g or g + 8, col 2t or 2t + 1).  Three ways to read 16 x 16
// of a row-major [rows][kS] bf16 tile at (r0, c0) with one ldsm4:
//   * a_frag: the A operand (rows = M, cols = K);
//   * b_rows: the B operands of two n-tiles whose N runs along the tile's
//     rows and K along its columns (r[0], r[1]: rows r0..r0+7; r[2], r[3]:
//     rows r0+8..r0+15);
//   * b_cols (.trans): the B operands of two n-tiles whose K runs along
//     the rows and N along the columns (cols c0..c0+7, then c0+8..).
template <int kS>
__device__ __forceinline__ void a_frag(unsigned (&r)[4], const bf16* tile,
                                       int r0, int c0, int lane) {
  ldsm4(r, tile + (r0 + (lane & 15)) * kS + c0 + (lane >> 4) * 8);
}
template <int kS>
__device__ __forceinline__ void b_rows(unsigned (&r)[4], const bf16* tile,
                                       int r0, int c0, int lane) {
  ldsm4(r, tile + (r0 + (lane & 7) + ((lane >> 4) << 3)) * kS + c0 +
               ((lane >> 3) & 1) * 8);
}
template <int kS>
__device__ __forceinline__ void b_cols(unsigned (&r)[4], const bf16* tile,
                                       int r0, int c0, int lane) {
  ldsm4_t(r, tile + (r0 + (lane & 15)) * kS + c0 + (lane >> 4) * 8);
}

// the accumulators of two n-tiles (16 x 16, cols k) as an A operand
__device__ __forceinline__ void pack_a(unsigned (&a)[4],
                                       const float (&c)[2][4]) {
  a[0] = pack_bf16(c[0][0], c[0][1]);
  a[1] = pack_bf16(c[0][2], c[0][3]);
  a[2] = pack_bf16(c[1][0], c[1][1]);
  a[3] = pack_bf16(c[1][2], c[1][3]);
}

// ---------------------------------------------------------------- pass 1

// D of each row (b, h, i): a warp a row, float4 columns per lane
template <int D, typename T>
__global__ void __launch_bounds__(kDeltaThreads)
    attn_bwd_delta(const Args a, long long n_rows) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (kDeltaThreads / kWarp) +
      threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= n_rows) return;
  const int i = static_cast<int>(row % a.s_len);
  const int h = static_cast<int>((row / a.s_len) % a.hq);
  const long long b = row / (static_cast<long long>(a.s_len) * a.hq);
  const T* o = static_cast<const T*>(a.o) + b * a.o_b + h * a.o_h +
               static_cast<long long>(i) * a.o_s;
  const T* d = static_cast<const T*>(a.dout) + b * a.do_b + h * a.do_h +
               static_cast<long long>(i) * a.do_s;
  float acc = 0.f;
  for (int c = 4 * lane; c < D; c += 4 * kWarp)
    acc = dot4(load4(o + c), load4(d + c), acc);
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) a.delta[row] = acc;
}

// ------------------------------------------------------- float32 on FMA

// Tiles by head width.  Pass 2: keys a block and query rows a staged
// tile; pass 3: query rows a block and keys a staged tile.  kLd is the
// padded shared-memory row of an operand (one position, D floats), kPl
// the row of P and dS, kTl the row of dS^T.  Threads: 128 at D = 16, 32
// and 64, where a thread's score tile is 4 rows x 8 keys, else 256 (4 x 4).
// Stages: two at D = 256; below it one, so that two blocks fit on an SM.
template <int D>
struct Fma {
  static_assert(D % 16 == 0 || D == 48, "head widths of HEAD_DIMS");
  static constexpr int kThreads = D <= 64 && D != 48 ? 128 : 256;
  static constexpr int kCols = kThreads / 16;  // threads across the keys
  static constexpr int kLd = D + 4;
  static constexpr int kKvKeys = D == 256 ? 32 : 64;
  static constexpr int kKvRows = D == 256 ? 32 : 64;
  static constexpr int kQRows = D == 256 ? 32 : 64;
  static constexpr int kQKeys = D == 256 ? 32 : 64;
  static constexpr int kStages = D == 256 ? 2 : 1;
  static constexpr int kPl = kKvKeys + 8;
  static constexpr int kTl = kQRows + 4;
  // shared memory: pass 2's K, V, ring of (Q, dO), P and dS, ring of
  // (lse, D); pass 3's Q, dO, ring of (K, V), dS^T, lse and D
  static constexpr size_t kSmemKv =
      sizeof(float) *
      (static_cast<size_t>(2 * kKvKeys + 2 * kStages * kKvRows) * kLd +
       2 * kKvRows * kPl + 2 * kStages * kKvRows);
  static constexpr size_t kSmemQ =
      sizeof(float) *
      (static_cast<size_t>(2 * kQRows + 2 * kStages * kQKeys) * kLd +
       kQKeys * kTl + 2 * kQRows);
};

// A thread's place in a 16 x kCols grid over a score tile: warp w covers
// rows 4 (w % 4) .. + 3 and cols 8 (w / 4) .. + 7, so each float4 read of
// a row or a key is shared by 8 or 4 lanes.
__device__ __forceinline__ int grid_row(int tid) {
  return 4 * ((tid / kWarp) % 4) + (tid % kWarp) / 8;
}
__device__ __forceinline__ int grid_col(int tid) {
  return 8 * (tid / kWarp / 4) + tid % 8;
}

// A thread's 4 x 4 units of a [kRows][D] accumulator: kSpt units that
// share their 4 dims (place's result), at rows r4[u] (-1: none).  Where
// D / 4 is a multiple of 8, a warp's 32 units of one round are 4 rows x
// 8 dims, so its float4 reads of a row of P (or of dS^T) and of dO, Q or
// K each touch one 128-byte line; else a thread has one unit.
template <int D, int kRows, int kT>
struct Units {
  static constexpr int kDg = D / 4, kRg = kRows / 4, kW = kT / kWarp;
  static constexpr bool kQuad = kDg % 8 == 0 && kRg % 4 == 0 &&
                                kW % (kDg / 8) == 0 &&
                                (kRg * kDg) % kT == 0;
  static constexpr int kSpt = kQuad ? kRg * kDg / kT : 1;
  static_assert(kQuad || kRg * kDg <= kT, "one unit a thread");

  __device__ __forceinline__ static int place(int tid, int (&r4)[kSpt]) {
    if constexpr (kQuad) {
      constexpr int kCd = kDg / 8;
      const int w = tid / kWarp, l = tid % kWarp;
#pragma unroll
      for (int u = 0; u < kSpt; ++u)
        r4[u] = (((w + u * kW) / kCd) * 4 + l / 8) * 4;
      return ((w % kCd) * 8 + l % 8) * 4;
    } else {
      const bool mine = tid < kRg * kDg;
      r4[0] = mine ? (tid / kDg) * 4 : -1;
      return mine ? (tid % kDg) * 4 : 0;
    }
  }
};

// S = Q K^T and dP = dO V^T of a thread's score tile: rows ti + 16 x,
// keys tj + kCols y, from the staged tiles (rows of kLd floats)
template <int D, int kA, int kB, int kCols>
__device__ __forceinline__ void fma_scores(float (&s)[kA][kB],
                                           float (&dp)[kA][kB],
                                           const float* qs, const float* dos,
                                           const float* ks, const float* vs,
                                           int ti, int tj) {
  constexpr int kLd = Fma<D>::kLd;
#pragma unroll
  for (int x = 0; x < kA; ++x)
#pragma unroll
    for (int y = 0; y < kB; ++y) s[x][y] = dp[x][y] = 0.f;
#pragma unroll 2
  for (int c = 0; c < D; c += 4) {
    float4 qa[kA], da[kA];
#pragma unroll
    for (int x = 0; x < kA; ++x) {
      qa[x] = load4(qs + (ti + 16 * x) * kLd + c);
      da[x] = load4(dos + (ti + 16 * x) * kLd + c);
    }
#pragma unroll
    for (int y = 0; y < kB; ++y) {
      const float4 kb = load4(ks + (tj + kCols * y) * kLd + c);
      const float4 vb = load4(vs + (tj + kCols * y) * kLd + c);
#pragma unroll
      for (int x = 0; x < kA; ++x) {
        s[x][y] = dot4(qa[x], kb, s[x][y]);
        dp[x][y] = dot4(da[x], vb, dp[x][y]);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(Fma<D>::kThreads)
    attn_bwd_dkdv(const Args a, int hkv) {
  using C = Fma<D>;
  using T = float;
  using U = Units<D, C::kKvKeys, C::kThreads>;
  constexpr int kBq = C::kKvRows, kBk = C::kKvKeys, kLd = C::kLd;
  constexpr int kA = kBq / 16, kB = kBk / C::kCols, kPl = C::kPl;
  constexpr int kStages = C::kStages, kSpt = U::kSpt;

  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [kBk][kLd]
  float* vs = ks + kBk * kLd;                   // [kBk][kLd]
  float* ring = vs + kBk * kLd;                 // [stage][Q, dO][kBq][kLd]
  float* ps = ring + kStages * 2 * kBq * kLd;   // [kBq][kPl]: P
  float* dss = ps + kBq * kPl;                  // [kBq][kPl]: dS
  float* stats = dss + kBq * kPl;               // [stage][lse, D][kBq]

  const int tid = threadIdx.x, ti = grid_row(tid), tj = grid_col(tid);
  const int n = a.s_len, units = gridDim.x / ((n + kBk - 1) / kBk);
  const int kt = blockIdx.x / units, rest = blockIdx.x % units;
  const int g = rest % hkv, b = rest / hkv;
  const int k0 = kt * kBk, nk = min(kBk, n - k0);

  stage_rows<D, kBk, kLd>(ks,
                          static_cast<const T*>(a.k) + b * a.k_b + g * a.k_h +
                              static_cast<long long>(k0) * a.k_t,
                          a.k_t, nk);
  stage_rows<D, kBk, kLd>(vs,
                          static_cast<const T*>(a.v) + b * a.v_b + g * a.v_h +
                              static_cast<long long>(k0) * a.v_t,
                          a.v_t, nk);

  // the query rows that see a key of this tile: [q_lo, q_hi), walked for
  // each of the group's heads
  const int q_lo = a.causal ? k0 : 0;
  const int q_hi = a.window > 0 ? min(n, k0 + nk - 1 + a.window) : n;
  const int t_lo = q_lo / kBq, n_qt = (q_hi + kBq - 1) / kBq - t_lo;
  const int n_tiles = a.group * n_qt;
  auto stage = [&](int j) {
    const int h = g * a.group + j / n_qt;
    const int q0 = (t_lo + j % n_qt) * kBq, nq = min(kBq, n - q0);
    const int s = kStages == 2 ? (j & 1) : 0;
    float* qs = ring + s * 2 * kBq * kLd;
    stage_rows<D, kBq, kLd>(qs,
                            static_cast<const T*>(a.q) + b * a.q_b +
                                h * a.q_h + static_cast<long long>(q0) * a.q_s,
                            a.q_s, nq);
    stage_rows<D, kBq, kLd>(qs + kBq * kLd,
                            static_cast<const T*>(a.dout) + b * a.do_b +
                                h * a.do_h +
                                static_cast<long long>(q0) * a.do_s,
                            a.do_s, nq);
    float* ls = stats + s * 2 * kBq;
    stage_stats<kBq>(ls, ls + kBq, a,
                     (static_cast<long long>(b) * a.hq + h) * n + q0, nq);
  };
  if (n_tiles > 0) stage(0);
  cp_async_commit();

  int r4[kSpt];
  const int d4 = U::place(tid, r4);
  float dk[kSpt][4][4], dv[kSpt][4][4];
#pragma unroll
  for (int u = 0; u < kSpt; ++u)
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) dk[u][x][y] = dv[u][x][y] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    ring_step<kStages>(j, n_tiles, stage);
    const int s = kStages == 2 ? (j & 1) : 0;
    const float* qs = ring + s * 2 * kBq * kLd;
    const float* dos = qs + kBq * kLd;
    const float* ls = stats + s * 2 * kBq;
    const float* dl = ls + kBq;
    const int q0 = (t_lo + j % n_qt) * kBq, nq = min(kBq, n - q0);

    float sc[kA][kB], dp[kA][kB];
    fma_scores<D, kA, kB, C::kCols>(sc, dp, qs, dos, ks, vs, ti, tj);
    const bool whole = nq == kBq && nk == kBk && all_live(q0, kBq, k0, kBk, a);
#pragma unroll
    for (int x = 0; x < kA; ++x) {
      const int i = ti + 16 * x;
#pragma unroll
      for (int y = 0; y < kB; ++y) {
        const int jj = tj + C::kCols * y;
        float p = expf(sc[x][y] * a.scale - ls[i]);
        if (!whole && !(i < nq && jj < nk && sees(q0 + i, k0 + jj, a)))
          p = 0.f;
        ps[i * kPl + jj] = p;
        dss[i * kPl + jj] = p * (dp[x][y] - dl[i]);
      }
    }
    __syncthreads();
    // dV += P^T dO and dK += dS^T Q over the tile's rows
#pragma unroll (kSpt > 1 ? 2 : 4)
    for (int i = 0; i < nq; ++i) {
      const float4 o4 = load4(dos + i * kLd + d4);
      const float4 q4 = load4(qs + i * kLd + d4);
#pragma unroll
      for (int u = 0; u < kSpt; ++u) {
        if (!U::kQuad && r4[u] < 0) continue;
        const float4 p4 = load4(ps + i * kPl + r4[u]);
        const float4 s4 = load4(dss + i * kPl + r4[u]);
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const float px = elem(p4, x), sx = elem(s4, x);
#pragma unroll
          for (int y = 0; y < 4; ++y) {
            dv[u][x][y] = fmaf(px, elem(o4, y), dv[u][x][y]);
            dk[u][x][y] = fmaf(sx, elem(q4, y), dk[u][x][y]);
          }
        }
      }
    }
  }
  cp_async_wait_all();

  T* dkg = static_cast<T*>(a.dk) + b * a.dk_b + g * a.dk_h;
  T* dvg = static_cast<T*>(a.dv) + b * a.dv_b + g * a.dv_h;
#pragma unroll
  for (int u = 0; u < kSpt; ++u) {
    if (!U::kQuad && r4[u] < 0) continue;
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      if (r4[u] + x >= nk) continue;
      const long long t = k0 + r4[u] + x;
      *reinterpret_cast<float4*>(dkg + t * a.dk_t + d4) =
          make_float4(dk[u][x][0] * a.scale, dk[u][x][1] * a.scale,
                      dk[u][x][2] * a.scale, dk[u][x][3] * a.scale);
      *reinterpret_cast<float4*>(dvg + t * a.dv_t + d4) =
          make_float4(dv[u][x][0], dv[u][x][1], dv[u][x][2], dv[u][x][3]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(Fma<D>::kThreads)
    attn_bwd_dq(const Args a, int batch) {
  using C = Fma<D>;
  using T = float;
  using U = Units<D, C::kQRows, C::kThreads>;
  constexpr int kBq = C::kQRows, kBk = C::kQKeys, kLd = C::kLd;
  constexpr int kA = kBq / 16, kB = kBk / C::kCols, kTl = C::kTl;
  constexpr int kStages = C::kStages, kSpt = U::kSpt;

  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kBq][kLd]
  float* dos = qs + kBq * kLd;                  // [kBq][kLd]
  float* ring = dos + kBq * kLd;                // [stage][K, V][kBk][kLd]
  float* dst = ring + kStages * 2 * kBk * kLd;  // [kBk][kTl]: dS^T
  float* ls = dst + kBk * kTl;                  // [kBq]: lse
  float* dl = ls + kBq;                         // [kBq]: D

  const int tid = threadIdx.x, ti = grid_row(tid), tj = grid_col(tid);
  const int n = a.s_len, n_qt = (n + kBq - 1) / kBq;
  const int units = a.hq * batch;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / units;
  const int rest = blockIdx.x % units, h = rest % a.hq, b = rest / a.hq;
  const int g = h / a.group;
  const int q0 = qt * kBq, nq = min(kBq, n - q0);

  stage_rows<D, kBq, kLd>(qs,
                          static_cast<const T*>(a.q) + b * a.q_b + h * a.q_h +
                              static_cast<long long>(q0) * a.q_s,
                          a.q_s, nq);
  stage_rows<D, kBq, kLd>(dos,
                          static_cast<const T*>(a.dout) + b * a.do_b +
                              h * a.do_h + static_cast<long long>(q0) * a.do_s,
                          a.do_s, nq);
  stage_stats<kBq>(ls, dl, a, (static_cast<long long>(b) * a.hq + h) * n + q0,
                   nq);

  // the keys that some row of this tile sees: [k_lo, k_hi)
  const int k_lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int k_hi = a.causal ? min(n, q0 + nq) : n;
  const int t_lo = k_lo / kBk, n_tiles = (k_hi + kBk - 1) / kBk - t_lo;
  const T* kg = static_cast<const T*>(a.k) + b * a.k_b + g * a.k_h;
  const T* vg = static_cast<const T*>(a.v) + b * a.v_b + g * a.v_h;
  auto stage = [&](int j) {
    const int k0 = (t_lo + j) * kBk, nk = min(kBk, n - k0);
    float* kst = ring + (kStages == 2 ? (j & 1) : 0) * 2 * kBk * kLd;
    stage_rows<D, kBk, kLd>(kst, kg + static_cast<long long>(k0) * a.k_t,
                            a.k_t, nk);
    stage_rows<D, kBk, kLd>(kst + kBk * kLd,
                            vg + static_cast<long long>(k0) * a.v_t, a.v_t,
                            nk);
  };
  if (n_tiles > 0) stage(0);
  cp_async_commit();

  int r4[kSpt];
  const int d4 = U::place(tid, r4);
  float acc[kSpt][4][4];
#pragma unroll
  for (int u = 0; u < kSpt; ++u)
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) acc[u][x][y] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    ring_step<kStages>(j, n_tiles, stage);
    const float* ks = ring + (kStages == 2 ? (j & 1) : 0) * 2 * kBk * kLd;
    const float* vs = ks + kBk * kLd;
    const int k0 = (t_lo + j) * kBk, nk = min(kBk, n - k0);

    float sc[kA][kB], dp[kA][kB];
    fma_scores<D, kA, kB, C::kCols>(sc, dp, qs, dos, ks, vs, ti, tj);
    const bool whole = nq == kBq && nk == kBk && all_live(q0, kBq, k0, kBk, a);
#pragma unroll
    for (int x = 0; x < kA; ++x) {
      const int i = ti + 16 * x;
#pragma unroll
      for (int y = 0; y < kB; ++y) {
        const int jj = tj + C::kCols * y;
        float ds = expf(sc[x][y] * a.scale - ls[i]) * (dp[x][y] - dl[i]);
        if (!whole && !(i < nq && jj < nk && sees(q0 + i, k0 + jj, a)))
          ds = 0.f;
        dst[jj * kTl + i] = ds;
      }
    }
    __syncthreads();
    // dQ += dS K over the tile's keys
#pragma unroll (kSpt > 1 ? 2 : 4)
    for (int jj = 0; jj < nk; ++jj) {
      const float4 k4 = load4(ks + jj * kLd + d4);
#pragma unroll
      for (int u = 0; u < kSpt; ++u) {
        if (!U::kQuad && r4[u] < 0) continue;
        const float4 s4 = load4(dst + jj * kTl + r4[u]);
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int y = 0; y < 4; ++y)
            acc[u][x][y] = fmaf(elem(s4, x), elem(k4, y), acc[u][x][y]);
      }
    }
  }
  cp_async_wait_all();

  T* dqg = static_cast<T*>(a.dq) + b * a.dq_b + h * a.dq_h;
#pragma unroll
  for (int u = 0; u < kSpt; ++u) {
    if (!U::kQuad && r4[u] < 0) continue;
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      if (r4[u] + x >= nq) continue;
      *reinterpret_cast<float4*>(
          dqg + static_cast<long long>(q0 + r4[u] + x) * a.dq_s + d4) =
          make_float4(acc[u][x][0] * a.scale, acc[u][x][1] * a.scale,
                      acc[u][x][2] * a.scale, acc[u][x][3] * a.scale);
    }
  }
}

// ---------------------------------------------------- bfloat16 on mma

// Tiles by head width: the padded shared-memory row (8 bf16 past D);
// pass 2's warps a block (kSplit a 16-key strip, each D / kSplit of its
// dK and dV dims), keys a block and query rows a staged tile; pass 3's
// warps (16 query rows each) and keys a staged tile.  K and V (pass 2)
// or Q and dO (pass 3) are held as A fragments in registers where they
// fit beside the accumulators.  Pass 2 at D <= 64 is held to 3 blocks an
// SM (<= 168 registers): at 173 registers, two fit.
template <int D>
struct Tc {
  static_assert(D % 16 == 0, "k-steps of 16");
  static constexpr int kStride = D + 8;
  static constexpr int kSplit = D == 256 ? 2 : 1;
  static constexpr int kKvWarps = 4 * kSplit;
  static constexpr int kKvKeys = 64;
  static constexpr int kKvRows = D == 256 ? 32 : 64;
  static constexpr bool kKvHold = D <= 64;
  static constexpr int kKvMinBlocks = D <= 64 ? 3 : 1;
  static constexpr int kQWarps = 8;
  static constexpr int kQRows = 16 * kQWarps;
  static constexpr int kQKeys = D == 256 ? 32 : 64;
  static constexpr bool kQHold = D <= 128;
  // pass 2: K, V, the ring of (Q, dO) and of (lse, D); pass 3: Q, dO and
  // the ring of (K, V)
  static constexpr size_t kSmemKv =
      sizeof(bf16) * static_cast<size_t>(2 * kKvKeys + 4 * kKvRows) * kStride +
      sizeof(float) * 4 * kKvRows;
  static constexpr size_t kSmemQ =
      sizeof(bf16) * static_cast<size_t>(2 * kQRows + 4 * kQKeys) * kStride;
};

template <int D>
__global__ void __launch_bounds__(Tc<D>::kKvWarps * kWarp, Tc<D>::kKvMinBlocks)
    attn_bwd_dkdv_mma(const Args a, int hkv) {
  using P = Tc<D>;
  constexpr int kS = P::kStride, kBk = P::kKvKeys, kBq = P::kKvRows;
  constexpr int kDw = D / P::kSplit;  // dK and dV dims a warp
  constexpr int kKs = D / 16;         // k-steps of the scores

  extern __shared__ float4 smem4[];
  bf16* ks = reinterpret_cast<bf16*>(smem4);  // [kBk][kS]
  bf16* vs = ks + kBk * kS;                   // [kBk][kS]
  bf16* ring = vs + kBk * kS;                 // [stage][Q, dO][kBq][kS]
  float* stats = reinterpret_cast<float*>(ring + 4 * kBq * kS);
  // stats: [stage][lse, D][kBq]

  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int gq = lane >> 2, tq = lane & 3;
  const int strip = warp / P::kSplit, part = warp % P::kSplit;
  const int n = a.s_len, units = gridDim.x / ((n + kBk - 1) / kBk);
  const int kt = blockIdx.x / units, rest = blockIdx.x % units;
  const int g = rest % hkv, b = rest / hkv;
  const int k0 = kt * kBk, nk = min(kBk, n - k0);
  const int kw = k0 + 16 * strip;  // this warp's first key
  const int ckw = min(16, n - kw);

  stage_rows<D, kBk, kS>(ks,
                         static_cast<const bf16*>(a.k) + b * a.k_b +
                             g * a.k_h + static_cast<long long>(k0) * a.k_t,
                         a.k_t, nk);
  stage_rows<D, kBk, kS>(vs,
                         static_cast<const bf16*>(a.v) + b * a.v_b +
                             g * a.v_h + static_cast<long long>(k0) * a.v_t,
                         a.v_t, nk);

  const int q_lo = a.causal ? k0 : 0;
  const int q_hi = a.window > 0 ? min(n, k0 + nk - 1 + a.window) : n;
  const int t_lo = q_lo / kBq, n_qt = (q_hi + kBq - 1) / kBq - t_lo;
  const int n_tiles = a.group * n_qt;
  auto stage = [&](int j) {
    const int h = g * a.group + j / n_qt;
    const int q0 = (t_lo + j % n_qt) * kBq, nq = min(kBq, n - q0);
    bf16* qs = ring + (j & 1) * 2 * kBq * kS;
    stage_rows<D, kBq, kS>(qs,
                           static_cast<const bf16*>(a.q) + b * a.q_b +
                               h * a.q_h + static_cast<long long>(q0) * a.q_s,
                           a.q_s, nq);
    stage_rows<D, kBq, kS>(qs + kBq * kS,
                           static_cast<const bf16*>(a.dout) + b * a.do_b +
                               h * a.do_h +
                               static_cast<long long>(q0) * a.do_s,
                           a.do_s, nq);
    float* ls = stats + (j & 1) * 2 * kBq;
    stage_stats<kBq>(ls, ls + kBq, a,
                     (static_cast<long long>(b) * a.hq + h) * n + q0, nq);
  };
  if (n_tiles > 0) stage(0);
  cp_async_commit();

  float dk[kDw / 8][4], dv[kDw / 8][4];
#pragma unroll
  for (int i = 0; i < kDw / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;
  unsigned kh[P::kKvHold ? kKs : 1][4], vh[P::kKvHold ? kKs : 1][4];

  for (int j = 0; j < n_tiles; ++j) {
    ring_step<2>(j, n_tiles, stage);
    if constexpr (P::kKvHold) {
      if (j == 0) {
#pragma unroll
        for (int kk = 0; kk < kKs; ++kk) {
          a_frag<kS>(kh[kk], ks, 16 * strip, 16 * kk, lane);
          a_frag<kS>(vh[kk], vs, 16 * strip, 16 * kk, lane);
        }
      }
    }
    const bf16* qs = ring + (j & 1) * 2 * kBq * kS;
    const bf16* dos = qs + kBq * kS;
    const float* ls = stats + (j & 1) * 2 * kBq;
    const float* dl = ls + kBq;
    const int q0 = (t_lo + j % n_qt) * kBq;

    for (int c = 0; c < kBq; c += 16) {
      const int qa = q0 + c, cq = min(16, n - qa);
      if (none_live(qa, cq, kw, ckw, a)) continue;
      const bool whole = cq == 16 && ckw == 16 && all_live(qa, 16, kw, 16, a);
      // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x 16 queries
      float sc[2][4] = {}, dp[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < kKs; ++kk) {
        unsigned ak[4], av[4], bq[4], bo[4];
        if constexpr (P::kKvHold) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ak[e] = kh[kk][e];
            av[e] = vh[kk][e];
          }
        } else {
          a_frag<kS>(ak, ks, 16 * strip, 16 * kk, lane);
          a_frag<kS>(av, vs, 16 * strip, 16 * kk, lane);
        }
        b_rows<kS>(bq, qs, c, 16 * kk, lane);
        b_rows<kS>(bo, dos, c, 16 * kk, lane);
        mma_bf16(sc[0], ak, bq[0], bq[1]);
        mma_bf16(sc[1], ak, bq[2], bq[3]);
        mma_bf16(dp[0], av, bo[0], bo[1]);
        mma_bf16(dp[1], av, bo[2], bo[3]);
      }
      // P^T and dS^T in place: key kw + gq (+ 8), query qa + 8 nt + 2 tq (+ 1)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = c + 8 * nt + 2 * tq + (e & 1);
          float p = __expf(sc[nt][e] * a.scale - ls[qi]);
          if (!whole) {
            const int key = kw + gq + 8 * (e >> 1);
            if (!(q0 + qi < n && key < n && sees(q0 + qi, key, a))) p = 0.f;
          }
          sc[nt][e] = p;
          dp[nt][e] = p * (dp[nt][e] - dl[qi]);
        }
      unsigned ap[4], ad[4];
      pack_a(ap, sc);
      pack_a(ad, dp);
      // dV += P^T dO and dK += dS^T Q over this warp's dims
#pragma unroll
      for (int dt = 0; dt < kDw / 16; ++dt) {
        const int d0 = part * kDw + 16 * dt;
        unsigned bo[4], bq[4];
        b_cols<kS>(bo, dos, c, d0, lane);
        b_cols<kS>(bq, qs, c, d0, lane);
        mma_bf16(dv[2 * dt], ap, bo[0], bo[1]);
        mma_bf16(dv[2 * dt + 1], ap, bo[2], bo[3]);
        mma_bf16(dk[2 * dt], ad, bq[0], bq[1]);
        mma_bf16(dk[2 * dt + 1], ad, bq[2], bq[3]);
      }
    }
  }
  cp_async_wait_all();

  bf16* dkg = static_cast<bf16*>(a.dk) + b * a.dk_b + g * a.dk_h;
  bf16* dvg = static_cast<bf16*>(a.dv) + b * a.dv_b + g * a.dv_h;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = kw + gq + 8 * hh;
    if (key >= n) continue;
#pragma unroll
    for (int nt = 0; nt < kDw / 8; ++nt) {
      const int d = part * kDw + 8 * nt + 2 * tq;
      store2(dkg + static_cast<long long>(key) * a.dk_t + d,
             dk[nt][2 * hh] * a.scale, dk[nt][2 * hh + 1] * a.scale);
      store2(dvg + static_cast<long long>(key) * a.dv_t + d, dv[nt][2 * hh],
             dv[nt][2 * hh + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(Tc<D>::kQWarps * kWarp)
    attn_bwd_dq_mma(const Args a, int batch) {
  using P = Tc<D>;
  constexpr int kS = P::kStride, kBq = P::kQRows, kBk = P::kQKeys;
  constexpr int kKs = D / 16;

  extern __shared__ float4 smem4[];
  bf16* qs = reinterpret_cast<bf16*>(smem4);  // [kBq][kS]
  bf16* dos = qs + kBq * kS;                  // [kBq][kS]
  bf16* ring = dos + kBq * kS;                // [stage][K, V][kBk][kS]

  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int gq = lane >> 2, tq = lane & 3;
  const int n = a.s_len, n_qt = (n + kBq - 1) / kBq;
  const int units = a.hq * batch;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / units;
  const int rest = blockIdx.x % units, h = rest % a.hq, b = rest / a.hq;
  const int g = h / a.group;
  const int q0 = qt * kBq, nq = min(kBq, n - q0);
  const int wq = q0 + 16 * warp;  // this warp's first row
  const int cwq = min(16, n - wq);

  stage_rows<D, kBq, kS>(qs,
                         static_cast<const bf16*>(a.q) + b * a.q_b +
                             h * a.q_h + static_cast<long long>(q0) * a.q_s,
                         a.q_s, nq);
  stage_rows<D, kBq, kS>(dos,
                         static_cast<const bf16*>(a.dout) + b * a.do_b +
                             h * a.do_h + static_cast<long long>(q0) * a.do_s,
                         a.do_s, nq);

  const int k_lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int k_hi = a.causal ? min(n, q0 + nq) : n;
  const int t_lo = k_lo / kBk, n_tiles = (k_hi + kBk - 1) / kBk - t_lo;
  const bf16* kg = static_cast<const bf16*>(a.k) + b * a.k_b + g * a.k_h;
  const bf16* vg = static_cast<const bf16*>(a.v) + b * a.v_b + g * a.v_h;
  auto stage = [&](int j) {
    const int k0 = (t_lo + j) * kBk, nk = min(kBk, n - k0);
    bf16* kst = ring + (j & 1) * 2 * kBk * kS;
    stage_rows<D, kBk, kS>(kst, kg + static_cast<long long>(k0) * a.k_t,
                           a.k_t, nk);
    stage_rows<D, kBk, kS>(kst + kBk * kS,
                           vg + static_cast<long long>(k0) * a.v_t, a.v_t,
                           nk);
  };
  if (n_tiles > 0) stage(0);
  cp_async_commit();

  // lse and D of this thread's rows wq + gq and wq + gq + 8
  const long long row0 = (static_cast<long long>(b) * a.hq + h) * n;
  float lr[2], dr[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = wq + gq + 8 * hh;
    lr[hh] = i < n ? a.lse[row0 + i] : 0.f;
    dr[hh] = i < n ? a.delta[row0 + i] : 0.f;
  }
  float dq[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[i][e] = 0.f;
  unsigned qh[P::kQHold ? kKs : 1][4], oh[P::kQHold ? kKs : 1][4];

  for (int j = 0; j < n_tiles; ++j) {
    ring_step<2>(j, n_tiles, stage);
    if constexpr (P::kQHold) {
      if (j == 0) {
#pragma unroll
        for (int kk = 0; kk < kKs; ++kk) {
          a_frag<kS>(qh[kk], qs, 16 * warp, 16 * kk, lane);
          a_frag<kS>(oh[kk], dos, 16 * warp, 16 * kk, lane);
        }
      }
    }
    const bf16* ks = ring + (j & 1) * 2 * kBk * kS;
    const bf16* vs = ks + kBk * kS;
    const int k0 = (t_lo + j) * kBk;

    for (int c = 0; c < kBk; c += 16) {
      const int ka = k0 + c, ck = min(16, n - ka);
      if (none_live(wq, cwq, ka, ck, a)) continue;
      const bool whole = cwq == 16 && ck == 16 && all_live(wq, 16, ka, 16, a);
      // S = Q K^T and dP = dO V^T: this warp's 16 rows x 16 keys
      float sc[2][4] = {}, dp[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < kKs; ++kk) {
        unsigned aq[4], ao[4], bk[4], bv[4];
        if constexpr (P::kQHold) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            aq[e] = qh[kk][e];
            ao[e] = oh[kk][e];
          }
        } else {
          a_frag<kS>(aq, qs, 16 * warp, 16 * kk, lane);
          a_frag<kS>(ao, dos, 16 * warp, 16 * kk, lane);
        }
        b_rows<kS>(bk, ks, c, 16 * kk, lane);
        b_rows<kS>(bv, vs, c, 16 * kk, lane);
        mma_bf16(sc[0], aq, bk[0], bk[1]);
        mma_bf16(sc[1], aq, bk[2], bk[3]);
        mma_bf16(dp[0], ao, bv[0], bv[1]);
        mma_bf16(dp[1], ao, bv[2], bv[3]);
      }
      // dS in place: row wq + gq (+ 8), key ka + 8 nt + 2 tq (+ 1)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hh = e >> 1;
          float p = __expf(sc[nt][e] * a.scale - lr[hh]);
          if (!whole) {
            const int i = wq + gq + 8 * hh;
            const int key = ka + 8 * nt + 2 * tq + (e & 1);
            if (!(i < n && key < n && sees(i, key, a))) p = 0.f;
          }
          dp[nt][e] = p * (dp[nt][e] - dr[hh]);
        }
      unsigned ad[4];
      pack_a(ad, dp);
      // dQ += dS K
#pragma unroll
      for (int dt = 0; dt < D / 16; ++dt) {
        unsigned bk[4];
        b_cols<kS>(bk, ks, c, 16 * dt, lane);
        mma_bf16(dq[2 * dt], ad, bk[0], bk[1]);
        mma_bf16(dq[2 * dt + 1], ad, bk[2], bk[3]);
      }
    }
  }
  cp_async_wait_all();

  bf16* dqg = static_cast<bf16*>(a.dq) + b * a.dq_b + h * a.dq_h;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = wq + gq + 8 * hh;
    if (i >= n) continue;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      store2(dqg + static_cast<long long>(i) * a.dq_s + 8 * nt + 2 * tq,
             dq[nt][2 * hh] * a.scale, dq[nt][2 * hh + 1] * a.scale);
  }
}

// ---------------------------------------------------------------- launch

template <typename K>
cudaError_t allow_smem(K* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// blocks of a one-dimensional grid, or 0 past its limit
unsigned grid_of(long long tiles, long long units) {
  const long long n = tiles * units;
  return n > INT_MAX ? 0u : static_cast<unsigned>(n);
}

template <int D, typename T>
int launch(const Args& a, int batch, int hkv, cudaStream_t st) {
  const long long n_rows = static_cast<long long>(batch) * a.hq * a.s_len;
  const long long rows_per_block = kDeltaThreads / kWarp;
  attn_bwd_delta<D, T><<<static_cast<unsigned>(
                             (n_rows + rows_per_block - 1) / rows_per_block),
                         kDeltaThreads, 0, st>>>(a, n_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if constexpr (std::is_same_v<T, float>) {
    using C = Fma<D>;
    static const cudaError_t attr_kv = allow_smem(attn_bwd_dkdv<D>, C::kSmemKv);
    static const cudaError_t attr_q = allow_smem(attn_bwd_dq<D>, C::kSmemQ);
    if (attr_kv != cudaSuccess) return attr_kv;
    if (attr_q != cudaSuccess) return attr_q;
    const unsigned grid_kv = grid_of((a.s_len + C::kKvKeys - 1) / C::kKvKeys,
                                     static_cast<long long>(hkv) * batch);
    const unsigned grid_q = grid_of((a.s_len + C::kQRows - 1) / C::kQRows,
                                    static_cast<long long>(a.hq) * batch);
    if (grid_kv == 0 || grid_q == 0) return cudaErrorInvalidValue;
    attn_bwd_dkdv<D><<<grid_kv, C::kThreads, C::kSmemKv, st>>>(a, hkv);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    attn_bwd_dq<D><<<grid_q, C::kThreads, C::kSmemQ, st>>>(a, batch);
  } else {
    using P = Tc<D>;
    static const cudaError_t attr_kv =
        allow_smem(attn_bwd_dkdv_mma<D>, P::kSmemKv);
    static const cudaError_t attr_q = allow_smem(attn_bwd_dq_mma<D>, P::kSmemQ);
    if (attr_kv != cudaSuccess) return attr_kv;
    if (attr_q != cudaSuccess) return attr_q;
    const unsigned grid_kv = grid_of((a.s_len + P::kKvKeys - 1) / P::kKvKeys,
                                     static_cast<long long>(hkv) * batch);
    const unsigned grid_q = grid_of((a.s_len + P::kQRows - 1) / P::kQRows,
                                    static_cast<long long>(a.hq) * batch);
    if (grid_kv == 0 || grid_q == 0) return cudaErrorInvalidValue;
    attn_bwd_dkdv_mma<D><<<grid_kv, P::kKvWarps * kWarp, P::kSmemKv, st>>>(
        a, hkv);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    attn_bwd_dq_mma<D><<<grid_q, P::kQWarps * kWarp, P::kSmemQ, st>>>(a,
                                                                      batch);
  }
  return cudaGetLastError();
}

template <typename T>
int dispatch(const Args& a, int d, int batch, int hkv, cudaStream_t st) {
  switch (d) {
    case 16: return launch<16, T>(a, batch, hkv, st);
    case 32: return launch<32, T>(a, batch, hkv, st);
    case 48: return launch<48, T>(a, batch, hkv, st);
    case 64: return launch<64, T>(a, batch, hkv, st);
    case 128: return launch<128, T>(a, batch, hkv, st);
    case 256: return launch<256, T>(a, batch, hkv, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launch K5's backward: q, o, dout, dq [B, Hq, S, D]; k, v, dk, dv
// [B, Hkv, S, D] (S = T, kv_offset 0), each given by its base pointer
// and its batch, head and position strides in elements (the head
// dimension contiguous, every pointer and stride aligned to 16 bytes);
// lse the forward's float32 [B, Hq, S], contiguous; delta float32
// scratch of the same shape.  is_bf16 selects bfloat16 for the eight
// tensors; otherwise float32.  window <= 0 means no window.  Returns a
// cudaError_t (0 = launched).
int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, long long q_b, long long q_h, long long q_s, long long k_b,
    long long k_h, long long k_t, long long v_b, long long v_h, long long v_t,
    long long o_b, long long o_h, long long o_s, long long do_b,
    long long do_h, long long do_s, long long dq_b, long long dq_h,
    long long dq_s, long long dk_b, long long dk_h, long long dk_t,
    long long dv_b, long long dv_h, long long dv_t, int batch, int hq,
    int hkv, int s_len, int d, int is_bf16, int causal, int window,
    float scale, void* stream) {
  if (batch <= 0 || s_len <= 0 || hkv <= 0 || hq % hkv != 0) return 0;
  const Args a{q,    k,    v,    o,    dout, static_cast<const float*>(lse),
               static_cast<float*>(delta), dq, dk, dv,
               q_b,  q_h,  q_s,  k_b,  k_h,  k_t,  v_b,  v_h,  v_t,
               o_b,  o_h,  o_s,  do_b, do_h, do_s,
               dq_b, dq_h, dq_s, dk_b, dk_h, dk_t, dv_b, dv_h, dv_t,
               s_len, hq, hq / hkv, causal, window, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<bf16>(a, d, batch, hkv, st)
                 : dispatch<float>(a, d, batch, hkv, st);
}

}  // extern "C"
