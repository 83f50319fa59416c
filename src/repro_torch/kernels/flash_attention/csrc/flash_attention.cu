// K5 for Hopper: the forward pass of causal, windowed, grouped-query
// attention with an online softmax (FlashAttention-2's recurrence).
//
// Replaces repro/kernels/flash_attention/flash_attention.py:flash_attention
// (its Pallas body _kernel).  For each batch b and query head h, with
// kv head g = h / (Hq / Hkv) and query positions qpos = i + kv_offset,
//
//   o[b, h, i] = sum_t softmax_t(scale * q[b, h, i] . k[b, g, t]) v[b, g, t]
//
// over the live keys t: t < T, t <= qpos (causal), qpos - t < window
// (when a window is given).  The running max, the running sum and the
// accumulator are float32; inputs are float32 or bfloat16 and the output
// is in the inputs' type.  A row with no live key is written as zeros
// (the row guard max(l, 1e-30) of the TPU kernel).
//
// Layout: every operand is read through its own element strides for the
// batch, head and sequence axes, with the head dimension contiguous.  The
// wrapper hands in [B, H, S, D] views; the transformer's q and KV cache
// are [B, S, H, D] and [B, T, Hkv, D] in memory, so those views are
// transposes and nothing is copied.  The wrapper allocates the output as
// [B, S, Hq, D] and returns its [B, Hq, S, D] view.
//
// The TPU form (a grid of (BQ, BK) tiles, one query head per program, the
// KV axis as a sequential grid dimension carrying VMEM scratch) does not
// carry over.  A "row" here is one (query position, query head) pair of a
// kv head's group, so the Hq/Hkv heads that share a kv head share a block
// and every K/V tile staged in shared memory serves all of them.  K/V
// tiles go through a ring of two stages filled by cp.async, so the next
// tile's loads are in flight while the current one is used; rows past the
// live keys are zero-filled and never read from memory.  Two forms:
//
//   * prefill (S > 1), bound by operations; float32 on the CUDA cores'
//     FMA, whose rate (67 TFLOP/s) is its bound.  At D <= 64 (the served
//     models' widths) the scores and the output are register-tiled as in
//     a SIMT GEMM: 4 warps of 32 rows, each lane a 4-row x 8-key tile of
//     scores (q^T staged once, k^T per tile: 3 shared loads per 32 FMAs)
//     and a 4-row x D/4 tile of the output (p^T through the warp's shared
//     rows).  At D = 128 and 256 that output tile would not fit in
//     registers, so there lane j scores key j of each 32-key slice
//     against the 8 (4) rows of its warp and owns output dims j, j + 32,
//     ...  A tensor-core form, q.k^T and p.v with mma.sync m16n8k8 on
//     operands split into TF32 hi and lo parts (lo.hi + hi.lo + hi.hi,
//     "3xTF32"), was built and measured: faster than FMA, but up to
//     1.5e-4 from the plain version on the served model's activations,
//     past the 2e-5 (1 + |plain|) gate, since a split operand keeps ~22
//     bits and not 24 (PERF.md).  bfloat16 does run on the tensor cores:
//     4 warps of 16 rows run q.k^T and p.v with mma.sync m16n8k16, p
//     rounded to bfloat16 and kept in registers (the accumulator layout of
//     two 8-key score tiles is the A-operand layout of a 16-key k-step,
//     FlashAttention-2's reuse).  Every form walks its block's K/V tiles
//     from the window's edge to the causal frontier of its last row, and
//     a warp skips the tiles that are dead for all its rows.
//   * decode (S = 1), bound by bytes: the keys of the live range are cut
//     into splits (chosen by the wrapper from the range, which it knows on
//     the host, so that batch x kv heads x splits fills the 132 SMs).  One
//     block of 2 warps per (split, batch, kv head, 4 query heads); each
//     warp scores its slice of every tile (one to four lanes per key,
//     float32 FMA) and keeps its own running max, sum and accumulator,
//     which it writes to float32 scratch.  A second launch merges the
//     parts of each row in their fixed order with the log-sum-exp
//     rescale; an empty part (max -inf, sum 0) adds nothing.  The tiles
//     are small (~70 KB of shared memory a block) so several blocks fit on
//     an SM and keep the loads of several tiles in flight.
//
// Both forms give the same bits on the same operands: no atomics, and
// every sum runs in a fixed order.
//
// For training, a prefill launch can also write each query row's
// log-sum-exp (m + log l, in units of the scaled scores; +inf for a row
// with no live key) to a float32 [B, Hq, S] buffer, which K5's backward
// (flash_attention_bwd.cu) reads.  With a null pointer nothing is
// written and the launch is the serving one.
//
// Plain C interface (built with nvcc into a shared library, bound with
// ctypes).  The entry point launches on the given stream, allocates
// nothing, sets each kernel's shared-memory limit once, and returns
// cudaGetLastError() so a refused launch is never silent.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kWarp = 32;
constexpr float kNeg = -1e30f;  // masked score (the TPU's NEG_INF)

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_b, q_h, q_s;  // element strides of q's batch, head, position
  long long k_b, k_h, k_t;
  long long v_b, v_h, v_t;
  long long o_b, o_h, o_s;
  int s_len, t_len, group, hq;  // group = Hq / Hkv
  int causal, window, kv_offset;  // window <= 0: none
  float scale;
  // decode: the splits [split_start + i * split_len, + split_len) of the
  // live keys, i < n_splits, and the float32 scratch of their parts
  int split_start, split_len, n_splits;
  float* part;
  float* lse;  // prefill: [B, Hq, S] log-sum-exp of each row, or null
};

// the log-sum-exp of a row from its running max and sum
__device__ __forceinline__ float row_lse(float m, float l) {
  return l > 0.f ? m + logf(l) : __int_as_float(0x7f800000);
}

// ------------------------------------------------------------- helpers

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// 16 bytes of T from shared memory as float32: 4 float32 or 8 bfloat16
__device__ __forceinline__ void load_unit(const float* p, float (&x)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  x[0] = u.x;
  x[1] = u.y;
  x[2] = u.z;
  x[3] = u.w;
}
__device__ __forceinline__ void load_unit(const __nv_bfloat16* p,
                                          float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// Copy 16 bytes from global to shared memory asynchronously; when !pred
// the 16 bytes are zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
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

// --------------------------------------------------- tensor-core products

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ unsigned ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&x);
}

__device__ __forceinline__ unsigned pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  __nv_bfloat162 x;
  x.x = lo;
  x.y = hi;
  return *reinterpret_cast<const unsigned*>(&x);
}

// ---------------------------------------------------------------- prefill

// float32 at D = 128 and 256 on the CUDA cores' FMA, a key per lane.
// Rows per warp by head width, and keys per staged tile: one 32-key
// slice, so two stages of K (rows padded by four floats, so the float4
// reads of 32 lanes on 32 rows are free of bank conflicts) and of V, the
// rows and the probabilities take 85 KB at D = 128, 147 KB at D = 256.
template <int D> struct Fma {
  static_assert(D == 128 || D == 256, "D <= 64 runs attn_prefill_tiled");
  static constexpr int kRpw = D == 256 ? 4 : 8, kKeys = 32;
};

constexpr int kFmaWarps = 4;

template <int D>
constexpr size_t fma_smem() {
  constexpr int rows = kFmaWarps * Fma<D>::kRpw, keys = Fma<D>::kKeys;
  return sizeof(float) *
         static_cast<size_t>(rows * D + 2 * keys * (D + 4) + 2 * keys * D +
                             rows * kWarp);
}

// Each warp owns kRpw rows; per 32-key slice, lane j scores key j against
// all of the warp's rows, the warp's max updates each row's running max,
// and the probabilities go through shared memory (float4 broadcast reads)
// into the accumulators, lane j owning output dims j, j + 32, ...
template <int D>
__global__ void __launch_bounds__(kFmaWarps * kWarp)
    attn_prefill_fma(const Args a) {
  constexpr int kRpw = Fma<D>::kRpw, kKeys = Fma<D>::kKeys;
  constexpr int kRows = kFmaWarps * kRpw;
  constexpr int kKs = D + 4;                    // padded K row
  constexpr int kNi = (D + kWarp - 1) / kWarp;  // output dims per lane
  static_assert(D % 8 == 0 && kKeys % kWarp == 0, "tile shape");

  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kRows][D]
  float* kbuf = qs + kRows * D;                 // [stage][kKeys][kKs]
  float* vbuf = kbuf + 2 * kKeys * kKs;         // [stage][kKeys][D]
  float* ps = vbuf + 2 * kKeys * D;             // [kRows][32]

  const int b = blockIdx.z, kvh = blockIdx.y;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int n_rows = a.s_len * a.group;
  const int row0 = blockIdx.x * kRows;
  const int last = min(row0 + kRows, n_rows) - 1;

  // The block's live keys: from the window's edge of its first row to the
  // causal frontier of its last row.
  const int pos_lo = row0 / a.group + a.kv_offset;
  const int pos_hi = last / a.group + a.kv_offset;
  const int k_end = a.causal ? min(a.t_len, pos_hi + 1) : a.t_len;
  const int k_begin = a.window > 0 ? max(0, pos_lo - a.window + 1) : 0;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kKeys - 1) / kKeys
                                      : 0;

  const float* kg = static_cast<const float*>(a.k) + b * a.k_b + kvh * a.k_h;
  const float* vg = static_cast<const float*>(a.v) + b * a.v_b + kvh * a.v_h;
  auto stage = [&](int it) {
    const int k0 = k_begin + it * kKeys, nk = min(kKeys, k_end - k0);
    stage_rows<D, kKeys, kKs>(kbuf + (it & 1) * kKeys * kKs,
                              kg + static_cast<long long>(k0) * a.k_t, a.k_t,
                              nk);
    stage_rows<D, kKeys, D>(vbuf + (it & 1) * kKeys * D,
                            vg + static_cast<long long>(k0) * a.v_t, a.v_t,
                            nk);
  };
  if (n_tiles > 0) stage(0);
  cp_async_commit();

  // the block's query rows
  const float* qg = static_cast<const float*>(a.q) + b * a.q_b;
  for (int e = threadIdx.x; e < kRows * (D / 4); e += blockDim.x) {
    const int r = e / (D / 4), c = (e % (D / 4)) * 4;
    const int row = row0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < n_rows) {
      const int h = kvh * a.group + row % a.group;
      x = *reinterpret_cast<const float4*>(
          qg + h * a.q_h + static_cast<long long>(row / a.group) * a.q_s + c);
    }
    *reinterpret_cast<float4*>(qs + r * D + c) = x;
  }

  int qpos[kRpw];
  bool valid[kRpw];
  float m[kRpw], l[kRpw], acc[kRpw][kNi];
#pragma unroll
  for (int r = 0; r < kRpw; ++r) {
    const int row = row0 + warp * kRpw + r;
    valid[r] = row < n_rows;
    qpos[r] = row / a.group + a.kv_offset;
    m[r] = kNeg;
    l[r] = 0.f;  // this lane's share of the row's sum
#pragma unroll
    for (int i = 0; i < kNi; ++i) acc[r][i] = 0.f;
  }
  const bool warp_live = row0 + warp * kRpw < n_rows;
  const float* wq = qs + warp * kRpw * D;
  float* wp = ps + warp * kRpw * kWarp;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) stage(it + 1);  // its stage was freed last round
    cp_async_commit();
    cp_async_wait<1>();  // every group but the newest: tile it has landed
    __syncthreads();
    const int k0 = k_begin + it * kKeys;
    const int nk = min(kKeys, k_end - k0);
    const float* ks = kbuf + (it & 1) * kKeys * kKs;
    const float* vs = vbuf + (it & 1) * kKeys * D;
    for (int j0 = 0; warp_live && j0 < nk; j0 += kWarp) {
      // scores of key k0 + j0 + lane against the warp's rows
      const int key = k0 + j0 + lane;
      float s[kRpw];
#pragma unroll
      for (int r = 0; r < kRpw; ++r) s[r] = 0.f;
      const float* kr = ks + (j0 + lane) * kKs;
#pragma unroll 4
      for (int c = 0; c < D; c += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(kr + c);
#pragma unroll
        for (int r = 0; r < kRpw; ++r) {
          const float4 qq = *reinterpret_cast<const float4*>(wq + r * D + c);
          s[r] = fmaf(qq.x, kk.x, s[r]);
          s[r] = fmaf(qq.y, kk.y, s[r]);
          s[r] = fmaf(qq.z, kk.z, s[r]);
          s[r] = fmaf(qq.w, kk.w, s[r]);
        }
      }
      // online softmax: running max per row, probabilities to smem
#pragma unroll
      for (int r = 0; r < kRpw; ++r) {
        const bool live = valid[r] && j0 + lane < nk &&
                          (!a.causal || key <= qpos[r]) &&
                          (a.window <= 0 || qpos[r] - key < a.window);
        const float sc = live ? s[r] * a.scale : kNeg;
        const float mn = fmaxf(m[r], warp_max(sc));
        const float p = live ? expf(sc - mn) : 0.f;
        const float alpha = expf(m[r] - mn);
        l[r] = l[r] * alpha + p;
#pragma unroll
        for (int i = 0; i < kNi; ++i) acc[r][i] *= alpha;
        m[r] = mn;
        wp[r * kWarp + lane] = p;
      }
      __syncwarp();
      // acc[r][dims of this lane] += sum_j p[r][j] * v[j][dims]
      const int nj = min(kWarp, nk - j0);
      for (int jj = 0; jj < nj; jj += 4) {
        float4 pp[kRpw];
#pragma unroll
        for (int r = 0; r < kRpw; ++r)
          pp[r] = *reinterpret_cast<const float4*>(wp + r * kWarp + jj);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float* vr = vs + (j0 + jj + c) * D;
          float vv[kNi];
#pragma unroll
          for (int i = 0; i < kNi; ++i) {
            const int d = lane + kWarp * i;
            vv[i] = d < D ? vr[d] : 0.f;
          }
#pragma unroll
          for (int r = 0; r < kRpw; ++r) {
            const float pc = c == 0 ? pp[r].x
                             : c == 1 ? pp[r].y
                             : c == 2 ? pp[r].z
                                      : pp[r].w;
#pragma unroll
            for (int i = 0; i < kNi; ++i)
              acc[r][i] = fmaf(pc, vv[i], acc[r][i]);
          }
        }
      }
      __syncwarp();  // wp is rewritten by the next slice
    }
    __syncthreads();  // the stage is refilled two rounds on
  }
  cp_async_wait<0>();
  if (!warp_live) return;

  float* og = static_cast<float*>(a.o) + b * a.o_b;
#pragma unroll
  for (int r = 0; r < kRpw; ++r) {
    const float sum = warp_sum(l[r]);
    const float denom = fmaxf(sum, 1e-30f);
    if (!valid[r]) continue;
    const int row = row0 + warp * kRpw + r;
    const int h = kvh * a.group + row % a.group;
    if (a.lse != nullptr && lane == 0)
      a.lse[(static_cast<long long>(b) * a.hq + h) * a.s_len + row / a.group] =
          row_lse(m[r], sum);
    float* orow =
        og + h * a.o_h + static_cast<long long>(row / a.group) * a.o_s;
#pragma unroll
    for (int i = 0; i < kNi; ++i) {
      const int d = lane + kWarp * i;
      if (d < D) orow[d] = acc[r][i] / denom;
    }
  }
}

// float32 at D <= 64, register-tiled as a SIMT GEMM.  One block of 4
// warps per (batch, kv head, 128 rows), 32 rows a warp; with g = lane / 4
// and c = lane % 4, a lane computes the scores of rows 4 g .. 4 g + 3
// against keys 8 c .. 8 c + 7 of each 32-key tile (one float4 of q^T and
// two of k^T per column: 3 shared loads for 32 FMAs) and accumulates the
// same rows' output over dims 16 u + 4 c .. 16 u + 4 c + 3 (one float4 of
// p^T and D / 16 of v per key).  q^T is staged once, k^T per tile from
// the ring, and p^T goes through the warp's own shared rows; the four
// lanes of a row group share its running max by two shuffles.
template <int D>
struct Tiled {
  static constexpr int kWarps = 4;
  static constexpr int kRows = 32 * kWarps;  // rows per block
  static constexpr int kKeys = 32;           // keys per tile
  static constexpr int kDl = D / 4;          // output dims per lane
  static constexpr int kQs = kRows + 4;      // q^T row (one dim)
  static constexpr int kKs = D + 4;          // staged K/V row (one key)
  static constexpr int kKt = kKeys + 4;      // k^T row (one dim)
  static constexpr int kPt = 32 + 4;         // p^T row (one key, a warp's rows)
  static constexpr size_t kSmem =
      sizeof(float) * static_cast<size_t>(D * kQs + 2 * 2 * kKeys * kKs +
                                          D * kKt + kWarps * kKeys * kPt);
};

template <int D>
__global__ void __launch_bounds__(Tiled<D>::kWarps * kWarp)
    attn_prefill_tiled(const Args a) {
  using P = Tiled<D>;
  constexpr int kRows = P::kRows, kKeys = P::kKeys, kDl = P::kDl;
  constexpr int kQs = P::kQs, kKs = P::kKs, kKt = P::kKt, kPt = P::kPt;
  static_assert(D % 16 == 0, "dims in float4 groups of 16");

  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // [D][kQs]
  float* ring = qt + D * kQs;                   // [stage][K, V][kKeys][kKs]
  float* kt = ring + 2 * 2 * kKeys * kKs;       // [D][kKt]
  float* pt = kt + D * kKt;                     // [warp][kKeys][kPt]

  const int b = blockIdx.z, kvh = blockIdx.y;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int g = lane >> 2, c4 = lane & 3;
  const int n_rows = a.s_len * a.group;
  const int row0 = blockIdx.x * kRows;
  const int last = min(row0 + kRows, n_rows) - 1;

  // The block's live keys: from the window's edge of its first row to the
  // causal frontier of its last row.
  const int pos_lo = row0 / a.group + a.kv_offset;
  const int pos_hi = last / a.group + a.kv_offset;
  const int k_end = a.causal ? min(a.t_len, pos_hi + 1) : a.t_len;
  const int k_begin = a.window > 0 ? max(0, pos_lo - a.window + 1) : 0;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kKeys - 1) / kKeys
                                      : 0;

  const float* kg = static_cast<const float*>(a.k) + b * a.k_b + kvh * a.k_h;
  const float* vg = static_cast<const float*>(a.v) + b * a.v_b + kvh * a.v_h;
  auto stage = [&](int it) {
    const int k0 = k_begin + it * kKeys, nk = min(kKeys, k_end - k0);
    float* ks = ring + (2 * (it & 1)) * kKeys * kKs;
    stage_rows<D, kKeys, kKs>(ks, kg + static_cast<long long>(k0) * a.k_t,
                              a.k_t, nk);
    stage_rows<D, kKeys, kKs>(ks + kKeys * kKs,
                              vg + static_cast<long long>(k0) * a.v_t, a.v_t,
                              nk);
  };
  if (n_tiles > 0) stage(0);
  cp_async_commit();

  // q^T of the block's rows (zeros past n_rows), consecutive threads on
  // consecutive rows
  const float* qg = static_cast<const float*>(a.q) + b * a.q_b;
  for (int e = threadIdx.x; e < kRows * (D / 4); e += blockDim.x) {
    const int r = e % kRows, c = (e / kRows) * 4, row = row0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < n_rows)
      x = *reinterpret_cast<const float4*>(
          qg + (kvh * a.group + row % a.group) * a.q_h +
          static_cast<long long>(row / a.group) * a.q_s + c);
    qt[c * kQs + r] = x.x;
    qt[(c + 1) * kQs + r] = x.y;
    qt[(c + 2) * kQs + r] = x.z;
    qt[(c + 3) * kQs + r] = x.w;
  }

  // this lane's rows 4 g .. 4 g + 3 of the warp's 32
  const int wrow = row0 + warp * 32;
  const bool warp_live = wrow < n_rows;
  const int wpos_lo = wrow / a.group + a.kv_offset;
  const int wpos_hi = min(wrow + 31, n_rows - 1) / a.group + a.kv_offset;
  int pos[4];
  bool valid[4];
  float m[4], l[4], o[4][kDl];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = wrow + 4 * g + i;
    valid[i] = row < n_rows;
    pos[i] = row / a.group + a.kv_offset;
    m[i] = kNeg;
    l[i] = 0.f;  // this lane's share of the row's sum
#pragma unroll
    for (int d = 0; d < kDl; ++d) o[i][d] = 0.f;
  }
  float* wpt = pt + warp * kKeys * kPt;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) stage(it + 1);  // its stage was freed last round
    cp_async_commit();
    cp_async_wait<1>();  // every group but the newest: tile it has landed
    __syncthreads();
    const int k0 = k_begin + it * kKeys;
    const int nk = min(kKeys, k_end - k0);
    const float* ks = ring + (2 * (it & 1)) * kKeys * kKs;
    const float* vs = ks + kKeys * kKs;
    // k^T of the tile, consecutive threads on consecutive keys
    for (int e = threadIdx.x; e < kKeys * (D / 4); e += blockDim.x) {
      const int j = e % kKeys, c = (e / kKeys) * 4;
      const float4 x = *reinterpret_cast<const float4*>(ks + j * kKs + c);
      kt[c * kKt + j] = x.x;
      kt[(c + 1) * kKt + j] = x.y;
      kt[(c + 2) * kKt + j] = x.z;
      kt[(c + 3) * kKt + j] = x.w;
    }
    __syncthreads();
    const bool dead = !warp_live || (a.causal && k0 > wpos_hi) ||
                      (a.window > 0 && k0 + nk - 1 <= wpos_lo - a.window);
    if (!dead) {
      float s[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
      const float* qw = qt + warp * 32 + 4 * g;
      const float* kw = kt + 8 * c4;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float4 qq = *reinterpret_cast<const float4*>(qw + d * kQs);
        const float4 ka = *reinterpret_cast<const float4*>(kw + d * kKt);
        const float4 kb = *reinterpret_cast<const float4*>(kw + d * kKt + 4);
        const float qv[4] = {qq.x, qq.y, qq.z, qq.w};
        const float kv[8] = {ka.x, ka.y, ka.z, ka.w, kb.x, kb.y, kb.z, kb.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
      // mask and scale; each row's max over its four lanes; probabilities
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float tm = kNeg;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int key = k0 + 8 * c4 + j;
          const bool live = valid[i] && 8 * c4 + j < nk &&
                            (!a.causal || key <= pos[i]) &&
                            (a.window <= 0 || pos[i] - key < a.window);
          s[i][j] = live ? s[i][j] * a.scale : kNeg;
          tm = fmaxf(tm, s[i][j]);
        }
        tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, 1));
        tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, 2));
        const float mn = fmaxf(m[i], tm);
        const float alpha = expf(m[i] - mn);
        m[i] = mn;
        l[i] *= alpha;
#pragma unroll
        for (int d = 0; d < kDl; ++d) o[i][d] *= alpha;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] = s[i][j] == kNeg ? 0.f : expf(s[i][j] - mn);
          l[i] += s[i][j];
        }
      }
      // p^T: keys 8 c .. 8 c + 7, rows 4 g .. 4 g + 3 of the warp
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<float4*>(wpt + (8 * c4 + j) * kPt + 4 * g) =
            make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
      __syncwarp();
      // o[rows][dims 16 u + 4 c + x] += sum_j p[rows][j] v[j][dims]
#pragma unroll 4
      for (int j = 0; j < kKeys; ++j) {
        const float4 pp = *reinterpret_cast<const float4*>(wpt + j * kPt +
                                                           4 * g);
        const float pv[4] = {pp.x, pp.y, pp.z, pp.w};
        const float* vr = vs + j * kKs + 4 * c4;
#pragma unroll
        for (int u = 0; u < kDl / 4; ++u) {
          const float4 vv = *reinterpret_cast<const float4*>(vr + 16 * u);
          const float vx[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int x = 0; x < 4; ++x)
              o[i][4 * u + x] = fmaf(pv[i], vx[x], o[i][4 * u + x]);
        }
      }
      __syncwarp();  // wpt is rewritten next round
    }
    __syncthreads();  // the stage and k^T are refilled next round
  }
  cp_async_wait<0>();
  if (!warp_live) return;

  float* og = static_cast<float*>(a.o) + b * a.o_b;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float sum = l[i];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float denom = fmaxf(sum, 1e-30f);
    if (!valid[i]) continue;
    const int row = wrow + 4 * g + i;
    const int h = kvh * a.group + row % a.group;
    if (a.lse != nullptr && c4 == 0)
      a.lse[(static_cast<long long>(b) * a.hq + h) * a.s_len + row / a.group] =
          row_lse(m[i], sum);
    float* orow = og + h * a.o_h +
                  static_cast<long long>(row / a.group) * a.o_s + 4 * c4;
#pragma unroll
    for (int u = 0; u < kDl / 4; ++u)
      *reinterpret_cast<float4*>(orow + 16 * u) =
          make_float4(o[i][4 * u] / denom, o[i][4 * u + 1] / denom,
                      o[i][4 * u + 2] / denom, o[i][4 * u + 3] / denom);
  }
}

// bfloat16 on the tensor cores.  Rows per block, keys per K/V tile and
// the padded shared-memory row (8 bfloat16 past D, so the fragments'
// reads are free of bank conflicts and every row starts on 16 bytes).
template <int D>
struct Mma {
  static constexpr int kWarps = 4;
  static constexpr int kRows = 16 * kWarps;
  static constexpr int kKeys = D == 256 ? 32 : 64;
  static constexpr int kStride = D + 8;
  static constexpr int kStages = 2;
  static constexpr size_t kSmem = sizeof(__nv_bfloat16) *
      static_cast<size_t>(kRows + 2 * kStages * kKeys) * kStride;
};

// S[16 x kKeys] = q . k^T for this warp's rows, m16n8k16 (PTX ISA):
// g = lane / 4, t = lane % 4; A (row g or g + 8, k 2t, 2t + 1 or
// 2t + 8, 2t + 9), B (k 2t, 2t + 1 or 2t + 8, 2t + 9, key g), C (row g or
// g + 8, key 2t or 2t + 1)
template <int D, int kNt, int kStride>
__device__ __forceinline__ void scores(float (&s)[kNt][4],
                                       const __nv_bfloat16* qw,
                                       const __nv_bfloat16* ks, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    const __nv_bfloat16* qa = qw + g * kStride + kk + 2 * t;
    const unsigned a[4] = {ld32(qa), ld32(qa + 8 * kStride), ld32(qa + 8),
                           ld32(qa + 8 * kStride + 8)};
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) {
      const __nv_bfloat16* kb = ks + (nt * 8 + g) * kStride + kk + 2 * t;
      const unsigned b[2] = {ld32(kb), ld32(kb + 8)};
      mma_bf16(s[nt], a, b);
    }
  }
}

// o[16 x D] += p . v: the C layout of score n-tiles j, j + 1 is the A
// layout of a 16-key k-step as it is (FlashAttention-2's register reuse)
template <int D, int kNt, int kStride>
__device__ __forceinline__ void accumulate(float (&o)[D / 8][4],
                                           const float (&p)[kNt][4],
                                           const __nv_bfloat16* vs, int g,
                                           int t) {
#pragma unroll
  for (int j = 0; j < kNt; j += 2) {
    const unsigned a[4] = {pack_bf16(p[j][0], p[j][1]),
                           pack_bf16(p[j][2], p[j][3]),
                           pack_bf16(p[j + 1][0], p[j + 1][1]),
                           pack_bf16(p[j + 1][2], p[j + 1][3])};
    const __nv_bfloat16* vb = vs + (j * 8 + 2 * t) * kStride + g;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const __nv_bfloat16* c = vb + dt * 8;
      const unsigned b[2] = {pack_bf16(c[0], c[kStride]),
                             pack_bf16(c[8 * kStride], c[9 * kStride])};
      mma_bf16(o[dt], a, b);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(Mma<D>::kWarps * kWarp)
    attn_prefill_mma(const Args a) {
  using T = __nv_bfloat16;
  using P = Mma<D>;
  constexpr int kS = P::kStride, kKeys = P::kKeys, kNt = kKeys / 8;
  static_assert(D % 16 == 0, "k-steps of 16");

  extern __shared__ float4 smem4[];
  T* qs = reinterpret_cast<T*>(smem4);  // [kRows][kS]
  T* kv = qs + P::kRows * kS;           // [stage][K, V][kKeys][kS]

  const int b = blockIdx.z, kvh = blockIdx.y;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int g = lane >> 2, t = lane & 3;
  const int n_rows = a.s_len * a.group;
  const int row0 = blockIdx.x * P::kRows;
  const int last = min(row0 + P::kRows, n_rows) - 1;

  // The block's live keys: from the window's edge of its first row to the
  // causal frontier of its last row.
  const int pos_lo = row0 / a.group + a.kv_offset;
  const int pos_hi = last / a.group + a.kv_offset;
  const int k_end = a.causal ? min(a.t_len, pos_hi + 1) : a.t_len;
  const int k_begin = a.window > 0 ? max(0, pos_lo - a.window + 1) : 0;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kKeys - 1) / kKeys
                                      : 0;

  // the block's query rows, zero-filled past n_rows
  const T* qg = static_cast<const T*>(a.q) + b * a.q_b;
  constexpr int kE = 16 / sizeof(T), kU = D / kE;
  for (int e = threadIdx.x; e < P::kRows * kU; e += blockDim.x) {
    const int r = e / kU, c = (e % kU) * kE, row = row0 + r;
    const bool live = row < n_rows;
    const T* src = qg + c;
    if (live)
      src += (kvh * a.group + row % a.group) * a.q_h +
             static_cast<long long>(row / a.group) * a.q_s;
    cp_async16(qs + r * kS + c, src, live);
  }
  const T* kg = static_cast<const T*>(a.k) + b * a.k_b + kvh * a.k_h;
  const T* vg = static_cast<const T*>(a.v) + b * a.v_b + kvh * a.v_h;
  auto stage = [&](int it) {
    const int k0 = k_begin + it * kKeys, nk = min(kKeys, k_end - k0);
    T* ks = kv + (2 * (it & 1)) * kKeys * kS;
    stage_rows<D, kKeys, kS>(ks, kg + static_cast<long long>(k0) * a.k_t,
                             a.k_t, nk);
    stage_rows<D, kKeys, kS>(ks + kKeys * kS,
                             vg + static_cast<long long>(k0) * a.v_t, a.v_t,
                             nk);
  };
  if (n_tiles > 0) stage(0);
  cp_async_commit();  // q and the first tile

  // this thread's rows g and g + 8 of the warp's 16
  const int wrow = row0 + warp * 16;
  const bool warp_live = wrow < n_rows;
  const int wpos_lo = wrow / a.group + a.kv_offset;
  const int wpos_hi = min(wrow + 15, n_rows - 1) / a.group + a.kv_offset;
  int pos[2];
  bool valid[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = wrow + g + 8 * h;
    valid[h] = row < n_rows;
    pos[h] = row / a.group + a.kv_offset;
  }
  float o[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[dt][i] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  const T* qw = qs + warp * 16 * kS;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) stage(it + 1);  // its stage was freed last round
    cp_async_commit();
    cp_async_wait<1>();  // every group but the newest: tile it has landed
    __syncthreads();
    const int k0 = k_begin + it * kKeys;
    const bool dead = !warp_live || (a.causal && k0 > wpos_hi) ||
                      (a.window > 0 && k0 + kKeys - 1 <= wpos_lo - a.window);
    if (!dead) {
      const T* ks = kv + (2 * (it & 1)) * kKeys * kS;
      float s[kNt][4];
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
      scores<D, kNt, kS>(s, qw, ks, g, t);

      // mask and scale; the tile's max of each row over the quad
      float tm[2] = {kNeg, kNeg};
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int h = i >> 1;
          const int key = k0 + nt * 8 + 2 * t + (i & 1);
          const bool live = valid[h] && key < a.t_len &&
                            (!a.causal || key <= pos[h]) &&
                            (a.window <= 0 || pos[h] - key < a.window);
          s[nt][i] = live ? s[nt][i] * a.scale : kNeg;
          tm[h] = fmaxf(tm[h], s[nt][i]);
        }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        tm[h] = fmaxf(tm[h], __shfl_xor_sync(0xffffffffu, tm[h], 1));
        tm[h] = fmaxf(tm[h], __shfl_xor_sync(0xffffffffu, tm[h], 2));
        const float mn = fmaxf(m[h], tm[h]);
        alpha[h] = expf(m[h] - mn);
        m[h] = mn;
        l[h] *= alpha[h];
      }
      // probabilities in place of the scores
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int h = i >> 1;
          s[nt][i] = s[nt][i] == kNeg ? 0.f : expf(s[nt][i] - m[h]);
          l[h] += s[nt][i];
        }
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        o[dt][0] *= alpha[0];
        o[dt][1] *= alpha[0];
        o[dt][2] *= alpha[1];
        o[dt][3] *= alpha[1];
      }
      accumulate<D, kNt, kS>(o, s, ks + kKeys * kS, g, t);
    }
    __syncthreads();  // the stage is refilled two rounds on
  }
  cp_async_wait<0>();
  if (!warp_live) return;

  T* og = static_cast<T*>(a.o) + b * a.o_b;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sum = l[h];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float denom = fmaxf(sum, 1e-30f);
    if (!valid[h]) continue;
    const int row = wrow + g + 8 * h;
    const int head = kvh * a.group + row % a.group;
    if (a.lse != nullptr && t == 0)
      a.lse[(static_cast<long long>(b) * a.hq + head) * a.s_len +
            row / a.group] = row_lse(m[h], sum);
    T* orow = og + head * a.o_h +
              static_cast<long long>(row / a.group) * a.o_s;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      store2(orow + dt * 8 + 2 * t, o[dt][2 * h] / denom,
             o[dt][2 * h + 1] / denom);
  }
}

// ----------------------------------------------------------------- decode

// Lanes per key (a key's D columns split across them), keys per warp and
// per tile, query heads per block, and the padded shared-memory row: one
// 16-byte unit per lane of a key past D, so the lanes of a quarter warp
// read distinct banks.
template <int D, typename T>
struct Decode {
  static constexpr int kLpk = D <= 64 ? 1 : (D == 128 ? 2 : 4);
  static constexpr int kWarps = 2;
  static constexpr int kKpw = kWarp / kLpk;
  static constexpr int kKeys = kWarps * kKpw;
  static constexpr int kRows = 4;
  static constexpr int kE = 16 / sizeof(T);  // elements per 16 bytes
  static constexpr int kStride = D + kLpk * kE;
  static constexpr int kStages = 2;
  static constexpr int kNi = (D + kWarp - 1) / kWarp;  // output dims a lane
  static constexpr size_t kKvBytes =
      sizeof(T) * static_cast<size_t>(2 * kStages * kKeys) * kStride;
  static constexpr size_t kSmem =
      kKvBytes + sizeof(float) * (kRows * D + kWarps * kRows * kKpw);
};

// One part per (split, warp): m, l and D accumulators, float32.
template <int D, typename T>
__global__ void __launch_bounds__(Decode<D, T>::kWarps * kWarp)
    attn_decode(const Args a) {
  using C = Decode<D, T>;
  constexpr int kS = C::kStride, kKeys = C::kKeys, kRows = C::kRows;
  constexpr int kE = C::kE, kLpk = C::kLpk, kKpw = C::kKpw, kNi = C::kNi;

  extern __shared__ float4 smem4[];
  T* kv = reinterpret_cast<T*>(smem4);  // [stage][K, V][kKeys][kS]
  float* qs = reinterpret_cast<float*>(reinterpret_cast<char*>(smem4) +
                                       C::kKvBytes);  // [kRows][D]
  float* ps = qs + kRows * D;                          // [warp][kRows][kKpw]

  const int row_tiles = (a.group + kRows - 1) / kRows;
  const int split = blockIdx.x, b = blockIdx.z;
  const int kvh = blockIdx.y / row_tiles;
  const int r0 = (blockIdx.y % row_tiles) * kRows;  // first head of the group
  const int n_r = min(kRows, a.group - r0);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int slot = lane / kLpk, part = lane % kLpk;

  // this split's share of the live keys [lo, hi) of position kv_offset
  const int qpos = a.kv_offset;
  const int lo = a.window > 0 ? max(0, qpos - a.window + 1) : 0;
  const int hi = a.causal ? min(a.t_len, qpos + 1) : a.t_len;
  const int s0 = max(lo, a.split_start + split * a.split_len);
  const int s1 = min(hi, a.split_start + (split + 1) * a.split_len);
  const int n_tiles = s1 > s0 ? (s1 - s0 + kKeys - 1) / kKeys : 0;

  const T* kg = static_cast<const T*>(a.k) + b * a.k_b + kvh * a.k_h;
  const T* vg = static_cast<const T*>(a.v) + b * a.v_b + kvh * a.v_h;
  auto stage = [&](int it) {
    const int k0 = s0 + it * kKeys, nk = min(kKeys, s1 - k0);
    T* ks = kv + (2 * (it & 1)) * kKeys * kS;
    stage_rows<D, kKeys, kS>(ks, kg + static_cast<long long>(k0) * a.k_t,
                             a.k_t, nk);
    stage_rows<D, kKeys, kS>(ks + kKeys * kS,
                             vg + static_cast<long long>(k0) * a.v_t, a.v_t,
                             nk);
  };
  if (n_tiles > 0) stage(0);
  cp_async_commit();

  // the block's query rows as float32 (zeros past the group)
  const T* qg = static_cast<const T*>(a.q) + b * a.q_b;
  for (int e = threadIdx.x; e < kRows * D; e += blockDim.x) {
    const int r = e / D, c = e % D;
    qs[e] = r < n_r ? to_float(qg[(kvh * a.group + r0 + r) * a.q_h + c])
                    : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][kNi];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;  // this lane's share of the row's sum
#pragma unroll
    for (int i = 0; i < kNi; ++i) acc[r][i] = 0.f;
  }
  float* wp = ps + warp * kRows * kKpw;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) stage(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile it and (the first time) q are in place
    const int k0 = s0 + it * kKeys;
    const int j = warp * kKpw + slot;  // this lane's key in the tile
    const int nk = min(kKeys, s1 - k0);
    const T* ks = kv + (2 * (it & 1)) * kKeys * kS;
    const T* vs = ks + kKeys * kS;

    // partial scores over this lane's units of its key, then the key's sum
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    const T* kr = ks + j * kS;
#pragma unroll 2
    for (int u = part; u < D / kE; u += kLpk) {
      float x[kE];
      load_unit(kr + u * kE, x);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float* qr = qs + r * D + u * kE;
#pragma unroll
        for (int e = 0; e < kE; ++e) s[r] = fmaf(qr[e], x[e], s[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int o = 1; o < kLpk; o <<= 1)
        s[r] += __shfl_xor_sync(0xffffffffu, s[r], o);
      const bool live = j < nk && r < n_r;
      const float sc = live ? s[r] * a.scale : kNeg;
      const float mn = fmaxf(m[r], warp_max(sc));
      const float p = live ? expf(sc - mn) : 0.f;
      const float alpha = expf(m[r] - mn);
      l[r] = l[r] * alpha + (part == 0 ? p : 0.f);
#pragma unroll
      for (int i = 0; i < kNi; ++i) acc[r][i] *= alpha;
      m[r] = mn;
      if (part == 0) wp[r * kKpw + slot] = p;
    }
    __syncwarp();
    // acc[r][dims of this lane] += sum_j p[r][j] * v[j][dims]
    const int n_j = min(kKpw, nk - warp * kKpw);
    for (int jj = 0; jj < n_j; ++jj) {
      const T* vr = vs + (warp * kKpw + jj) * kS;
      float vv[kNi];
#pragma unroll
      for (int i = 0; i < kNi; ++i) {
        const int d = lane + kWarp * i;
        vv[i] = d < D ? to_float(vr[d]) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pr = wp[r * kKpw + jj];
#pragma unroll
        for (int i = 0; i < kNi; ++i) acc[r][i] = fmaf(pr, vv[i], acc[r][i]);
      }
    }
    __syncwarp();  // wp is rewritten next round
    __syncthreads();  // the stage is refilled two rounds on
  }
  cp_async_wait<0>();

  // this warp's part of each of its rows: (m, l, acc), m = -inf if empty
  const int n_parts = a.n_splits * C::kWarps;
  const int part_id = split * C::kWarps + warp;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float sum = warp_sum(l[r]);
    if (r >= n_r) continue;
    const long long row =
        static_cast<long long>(b) * a.hq + kvh * a.group + r0 + r;
    float* e = a.part + (row * n_parts + part_id) * (D + 2);
    if (lane == 0) {
      e[0] = sum > 0.f ? m[r] : -__int_as_float(0x7f800000);
      e[1] = sum;
    }
#pragma unroll
    for (int i = 0; i < kNi; ++i) {
      const int d = lane + kWarp * i;
      if (d < D) e[2 + d] = acc[r][i];
    }
  }
}

// Merge each row's parts in order: one warp per (batch, query head).
template <int D, typename T>
__global__ void __launch_bounds__(4 * kWarp)
    attn_combine(const Args a, int n_rows, int n_parts) {
  constexpr int kNi = (D + kWarp - 1) / kWarp;
  const int row = blockIdx.x * 4 + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= n_rows) return;
  const float* e = a.part + static_cast<long long>(row) * n_parts * (D + 2);
  const float neg_inf = -__int_as_float(0x7f800000);
  float mx = neg_inf;
  for (int p = 0; p < n_parts; ++p) mx = fmaxf(mx, e[p * (D + 2)]);
  float sum = 0.f, o[kNi];
#pragma unroll
  for (int i = 0; i < kNi; ++i) o[i] = 0.f;
  if (mx != neg_inf) {
    for (int p = 0; p < n_parts; ++p) {
      const float* ep = e + p * (D + 2);
      const float w = expf(ep[0] - mx);  // 0 for an empty part
      sum += ep[1] * w;
#pragma unroll
      for (int i = 0; i < kNi; ++i) {
        const int d = lane + kWarp * i;
        if (d < D) o[i] = fmaf(ep[2 + d], w, o[i]);
      }
    }
  }
  const float denom = fmaxf(sum, 1e-30f);
  const int b = row / a.hq, h = row % a.hq;
  T* orow = static_cast<T*>(a.o) + b * a.o_b + h * a.o_h;
#pragma unroll
  for (int i = 0; i < kNi; ++i) {
    const int d = lane + kWarp * i;
    if (d < D) store(orow + d, o[i] / denom);
  }
}

// ---------------------------------------------------------------- launch

// The shared-memory limit of a kernel, set once per instance.
template <typename K>
cudaError_t allow_smem(K* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int D, typename T>
int launch(const Args& a, int batch, int hkv, cudaStream_t st) {
  if (a.s_len == 1 && a.lse == nullptr) {
    using C = Decode<D, T>;
    static const cudaError_t attr = allow_smem(attn_decode<D, T>, C::kSmem);
    if (attr != cudaSuccess) return attr;
    if (a.n_splits <= 0 || a.part == nullptr) return cudaErrorInvalidValue;
    const int row_tiles = (a.group + C::kRows - 1) / C::kRows;
    const dim3 grid(a.n_splits, hkv * row_tiles, batch);
    attn_decode<D, T><<<grid, C::kWarps * kWarp, C::kSmem, st>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int n_rows = batch * a.hq;
    attn_combine<D, T><<<(n_rows + 3) / 4, 4 * kWarp, 0, st>>>(
        a, n_rows, a.n_splits * C::kWarps);
    return cudaGetLastError();
  }
  const int n_rows = a.s_len * a.group;
  if constexpr (std::is_same_v<T, float> && D <= 64) {
    using P = Tiled<D>;
    static const cudaError_t attr = allow_smem(attn_prefill_tiled<D>,
                                               P::kSmem);
    if (attr != cudaSuccess) return attr;
    const dim3 grid((n_rows + P::kRows - 1) / P::kRows, hkv, batch);
    attn_prefill_tiled<D><<<grid, P::kWarps * kWarp, P::kSmem, st>>>(a);
  } else if constexpr (std::is_same_v<T, float>) {
    constexpr int kRows = kFmaWarps * Fma<D>::kRpw;
    static const cudaError_t attr = allow_smem(attn_prefill_fma<D>,
                                               fma_smem<D>());
    if (attr != cudaSuccess) return attr;
    const dim3 grid((n_rows + kRows - 1) / kRows, hkv, batch);
    attn_prefill_fma<D><<<grid, kFmaWarps * kWarp, fma_smem<D>(), st>>>(a);
  } else {
    using P = Mma<D>;
    static const cudaError_t attr = allow_smem(attn_prefill_mma<D>, P::kSmem);
    if (attr != cudaSuccess) return attr;
    const dim3 grid((n_rows + P::kRows - 1) / P::kRows, hkv, batch);
    attn_prefill_mma<D><<<grid, P::kWarps * kWarp, P::kSmem, st>>>(a);
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

// Launch K5: q [B, Hq, S, D], k and v [B, Hkv, T, D], o [B, Hq, S, D],
// each given by its base pointer and its batch, head and sequence strides
// in elements (the head dimension contiguous, every pointer and stride
// aligned to 16 bytes).  is_bf16 selects bfloat16 for all four;
// otherwise float32.  window <= 0 means no window.  A decode step (S = 1)
// also takes its splits of the live keys (split_start, split_len,
// n_splits) and float32 scratch part [B * Hq][n_splits * 2][D + 2]; the
// prefill ignores them.  Given a non-null lse, float32 [B, Hq, S]
// contiguous, the launch is a prefill whatever S is and writes each
// row's log-sum-exp there.  Returns a cudaError_t (0 = launched).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, long long q_b, long long q_h,
                           long long q_s, long long k_b, long long k_h,
                           long long k_t, long long v_b, long long v_h,
                           long long v_t, long long o_b, long long o_h,
                           long long o_s, int batch, int hq, int hkv,
                           int s_len, int t_len, int d, int is_bf16,
                           int causal, int window, int kv_offset,
                           float scale, int split_start, int split_len,
                           int n_splits, void* part, void* lse,
                           void* stream) {
  if (batch <= 0 || s_len <= 0 || hkv <= 0 || hq % hkv != 0) return 0;
  const Args a{q,     k,          v,         o,     q_b,      q_h,
               q_s,   k_b,        k_h,       k_t,   v_b,      v_h,
               v_t,   o_b,        o_h,       o_s,   s_len,    t_len,
               hq / hkv, hq,      causal,    window, kv_offset, scale,
               split_start, split_len, n_splits, static_cast<float*>(part),
               static_cast<float*>(lse)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<__nv_bfloat16>(a, d, batch, hkv, st)
                 : dispatch<float>(a, d, batch, hkv, st);
}

}  // extern "C"
