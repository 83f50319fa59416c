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
// carry over.  Here:
//
//   * one block of 128 threads per (batch, kv head, tile of query rows).
//     A "row" is one (query position, query head) pair of the kv head's
//     group, so the Hq/Hkv heads that share a kv head share the block and
//     every K/V tile staged in shared memory serves all of them.  A decode
//     step (S = 1) gives a block Hq/Hkv rows instead of one, one per warp,
//     over longer tiles;
//   * the block loops over K/V tiles of kKeys keys from the window's edge
//     to the causal frontier of its last row: tiles past the frontier
//     (the zero tail of a prefill cache, the unwritten end of a decode
//     cache) and before the window are never read;
//   * each warp owns kRowsPerWarp rows; per 32-key slice, lane j scores
//     key j against all of the warp's rows (float32 FMA, K rows padded by
//     four floats so the float4 reads are free of bank conflicts), the
//     warp's max updates each row's running max, and the probabilities
//     go through shared memory (float4 broadcast reads) into the
//     accumulators, lane j owning output dims j, j + 32, ...
//
// What bounds it on this card: a prefill at SmolLM-135M's width does
// 4 * D float32 operations per (row, live key) against a K/V tile that
// 32 rows (16 at D = 256) share, so it is bound by operations (CUDA-core
// FMA; tensor cores are for a later kernel).  A decode step reads every
// live key once for Hq/Hkv rows, so it is bound by bytes; with one block
// per (batch, kv head) and one tile in flight per block it reaches a
// small share of the card's bandwidth (a split over the keys is for a
// later kernel).
//
// Plain C interface (built with nvcc into a shared library, bound with
// ctypes).  The entry point launches on the given stream, allocates
// nothing, and returns cudaGetLastError() so a refused launch is never
// silent.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 4;                  // 128 threads per block
constexpr float kNeg = -1e30f;             // masked score (the TPU's NEG_INF)

// Rows per warp and keys per staged tile, per head width.  Shared memory
// is (rows + keys) * D floats plus padding: 46 KB at D = 64, 87 KB at
// D = 128 and 84 KB at D = 256.  A decode step (S = 1) has only Hq/Hkv
// rows: it runs one row per warp, so the rows' work is spread over the
// warps, and tiles of kDecodeKeys keys, so more bytes are in flight per
// tile (~137 KB at D = 64, 128 and 256).
template <int D> struct Tile;
template <> struct Tile<32> { static constexpr int kRowsPerWarp = 8, kKeys = 64, kDecodeKeys = 256; };
template <> struct Tile<48> { static constexpr int kRowsPerWarp = 8, kKeys = 64, kDecodeKeys = 256; };
template <> struct Tile<64> { static constexpr int kRowsPerWarp = 8, kKeys = 64, kDecodeKeys = 256; };
template <> struct Tile<128> { static constexpr int kRowsPerWarp = 8, kKeys = 64, kDecodeKeys = 128; };
template <> struct Tile<256> { static constexpr int kRowsPerWarp = 4, kKeys = 32, kDecodeKeys = 64; };

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_b, q_h, q_s;  // element strides of q's batch, head, position
  long long k_b, k_h, k_t;
  long long v_b, v_h, v_t;
  long long o_b, o_h, o_s;
  int s_len, t_len, group;  // group = Hq / Hkv
  int causal, window, kv_offset;  // window <= 0: none
  float scale;
};

template <int D, int kRpw, int kKeys>
constexpr int smem_floats() {
  constexpr int rows = kWarps * kRpw;
  return rows * D + kKeys * (D + 4) + kKeys * D + rows * kWarp;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Copy 16 bytes from global to shared memory asynchronously; when !pred
// the 16 bytes are zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
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

// Stage keys [k0, k0 + nk) of one kv head into ks (rows padded to D + 4)
// and vs, zero-filling the tile's rows past nk.  float32 goes by cp.async;
// bfloat16 is widened to float32 through registers.
template <int D, int kKeys>
__device__ __forceinline__ void stage_kv(const float* kg, const float* vg,
                                         const Args& a, int k0, int nk,
                                         float* ks, float* vs) {
  constexpr int kVec = D / 4;
  for (int e = threadIdx.x; e < kKeys * kVec; e += blockDim.x) {
    const int j = e / kVec, c = (e % kVec) * 4;
    const bool live = j < nk;
    const long long t = live ? k0 + j : 0;
    cp_async16(ks + j * (D + 4) + c, kg + t * a.k_t + c, live);
    cp_async16(vs + j * D + c, vg + t * a.v_t + c, live);
  }
  cp_async_wait_all();
}

template <int D, int kKeys>
__device__ __forceinline__ void stage_kv(const __nv_bfloat16* kg,
                                         const __nv_bfloat16* vg,
                                         const Args& a, int k0, int nk,
                                         float* ks, float* vs) {
  constexpr int kVec = D / 4;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int e = threadIdx.x; e < kKeys * kVec; e += blockDim.x) {
    const int j = e / kVec, c = (e % kVec) * 4;
    const bool live = j < nk;
    const long long t = k0 + j;
    *reinterpret_cast<float4*>(ks + j * (D + 4) + c) =
        live ? load4(kg + t * a.k_t + c) : zero;
    *reinterpret_cast<float4*>(vs + j * D + c) =
        live ? load4(vg + t * a.v_t + c) : zero;
  }
}

template <int D, int kRpw, int kKeys, typename T>
__global__ void __launch_bounds__(kWarps * kWarp)
    flash_attention_fwd(const Args a) {
  constexpr int kRows = kWarps * kRpw;
  constexpr int kKs = D + 4;                        // padded K row
  constexpr int kNi = (D + kWarp - 1) / kWarp;      // output dims per lane
  static_assert(D % 8 == 0 && kKeys % kWarp == 0, "tile shape");

  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);      // [kRows][D]
  float* ks = qs + kRows * D;                       // [kKeys][kKs]
  float* vs = ks + kKeys * kKs;                     // [kKeys][D]
  float* ps = vs + kKeys * D;                       // [kRows][32]

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

  // Stage the block's query rows as float32.
  const T* qg = static_cast<const T*>(a.q) + b * a.q_b;
  for (int e = threadIdx.x; e < kRows * (D / 4); e += blockDim.x) {
    const int r = e / (D / 4), c = (e % (D / 4)) * 4;
    const int row = row0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < n_rows) {
      const int h = kvh * a.group + row % a.group;
      x = load4(qg + h * a.q_h + (long long)(row / a.group) * a.q_s + c);
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

  const T* kg = static_cast<const T*>(a.k) + b * a.k_b + kvh * a.k_h;
  const T* vg = static_cast<const T*>(a.v) + b * a.v_b + kvh * a.v_h;

  for (int k0 = k_begin; k0 < k_end; k0 += kKeys) {
    const int nk = min(kKeys, k_end - k0);
    __syncthreads();  // the previous tile is consumed
    stage_kv<D, kKeys>(kg, vg, a, k0, nk, ks, vs);
    __syncthreads();
    if (!warp_live) continue;
    for (int j0 = 0; j0 < nk; j0 += kWarp) {
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
            for (int i = 0; i < kNi; ++i) acc[r][i] = fmaf(pc, vv[i], acc[r][i]);
          }
        }
      }
      __syncwarp();  // wp is rewritten by the next slice
    }
  }
  if (!warp_live) return;

  T* og = static_cast<T*>(a.o) + b * a.o_b;
#pragma unroll
  for (int r = 0; r < kRpw; ++r) {
    const float denom = fmaxf(warp_sum(l[r]), 1e-30f);
    if (!valid[r]) continue;
    const int row = row0 + warp * kRpw + r;
    const int h = kvh * a.group + row % a.group;
    T* orow = og + h * a.o_h + (long long)(row / a.group) * a.o_s;
#pragma unroll
    for (int i = 0; i < kNi; ++i) {
      const int d = lane + kWarp * i;
      if (d < D) store(orow + d, acc[r][i] / denom);
    }
  }
}

template <int D, int kRpw, int kKeys, typename T>
int launch_tiles(const Args& a, int batch, int hkv, cudaStream_t st) {
  constexpr int kRows = kWarps * kRpw;
  const size_t smem = sizeof(float) * smem_floats<D, kRpw, kKeys>();
  auto* kernel = flash_attention_fwd<D, kRpw, kKeys, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int n_rows = a.s_len * a.group;
  const dim3 grid((n_rows + kRows - 1) / kRows, hkv, batch);
  kernel<<<grid, kWarps * kWarp, smem, st>>>(a);
  return cudaGetLastError();
}

template <int D, typename T>
int launch(const Args& a, int batch, int hkv, cudaStream_t st) {
  if (a.s_len == 1)
    return launch_tiles<D, 1, Tile<D>::kDecodeKeys, T>(a, batch, hkv, st);
  return launch_tiles<D, Tile<D>::kRowsPerWarp, Tile<D>::kKeys, T>(
      a, batch, hkv, st);
}

template <typename T>
int dispatch(const Args& a, int d, int batch, int hkv, cudaStream_t st) {
  switch (d) {
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
// aligned to four elements).  is_bf16 selects bfloat16 for all four;
// otherwise float32.  window <= 0 means no window.  Returns a cudaError_t
// (0 = launched).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, long long q_b, long long q_h,
                           long long q_s, long long k_b, long long k_h,
                           long long k_t, long long v_b, long long v_h,
                           long long v_t, long long o_b, long long o_h,
                           long long o_s, int batch, int hq, int hkv,
                           int s_len, int t_len, int d, int is_bf16,
                           int causal, int window, int kv_offset,
                           float scale, void* stream) {
  if (batch <= 0 || s_len <= 0 || hkv <= 0 || hq % hkv != 0) return 0;
  const Args a{q,   k,   v,   o,   q_b,   q_h,   q_s,      k_b,
               k_h, k_t, v_b, v_h, v_t,   o_b,   o_h,      o_s,
               s_len, t_len, hq / hkv, causal, window, kv_offset, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<__nv_bfloat16>(a, d, batch, hkv, st)
                 : dispatch<float>(a, d, batch, hkv, st);
}

}  // extern "C"
