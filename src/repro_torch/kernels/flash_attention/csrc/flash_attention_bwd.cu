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
//   2. attn_bwd_dkdv: a block per (key tile, kv head, batch).  It stages
//      its K and V tile once, then walks the group's query heads and,
//      for each, the query tiles that see its keys (the causal frontier
//      and the window bound the walk).  Per query tile it stages Q, dO,
//      lse and D, forms S and dP = dO V^T as register tiles (a thread a
//      4 x 4 sub-tile of rows ti + 16 a, keys tj + 16 b), writes P and dS
//      to shared memory, and adds P^T dO and dS^T Q into its dV and dK
//      accumulators (a thread a 4-key x 4-dim sub-tile, in registers);
//   3. attn_bwd_dq: a block per (query tile, query head, batch), the
//      heaviest (last) query tiles first.  It stages Q and dO once, walks
//      the key tiles its rows see, recomputes P and dS and adds dS K.
//
// Bound: by operations.  The work is five S x T x D products over the
// live (row, key) pairs (the S and dP recomputed in pass 3 make seven),
// float32 FMA on the CUDA cores (67 TFLOP/s); the bytes (q, k, v, o, dO
// read, dq, dk, dv written, once each) are far below that at the
// training shapes.  Every operand is staged as float32 in shared memory
// (bfloat16 converted on load) with rows padded by 4 floats, so the
// float4 reads of 16 rows by a warp are free of bank conflicts; the
// register tiles read two float4 per 16 FMAs.  Left for later: the
// tensor cores (mma / wgmma), TMA staging and a dQ fused into pass 2.
//
// Plain C interface (built with nvcc into a shared library, bound with
// ctypes).  The entry point launches on the given stream, allocates
// nothing, sets each kernel's shared-memory limit once, and returns
// cudaGetLastError() so a refused launch is never silent.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;

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

// Tiles by head width: query rows and keys a tile, and the padded
// shared-memory row of an operand (one position, D floats).
template <int D>
struct Bwd {
  static_assert(D % 16 == 0 || D == 48, "head widths of HEAD_DIMS");
  static constexpr int kBq = D == 256 ? 32 : 64;
  static constexpr int kBk = D == 256 ? 32 : 64;
  static constexpr int kLd = D + 4;
  static constexpr int kA = kBq / 16;  // score rows a thread
  static constexpr int kB = kBk / 16;  // score keys a thread
  // 4 x 4 sub-tiles of a [kBk or kBq][D] accumulator, and a thread's share
  static constexpr int kSubK = (kBk / 4) * (D / 4);
  static constexpr int kSubQ = (kBq / 4) * (D / 4);
  static constexpr int kSptK = (kSubK + kThreads - 1) / kThreads;
  static constexpr int kSptQ = (kSubQ + kThreads - 1) / kThreads;
  // shared memory: K, V, Q, dO tiles, the P / dS tiles, lse and D
  static constexpr size_t kSmemDkdv =
      sizeof(float) * (static_cast<size_t>(2 * kBk + 2 * kBq) * kLd +
                       2 * kBq * (kBk + 4) + 2 * kBq);
  static constexpr size_t kSmemDq =
      sizeof(float) * (static_cast<size_t>(2 * kBk + 2 * kBq) * kLd +
                       kBk * (kBq + 4) + 2 * kBq);
};

// ------------------------------------------------------------- helpers

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 x =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 y =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(x.x, x.y, y.x, y.y);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&lo);
  u.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
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

// Stage rows [0, kRows) of a [rows][D] operand (row r at g + r * stride)
// into shared rows of kLd floats as float32; rows from n_live on are
// zero-filled and never read from memory.
template <int D, int kRows, typename T>
__device__ __forceinline__ void load_tile(float* sm, const T* g,
                                          long long stride, int n_live) {
  constexpr int kQ = D / 4;
  for (int e = threadIdx.x; e < kRows * kQ; e += kThreads) {
    const int r = e / kQ, c = (e % kQ) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n_live) x = load4(g + r * stride + c);
    *reinterpret_cast<float4*>(sm + r * Bwd<D>::kLd + c) = x;
  }
}

// S = Q K^T and dP = dO V^T of a thread's score sub-tile: rows ti + 16 a,
// keys tj + 16 b, from the staged tiles
template <int D>
__device__ __forceinline__ void scores(float (&s)[Bwd<D>::kA][Bwd<D>::kB],
                                       float (&dp)[Bwd<D>::kA][Bwd<D>::kB],
                                       const float* qs, const float* dos,
                                       const float* ks, const float* vs,
                                       int ti, int tj) {
  using C = Bwd<D>;
  constexpr int kA = C::kA, kB = C::kB, kLd = C::kLd;
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
      const float4 kb = load4(ks + (tj + 16 * y) * kLd + c);
      const float4 vb = load4(vs + (tj + 16 * y) * kLd + c);
#pragma unroll
      for (int x = 0; x < kA; ++x) {
        s[x][y] = dot4(qa[x], kb, s[x][y]);
        dp[x][y] = dot4(da[x], vb, dp[x][y]);
      }
    }
  }
}

__device__ __forceinline__ bool live(int qi, int kj, int nq, int nk, int i,
                                     int j, const Args& a) {
  return i < nq && j < nk && (!a.causal || kj <= qi) &&
         (a.window <= 0 || qi - kj < a.window);
}

// ---------------------------------------------------------------- pass 1

// D of each row (b, h, i): a warp a row, float4 columns per lane
template <int D, typename T>
__global__ void __launch_bounds__(kThreads) attn_bwd_delta(const Args a,
                                                           long long n_rows) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (kThreads / kWarp) +
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

// ---------------------------------------------------------------- pass 2

template <int D, typename T>
__global__ void __launch_bounds__(kThreads) attn_bwd_dkdv(const Args a) {
  using C = Bwd<D>;
  constexpr int kBq = C::kBq, kBk = C::kBk, kLd = C::kLd;
  constexpr int kA = C::kA, kB = C::kB, kPl = kBk + 4;
  constexpr int kSub = C::kSubK, kSpt = C::kSptK, kDq = D / 4;

  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [kBk][kLd]
  float* vs = ks + kBk * kLd;                   // [kBk][kLd]
  float* qs = vs + kBk * kLd;                   // [kBq][kLd]
  float* dos = qs + kBq * kLd;                  // [kBq][kLd]
  float* ps = dos + kBq * kLd;                  // [kBq][kPl]: P
  float* dss = ps + kBq * kPl;                  // [kBq][kPl]: dS
  float* ls = dss + kBq * kPl;                  // [kBq]: lse
  float* dl = ls + kBq;                         // [kBq]: D

  const int tid = threadIdx.x, ti = tid / 16, tj = tid % 16;
  const int b = blockIdx.z, g = blockIdx.y, n = a.s_len;
  const int k0 = blockIdx.x * kBk, nk = min(kBk, n - k0);

  load_tile<D, kBk>(ks,
                    static_cast<const T*>(a.k) + b * a.k_b + g * a.k_h +
                        static_cast<long long>(k0) * a.k_t,
                    a.k_t, nk);
  load_tile<D, kBk>(vs,
                    static_cast<const T*>(a.v) + b * a.v_b + g * a.v_h +
                        static_cast<long long>(k0) * a.v_t,
                    a.v_t, nk);

  // the query rows that see a key of this tile: [q_lo, q_hi)
  const int q_lo = a.causal ? k0 : 0;
  const int q_hi = a.window > 0 ? min(n, k0 + nk - 1 + a.window) : n;
  const int t_lo = q_lo / kBq, t_hi = (q_hi + kBq - 1) / kBq;

  float dk[kSpt][4][4], dv[kSpt][4][4];
#pragma unroll
  for (int u = 0; u < kSpt; ++u)
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) dk[u][x][y] = dv[u][x][y] = 0.f;

  for (int r = 0; r < a.group; ++r) {
    const int h = g * a.group + r;
    const T* qg = static_cast<const T*>(a.q) + b * a.q_b + h * a.q_h;
    const T* dg = static_cast<const T*>(a.dout) + b * a.do_b + h * a.do_h;
    const long long row0 = (static_cast<long long>(b) * a.hq + h) * n;
    for (int it = t_lo; it < t_hi; ++it) {
      const int q0 = it * kBq, nq = min(kBq, n - q0);
      __syncthreads();  // the last tile's P, dS, Q and dO are consumed
      load_tile<D, kBq>(qs, qg + static_cast<long long>(q0) * a.q_s, a.q_s,
                        nq);
      load_tile<D, kBq>(dos, dg + static_cast<long long>(q0) * a.do_s,
                        a.do_s, nq);
      for (int i = tid; i < kBq; i += kThreads) {
        ls[i] = i < nq ? a.lse[row0 + q0 + i] : 0.f;
        dl[i] = i < nq ? a.delta[row0 + q0 + i] : 0.f;
      }
      __syncthreads();
      float s[kA][kB], dp[kA][kB];
      scores<D>(s, dp, qs, dos, ks, vs, ti, tj);
#pragma unroll
      for (int x = 0; x < kA; ++x) {
        const int i = ti + 16 * x;
#pragma unroll
        for (int y = 0; y < kB; ++y) {
          const int j = tj + 16 * y;
          const float p = live(q0 + i, k0 + j, nq, nk, i, j, a)
                              ? expf(s[x][y] * a.scale - ls[i])
                              : 0.f;
          ps[i * kPl + j] = p;
          dss[i * kPl + j] = p * (dp[x][y] - dl[i]);
        }
      }
      __syncthreads();
      // dV += P^T dO and dK += dS^T Q over the tile's rows
#pragma unroll
      for (int u = 0; u < kSpt; ++u) {
        const int st = tid + u * kThreads;
        if (st >= kSub) continue;
        const int j4 = (st / kDq) * 4, d4 = (st % kDq) * 4;
#pragma unroll 4
        for (int i = 0; i < nq; ++i) {
          const float4 p4 = load4(ps + i * kPl + j4);
          const float4 s4 = load4(dss + i * kPl + j4);
          const float4 o4 = load4(dos + i * kLd + d4);
          const float4 q4 = load4(qs + i * kLd + d4);
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
  }

  T* dkg = static_cast<T*>(a.dk) + b * a.dk_b + g * a.dk_h;
  T* dvg = static_cast<T*>(a.dv) + b * a.dv_b + g * a.dv_h;
#pragma unroll
  for (int u = 0; u < kSpt; ++u) {
    const int st = tid + u * kThreads;
    if (st >= kSub) continue;
    const int j4 = (st / kDq) * 4, d4 = (st % kDq) * 4;
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int t = k0 + j4 + x;
      if (j4 + x >= nk) continue;
      store4(dkg + static_cast<long long>(t) * a.dk_t + d4,
             make_float4(dk[u][x][0] * a.scale, dk[u][x][1] * a.scale,
                         dk[u][x][2] * a.scale, dk[u][x][3] * a.scale));
      store4(dvg + static_cast<long long>(t) * a.dv_t + d4,
             make_float4(dv[u][x][0], dv[u][x][1], dv[u][x][2],
                         dv[u][x][3]));
    }
  }
}

// ---------------------------------------------------------------- pass 3

template <int D, typename T>
__global__ void __launch_bounds__(kThreads) attn_bwd_dq(const Args a) {
  using C = Bwd<D>;
  constexpr int kBq = C::kBq, kBk = C::kBk, kLd = C::kLd;
  constexpr int kA = C::kA, kB = C::kB, kTl = kBq + 4;
  constexpr int kSub = C::kSubQ, kSpt = C::kSptQ, kDq = D / 4;

  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kBq][kLd]
  float* dos = qs + kBq * kLd;                  // [kBq][kLd]
  float* ks = dos + kBq * kLd;                  // [kBk][kLd]
  float* vs = ks + kBk * kLd;                   // [kBk][kLd]
  float* dst = vs + kBk * kLd;                  // [kBk][kTl]: dS^T
  float* ls = dst + kBk * kTl;                  // [kBq]: lse
  float* dl = ls + kBq;                         // [kBq]: D

  const int tid = threadIdx.x, ti = tid / 16, tj = tid % 16;
  const int b = blockIdx.z, h = blockIdx.y, n = a.s_len;
  const int g = h / a.group;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBq, nq = min(kBq, n - q0);
  const long long row0 = (static_cast<long long>(b) * a.hq + h) * n;

  load_tile<D, kBq>(qs,
                    static_cast<const T*>(a.q) + b * a.q_b + h * a.q_h +
                        static_cast<long long>(q0) * a.q_s,
                    a.q_s, nq);
  load_tile<D, kBq>(dos,
                    static_cast<const T*>(a.dout) + b * a.do_b +
                        h * a.do_h + static_cast<long long>(q0) * a.do_s,
                    a.do_s, nq);
  for (int i = tid; i < kBq; i += kThreads) {
    ls[i] = i < nq ? a.lse[row0 + q0 + i] : 0.f;
    dl[i] = i < nq ? a.delta[row0 + q0 + i] : 0.f;
  }

  // the keys that some row of this tile sees: [k_lo, k_hi)
  const int k_lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int k_hi = a.causal ? min(n, q0 + nq) : n;
  const int t_lo = k_lo / kBk, t_hi = (k_hi + kBk - 1) / kBk;
  const T* kg = static_cast<const T*>(a.k) + b * a.k_b + g * a.k_h;
  const T* vg = static_cast<const T*>(a.v) + b * a.v_b + g * a.v_h;

  float acc[kSpt][4][4];
#pragma unroll
  for (int u = 0; u < kSpt; ++u)
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) acc[u][x][y] = 0.f;

  for (int it = t_lo; it < t_hi; ++it) {
    const int k0 = it * kBk, nk = min(kBk, n - k0);
    __syncthreads();  // the last tile's K and dS^T are consumed
    load_tile<D, kBk>(ks, kg + static_cast<long long>(k0) * a.k_t, a.k_t,
                      nk);
    load_tile<D, kBk>(vs, vg + static_cast<long long>(k0) * a.v_t, a.v_t,
                      nk);
    __syncthreads();
    float s[kA][kB], dp[kA][kB];
    scores<D>(s, dp, qs, dos, ks, vs, ti, tj);
#pragma unroll
    for (int x = 0; x < kA; ++x) {
      const int i = ti + 16 * x;
#pragma unroll
      for (int y = 0; y < kB; ++y) {
        const int j = tj + 16 * y;
        float ds = 0.f;
        if (live(q0 + i, k0 + j, nq, nk, i, j, a))
          ds = expf(s[x][y] * a.scale - ls[i]) * (dp[x][y] - dl[i]);
        dst[j * kTl + i] = ds;
      }
    }
    __syncthreads();
    // dQ += dS K over the tile's keys
#pragma unroll
    for (int u = 0; u < kSpt; ++u) {
      const int st = tid + u * kThreads;
      if (st >= kSub) continue;
      const int i4 = (st / kDq) * 4, d4 = (st % kDq) * 4;
#pragma unroll 4
      for (int j = 0; j < nk; ++j) {
        const float4 s4 = load4(dst + j * kTl + i4);
        const float4 k4 = load4(ks + j * kLd + d4);
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int y = 0; y < 4; ++y)
            acc[u][x][y] = fmaf(elem(s4, x), elem(k4, y), acc[u][x][y]);
      }
    }
  }

  T* dqg = static_cast<T*>(a.dq) + b * a.dq_b + h * a.dq_h;
#pragma unroll
  for (int u = 0; u < kSpt; ++u) {
    const int st = tid + u * kThreads;
    if (st >= kSub) continue;
    const int i4 = (st / kDq) * 4, d4 = (st % kDq) * 4;
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      if (i4 + x >= nq) continue;
      store4(dqg + static_cast<long long>(q0 + i4 + x) * a.dq_s + d4,
             make_float4(acc[u][x][0] * a.scale, acc[u][x][1] * a.scale,
                         acc[u][x][2] * a.scale, acc[u][x][3] * a.scale));
    }
  }
}

// ---------------------------------------------------------------- launch

template <typename K>
cudaError_t allow_smem(K* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int D, typename T>
int launch(const Args& a, int batch, int hkv, cudaStream_t st) {
  using C = Bwd<D>;
  static const cudaError_t attr_kv =
      allow_smem(attn_bwd_dkdv<D, T>, C::kSmemDkdv);
  static const cudaError_t attr_q = allow_smem(attn_bwd_dq<D, T>, C::kSmemDq);
  if (attr_kv != cudaSuccess) return attr_kv;
  if (attr_q != cudaSuccess) return attr_q;
  const long long n_rows = static_cast<long long>(batch) * a.hq * a.s_len;
  const long long rows_per_block = kThreads / kWarp;
  attn_bwd_delta<D, T><<<static_cast<unsigned>(
                             (n_rows + rows_per_block - 1) / rows_per_block),
                         kThreads, 0, st>>>(a, n_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_kv((a.s_len + C::kBk - 1) / C::kBk, hkv, batch);
  attn_bwd_dkdv<D, T><<<grid_kv, kThreads, C::kSmemDkdv, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_q((a.s_len + C::kBq - 1) / C::kBq, a.hq, batch);
  attn_bwd_dq<D, T><<<grid_q, kThreads, C::kSmemDq, st>>>(a);
  return cudaGetLastError();
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
  return is_bf16 ? dispatch<__nv_bfloat16>(a, d, batch, hkv, st)
                 : dispatch<float>(a, d, batch, hkv, st);
}

}  // extern "C"
