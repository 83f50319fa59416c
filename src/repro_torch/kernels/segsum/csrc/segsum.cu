// K4 for Hopper: segment sum as a deterministic reduction balanced by
// edges, not by segments.
//
// Replaces repro/kernels/segsum/segsum.py:segment_sum_pallas (its Pallas
// body _kernel and the host SegsumLayout that feeds it).  It computes
//
//   out[n, :] = sum of msgs[e, :] over the edges e with seg[e] == n
//
// in float32 for float32 or bfloat16 msgs [E, F]; ids outside [0, N)
// are dropped.  The wrapper (segsum.py) hands it the layout built on the
// card once per topology: perm, the valid edge ids stably sorted by
// segment (the dropped ones after them); sorted_seg, the segment of each
// position of perm (N for a dropped edge); offsets int32[N + 1], so that
// segment n owns perm[offsets[n] : offsets[n+1]]; and kind int8[N], which
// says for each segment whether it is empty, lies inside one chunk, or
// crosses a chunk boundary.
//
// The TPU form groups the edges into node blocks of 128, copies msgs into
// a padded grouped buffer and turns each 256-edge tile into a one-hot
// MXU matmul, because the TPU has no atomics.  None of that carries over.
// Here the sorted positions are cut into chunks of kChunk = 32 edges,
// which depend only on E, and the work is two launches:
//
//   1. segsum_chunks: one warp per chunk (and per tile of columns).  The
//      lanes load the chunk's 32 edge ids and segment ids with one
//      coalesced load each, then walk the chunk in sorted order, kBatch
//      rows loaded before they are added, the lanes covering the columns.
//      Each run of one segment inside the chunk is summed in float32
//      registers; a segment wholly inside the chunk is written straight
//      to out, and the piece of a segment that crosses the chunk's edge
//      (at most the chunk's first and last run) to float32 scratch
//      [n_chunks][2][F]: slot 0 for the run that starts the chunk, slot 1
//      for the last run.
//   2. segsum_fixup: one thread per (segment, column pair).  A crossing
//      segment adds its pieces in chunk order; an empty one writes zeros;
//      the rest were written by pass 1.
//
// So every warp gets 32 edges whatever the skew: the RMAT hub of ~10^3
// edges is ~36 warps' work and a fix-up of ~36 adds.  No atomics, and
// the order of every sum is fixed by E and the layout, so two launches on
// the same operands give the same bits.
//
// What bounds it on this card: memory.  It must read each valid edge's
// message row once, perm and offsets once, and write out once; one add
// per element read is far below any compute rate.  Message rows are read
// as float2 when the operand allows it (float32, unit column stride, an
// even F, even row stride, 8-byte aligned base: GatedGCN's 70 columns are
// 280 bytes, not a multiple of 16), else with scalar loads through both
// strides (bfloat16, strided views, odd F).  The fix-up writes the zero
// rows of the empty segments (three quarters of a sampled block's nodes)
// at full width.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChunk = 32;  // edges per chunk: one lane each; segsum.py's CHUNK
constexpr int kWarps = 8;   // warps per block of pass 1, one chunk each
constexpr int kBatch = 8;   // rows whose loads a warp keeps in flight
constexpr int kFix = 8;     // pieces whose loads a fix-up thread keeps in flight
constexpr int kFixThreads = 256;

// segsum.py's KIND_*: what pass 2 does for a segment (KIND_EMPTY, 1,
// gets zeros)
constexpr signed char kInside = 0;    // pass 1 wrote it
constexpr signed char kCrossing = 2;  // the sum of its pieces

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// VEC consecutive columns from c of one message row (0 past n_cols).
// VEC == 2 only for float32 rows with unit column stride, an even F and
// 8-byte alignment (chosen per launch), so c + 1 < n_cols when c does.
template <int VEC, typename T>
__device__ __forceinline__ void load_cols(const T* row, int c, int n_cols,
                                          long long stride_f,
                                          float (&v)[VEC]) {
  if constexpr (VEC == 2) {
    if (c < n_cols) {
      const float2 x = *reinterpret_cast<const float2*>(row + c);
      v[0] = x.x;
      v[1] = x.y;
    } else {
      v[0] = v[1] = 0.0f;
    }
  } else {
    v[0] = c < n_cols ? to_float(row[c * stride_f]) : 0.0f;
  }
}

template <int VEC>
__device__ __forceinline__ void store_cols(float* row, int c,
                                           const float (&v)[VEC]) {
  if constexpr (VEC == 2)
    *reinterpret_cast<float2*>(row + c) = make_float2(v[0], v[1]);
  else
    row[c] = v[0];
}

// Pass 1.  Column unit u = blockIdx.y * 32 * CPL + lane + 32 j covers
// columns VEC u .. VEC u + VEC - 1.
template <typename T, int CPL, int VEC>
__global__ void __launch_bounds__(kWarps * 32)
    segsum_chunks(const T* __restrict__ msgs, const int* __restrict__ perm,
                  const int* __restrict__ sorted_seg,
                  float* __restrict__ out, float* __restrict__ scratch,
                  int n_edges, int n_segments, int n_cols,
                  long long stride_e, long long stride_f) {
  const int lane = threadIdx.x & 31;
  const int chunk = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int p0 = chunk * kChunk;
  if (p0 >= n_edges) return;  // whole warps leave together
  const int p = p0 + lane;
  const int seg = p < n_edges ? sorted_seg[p] : n_segments;
  const int edge = p < n_edges ? perm[p] : 0;
  // the segments just before and just after the chunk (every lane loads
  // the same word): a run of either crosses the chunk's edge
  const int prev = p0 > 0 ? sorted_seg[p0 - 1] : -1;
  const int next = p0 + kChunk < n_edges ? sorted_seg[p0 + kChunk]
                                         : n_segments;
  // the valid positions are a prefix of the chunk (dropped ids sort last)
  const int cnt = __popc(__ballot_sync(0xffffffffu, seg < n_segments));
  if (cnt == 0) return;

  const int u0 = blockIdx.y * (32 * CPL) + lane;
  float acc[CPL][VEC];
#pragma unroll
  for (int j = 0; j < CPL; ++j)
#pragma unroll
    for (int x = 0; x < VEC; ++x) acc[j][x] = 0.0f;
  int cur = __shfl_sync(0xffffffffu, seg, 0);
  bool first_run = true;

  // write the run of segment `cur` that ends here, then start anew
  auto flush = [&]() {
    float* dst;
    if (cur != prev && cur != next)
      dst = out + static_cast<long long>(cur) * n_cols;
    else
      dst = scratch +
            (static_cast<long long>(chunk) * 2 + (first_run ? 0 : 1)) * n_cols;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = (u0 + 32 * j) * VEC;
      if (c < n_cols) store_cols<VEC>(dst, c, acc[j]);
#pragma unroll
      for (int x = 0; x < VEC; ++x) acc[j][x] = 0.0f;
    }
    first_run = false;
  };

  for (int k = 0; k < cnt; k += kBatch) {
    // kBatch rows loaded before any is added, so their loads are in
    // flight together; the adds keep the sorted order
    float v[kBatch][CPL][VEC];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int e = __shfl_sync(0xffffffffu, edge, (k + b) & 31);
      const T* row = msgs + static_cast<long long>(e) * stride_e;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int c = (u0 + 32 * j) * VEC;
        if (k + b < cnt) {
          load_cols<VEC>(row, c, n_cols, stride_f, v[b][j]);
        } else {
#pragma unroll
          for (int x = 0; x < VEC; ++x) v[b][j][x] = 0.0f;
        }
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (k + b < cnt) {  // the same for every lane
        const int s = __shfl_sync(0xffffffffu, seg, k + b);
        if (s != cur) {
          flush();
          cur = s;
        }
#pragma unroll
        for (int j = 0; j < CPL; ++j)
#pragma unroll
          for (int x = 0; x < VEC; ++x) acc[j][x] += v[b][j][x];
      }
    }
  }
  flush();
}

// Pass 2: thread i is segment i / (F / VEC), column unit i % (F / VEC).
template <int VEC>
__global__ void __launch_bounds__(kFixThreads)
    segsum_fixup(const int* __restrict__ offsets,
                 const signed char* __restrict__ kind,
                 const float* __restrict__ scratch, float* __restrict__ out,
                 int n_segments, int n_cols) {
  const int units = n_cols / VEC;
  const long long i =
      static_cast<long long>(blockIdx.x) * kFixThreads + threadIdx.x;
  if (i >= static_cast<long long>(n_segments) * units) return;
  const int n = static_cast<int>(i / units);
  const int c = static_cast<int>(i % units) * VEC;
  const signed char what = kind[n];
  if (what == kInside) return;
  float v[VEC];
#pragma unroll
  for (int x = 0; x < VEC; ++x) v[x] = 0.0f;
  if (what == kCrossing) {
    const int b = offsets[n], e = offsets[n + 1];
    const int c0 = b / kChunk, c1 = (e - 1) / kChunk;
    // the first piece: slot 0 when the segment starts its chunk, else the
    // chunk's last run, slot 1; every later piece starts its chunk
    const float* first =
        scratch + (static_cast<long long>(c0) * 2 + (b % kChunk ? 1 : 0)) *
                      n_cols + c;
#pragma unroll
    for (int x = 0; x < VEC; ++x) v[x] = first[x];
    for (int k = c0 + 1; k <= c1; k += kFix) {
      float w[kFix][VEC];
#pragma unroll
      for (int b2 = 0; b2 < kFix; ++b2) {
        const float* piece =
            scratch + static_cast<long long>(k + b2) * 2 * n_cols + c;
#pragma unroll
        for (int x = 0; x < VEC; ++x)
          w[b2][x] = k + b2 <= c1 ? piece[x] : 0.0f;
      }
#pragma unroll
      for (int b2 = 0; b2 < kFix; ++b2)
        if (k + b2 <= c1)
#pragma unroll
          for (int x = 0; x < VEC; ++x) v[x] += w[b2][x];
    }
  }
  store_cols<VEC>(out + static_cast<long long>(n) * n_cols, c, v);
}

template <typename T, int CPL, int VEC>
void launch_chunks(const void* msgs, const int* perm, const int* sorted_seg,
                   float* out, float* scratch, int n_edges, int n_segments,
                   int n_cols, long long stride_e, long long stride_f,
                   cudaStream_t st) {
  const int n_chunks = (n_edges + kChunk - 1) / kChunk;
  const int units = (n_cols + VEC - 1) / VEC;
  const dim3 grid((n_chunks + kWarps - 1) / kWarps,
                  (units + 32 * CPL - 1) / (32 * CPL));
  segsum_chunks<T, CPL, VEC><<<grid, kWarps * 32, 0, st>>>(
      static_cast<const T*>(msgs), perm, sorted_seg, out, scratch, n_edges,
      n_segments, n_cols, stride_e, stride_f);
}

template <typename T, int VEC>
void dispatch(const void* msgs, const int* perm, const int* sorted_seg,
              float* out, float* scratch, int n_edges, int n_segments,
              int n_cols, long long stride_e, long long stride_f,
              cudaStream_t st) {
  // the fewest column units per lane that cover F in one pass; wider F
  // loops over tiles of 256 units on the grid's y axis
  const int units = (n_cols + VEC - 1) / VEC;
  if (units <= 32)
    launch_chunks<T, 1, VEC>(msgs, perm, sorted_seg, out, scratch, n_edges,
                             n_segments, n_cols, stride_e, stride_f, st);
  else if (units <= 64)
    launch_chunks<T, 2, VEC>(msgs, perm, sorted_seg, out, scratch, n_edges,
                             n_segments, n_cols, stride_e, stride_f, st);
  else if (units <= 96)
    launch_chunks<T, 3, VEC>(msgs, perm, sorted_seg, out, scratch, n_edges,
                             n_segments, n_cols, stride_e, stride_f, st);
  else if (units <= 128)
    launch_chunks<T, 4, VEC>(msgs, perm, sorted_seg, out, scratch, n_edges,
                             n_segments, n_cols, stride_e, stride_f, st);
  else
    launch_chunks<T, 8, VEC>(msgs, perm, sorted_seg, out, scratch, n_edges,
                             n_segments, n_cols, stride_e, stride_f, st);
}

}  // namespace

extern "C" {

// Launch K4: msgs [E, F] (float32, or bfloat16 when is_bf16) given by
// its base pointer and its row and column strides in elements; perm,
// sorted_seg int32[E], offsets int32[N + 1] and kind int8[N] from the
// layout; scratch float32 [ceil(E / 32)][2][F] and out float32 [N, F],
// both contiguous.  Returns a cudaError_t (0 = launched).
int segsum_launch(const void* msgs, const void* perm, const void* sorted_seg,
                  const void* offsets, const void* kind, void* scratch,
                  void* out, int n_edges, int n_segments, int n_cols,
                  long long stride_e, long long stride_f, int is_bf16,
                  void* stream) {
  if (n_segments <= 0 || n_cols <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(perm);
  const int* s = static_cast<const int*>(sorted_seg);
  float* y = static_cast<float*>(out);
  float* w = static_cast<float*>(scratch);
  if (n_edges > 0) {
    const bool pairs = !is_bf16 && stride_f == 1 && stride_e % 2 == 0 &&
                       n_cols % 2 == 0 &&
                       reinterpret_cast<std::uintptr_t>(msgs) % 8 == 0;
    if (is_bf16)
      dispatch<__nv_bfloat16, 1>(msgs, p, s, y, w, n_edges, n_segments,
                                 n_cols, stride_e, stride_f, st);
    else if (pairs)
      dispatch<float, 2>(msgs, p, s, y, w, n_edges, n_segments, n_cols,
                         stride_e, stride_f, st);
    else
      dispatch<float, 1>(msgs, p, s, y, w, n_edges, n_segments, n_cols,
                         stride_e, stride_f, st);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int* o = static_cast<const int*>(offsets);
  const signed char* k = static_cast<const signed char*>(kind);
  if (n_cols % 2 == 0) {
    const long long n = static_cast<long long>(n_segments) * (n_cols / 2);
    const unsigned blocks = static_cast<unsigned>((n + kFixThreads - 1) /
                                                  kFixThreads);
    segsum_fixup<2><<<blocks, kFixThreads, 0, st>>>(o, k, w, y, n_segments,
                                                    n_cols);
  } else {
    const long long n = static_cast<long long>(n_segments) * n_cols;
    const unsigned blocks = static_cast<unsigned>((n + kFixThreads - 1) /
                                                  kFixThreads);
    segsum_fixup<1><<<blocks, kFixThreads, 0, st>>>(o, k, w, y, n_segments,
                                                    n_cols);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
