// K4 for Hopper: segment sum as a deterministic sorted-segment reduction.
//
// Replaces repro/kernels/segsum/segsum.py:segment_sum_pallas (its Pallas
// body _kernel and the host SegsumLayout that feeds it).  It computes
//
//   out[n, :] = sum of msgs[e, :] over the edges e with seg[e] == n
//
// in float32 for float32 or bfloat16 msgs [E, F]; ids outside [0, N)
// are dropped.  The wrapper (segsum.py) hands it the layout built on the
// card once per topology: perm, the valid edge ids stably sorted by
// segment (the dropped ones after them, never read), and offsets
// int32[N + 1], so that segment n owns perm[offsets[n] : offsets[n+1]].
//
// The TPU form groups the edges into node blocks of 128, copies msgs into
// a padded grouped buffer and turns each 256-edge tile into a one-hot
// MXU matmul, because the TPU has no atomics.  None of that carries over.
// Here one warp owns one segment and walks its edge list in sorted order:
// the lanes cover the F columns (lane + 32 j, CPL columns per lane, CPL
// chosen per launch from F), the sums stay in float32 registers, and
// each output row is written once, zeros for an empty segment.  The
// order of the sums is fixed by the layout, so two launches on the same
// operands give the same bits (index_add_, with its atomics, does not).
//
// What bounds it on this card: memory.  It must read each valid edge's
// message row once, perm and offsets once, and write out once; one add
// per element read is far below any compute rate.  Message rows are read
// with scalar loads through both strides, so any F (GatedGCN's 70
// float32 columns are 280 bytes, not a multiple of 16), bfloat16 and
// strided views are taken as they are.  A warp fetches 32 edge ids with
// one coalesced load and broadcasts them by shuffle, and loads the rows
// of kBatch edges before it adds them (in order), so that a long segment
// keeps kBatch * CPL loads in flight and not one.  A hub segment (an
// RMAT hub has ~10^3 edges) is still walked by its one warp alone; that
// is this simple kernel's known cost (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // warps per block, one segment each
constexpr int kBatch = 8;  // edges whose loads a warp keeps in flight

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, int CPL>
__global__ void __launch_bounds__(kWarps * 32)
    segsum_kernel(const T* __restrict__ msgs, const int* __restrict__ perm,
                  const int* __restrict__ offsets, float* __restrict__ out,
                  int n_segments, int n_cols, long long stride_e,
                  long long stride_f) {
  const int lane = threadIdx.x & 31;
  const int seg = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (seg >= n_segments) return;  // whole warps leave together
  const int col0 = blockIdx.y * (32 * CPL) + lane;
  float acc[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) acc[j] = 0.0f;
  const int begin = offsets[seg];
  const int end = offsets[seg + 1];
  for (int base = begin; base < end; base += 32) {
    const int mine = base + lane < end ? perm[base + lane] : 0;
    const int cnt = min(32, end - base);
    int k = 0;
    // kBatch edges' values are loaded before any is added, so their
    // loads are in flight together; the adds keep the sorted order
    for (; k + kBatch <= cnt; k += kBatch) {
      float v[kBatch][CPL];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = __shfl_sync(0xffffffffu, mine, k + u);
        const T* row = msgs + static_cast<long long>(e) * stride_e;
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          const int c = col0 + 32 * j;
          v[u][j] = c < n_cols ? to_float(row[c * stride_f]) : 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
#pragma unroll
        for (int j = 0; j < CPL; ++j) acc[j] += v[u][j];
    }
    for (; k < cnt; ++k) {
      const int e = __shfl_sync(0xffffffffu, mine, k);
      const T* row = msgs + static_cast<long long>(e) * stride_e;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int c = col0 + 32 * j;
        if (c < n_cols) acc[j] += to_float(row[c * stride_f]);
      }
    }
  }
  float* orow = out + static_cast<long long>(seg) * n_cols;
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int c = col0 + 32 * j;
    if (c < n_cols) orow[c] = acc[j];
  }
}

template <typename T, int CPL>
void launch(const void* msgs, const int* perm, const int* offsets,
            float* out, int n_segments, int n_cols, long long stride_e,
            long long stride_f, cudaStream_t st) {
  const dim3 grid((n_segments + kWarps - 1) / kWarps,
                  (n_cols + 32 * CPL - 1) / (32 * CPL));
  segsum_kernel<T, CPL><<<grid, kWarps * 32, 0, st>>>(
      static_cast<const T*>(msgs), perm, offsets, out, n_segments, n_cols,
      stride_e, stride_f);
}

template <typename T>
void dispatch(const void* msgs, const int* perm, const int* offsets,
              float* out, int n_segments, int n_cols, long long stride_e,
              long long stride_f, cudaStream_t st) {
  // the fewest columns per lane that cover F in one pass; wider F loops
  // over column tiles of 256 on the grid's y axis
  if (n_cols <= 32)
    launch<T, 1>(msgs, perm, offsets, out, n_segments, n_cols, stride_e,
                 stride_f, st);
  else if (n_cols <= 64)
    launch<T, 2>(msgs, perm, offsets, out, n_segments, n_cols, stride_e,
                 stride_f, st);
  else if (n_cols <= 96)
    launch<T, 3>(msgs, perm, offsets, out, n_segments, n_cols, stride_e,
                 stride_f, st);
  else if (n_cols <= 128)
    launch<T, 4>(msgs, perm, offsets, out, n_segments, n_cols, stride_e,
                 stride_f, st);
  else
    launch<T, 8>(msgs, perm, offsets, out, n_segments, n_cols, stride_e,
                 stride_f, st);
}

}  // namespace

extern "C" {

// Launch K4: msgs [E, F] (float32, or bfloat16 when is_bf16) given by
// its base pointer and its row and column strides in elements; perm
// int32[E] and offsets int32[N + 1] from the layout; out float32 [N, F]
// contiguous.  Returns a cudaError_t (0 = launched).
int segsum_launch(const void* msgs, const void* perm, const void* offsets,
                  void* out, int n_segments, int n_cols, long long stride_e,
                  long long stride_f, int is_bf16, void* stream) {
  if (n_segments <= 0 || n_cols <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(perm);
  const int* o = static_cast<const int*>(offsets);
  float* y = static_cast<float*>(out);
  if (is_bf16)
    dispatch<__nv_bfloat16>(msgs, p, o, y, n_segments, n_cols, stride_e,
                            stride_f, st);
  else
    dispatch<float>(msgs, p, o, y, n_segments, n_cols, stride_e, stride_f,
                    st);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
