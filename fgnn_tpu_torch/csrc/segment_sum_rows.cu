// Segment sum of rows for Hopper (sm_90a): out[s, :] = sum of rows[j] over
// the entries j of segment s, [s*K, s*K + K), where mask[j]; accumulated in
// float32 and written in the rows' dtype (float32 or bfloat16). This is the
// forward of segment_agg's regular branch
// (fgnn_tpu_torch/models/aggregate.py), the masked sum of a dst's K message
// slots, which the JAX reference leaves to XLA
// (fgnn_tpu/models/aggregate.py::segment_agg, regular branch).
// It replaces no TPU kernel: no pl.pallas_call computes this. It was added
// because the masked where + sum over [E, D] messages was the second
// largest device op of GCN's training step on an H100.
//
// What bounds it: bytes. Each valid entry's row is read once and each
// segment's row written once; there is one add per element read. Design:
//   * a group of G threads (G a power of two <= 32, the smallest that covers
//     the row's vectors) owns one segment; each thread owns some of the
//     row's 16-byte vectors and sums them over the segment's entries in
//     registers, so nothing but the result is written;
//   * the entries of a segment are summed in ascending order, one after
//     another, so a segment's sum does not change from run to run;
//   * rows move as 16-byte vectors where the row's byte count and both base
//     pointers allow it, else 8-byte or one-element words; D may be any
//     width;
//   * a masked entry issues no read of its row;
//   * row offsets are 64-bit.
// It launches on the caller's stream, allocates nothing, and reports
// cudaGetLastError() to the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, int N, int kGroup>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const Pack<T, N>* __restrict__ rows,
                   const bool* __restrict__ mask, int64_t K,
                   Pack<T, N>* __restrict__ out, int64_t num_segments,
                   int row_vecs) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t seg = t / kGroup;
  if (seg >= num_segments) return;
  const int lane = static_cast<int>(t % kGroup);
  const int64_t begin = seg * K;
  const int64_t end = begin + K;
  Pack<T, N>* dst = out + seg * row_vecs;
  for (int v = lane; v < row_vecs; v += kGroup) {
    float acc[N] = {};
#pragma unroll 4
    for (int64_t j = begin; j < end; ++j) {
      if (!mask[j]) continue;
      const Pack<T, N> p = rows[j * row_vecs + v];
#pragma unroll
      for (int e = 0; e < N; ++e) acc[e] += to_float(p.v[e]);
    }
    Pack<T, N> o;
#pragma unroll
    for (int e = 0; e < N; ++e) o.v[e] = from_float<T>(acc[e]);
    dst[v] = o;
  }
}

template <typename T, int N, int kGroup>
void launch(const void* rows, const bool* mask, int64_t K, void* out,
            int64_t num_segments, int row_vecs, cudaStream_t stream) {
  const int64_t threads = num_segments * kGroup;
  const unsigned int blocks =
      static_cast<unsigned int>((threads + kThreads - 1) / kThreads);
  segment_sum_kernel<T, N, kGroup><<<blocks, kThreads, 0, stream>>>(
      static_cast<const Pack<T, N>*>(rows), mask, K,
      static_cast<Pack<T, N>*>(out), num_segments, row_vecs);
}

template <typename T, int N>
void launch_group(const void* rows, const bool* mask, int64_t K, void* out,
                  int64_t num_segments, int64_t width, cudaStream_t stream) {
  const int row_vecs = static_cast<int>(width / N);
#define FGNN_LAUNCH(G) \
  launch<T, N, G>(rows, mask, K, out, num_segments, row_vecs, stream)
  if (row_vecs <= 1) {
    FGNN_LAUNCH(1);
  } else if (row_vecs <= 2) {
    FGNN_LAUNCH(2);
  } else if (row_vecs <= 4) {
    FGNN_LAUNCH(4);
  } else if (row_vecs <= 8) {
    FGNN_LAUNCH(8);
  } else if (row_vecs <= 16) {
    FGNN_LAUNCH(16);
  } else {
    FGNN_LAUNCH(32);
  }
#undef FGNN_LAUNCH
}

template <typename T>
void launch_type(const void* rows, const bool* mask, int64_t K, void* out,
                 int64_t num_segments, int64_t width, cudaStream_t stream) {
  const int64_t row_bytes = width * static_cast<int64_t>(sizeof(T));
  const uintptr_t align = reinterpret_cast<uintptr_t>(rows) |
                          reinterpret_cast<uintptr_t>(out) |
                          static_cast<uintptr_t>(row_bytes);
  constexpr int kVec16 = 16 / sizeof(T);
  constexpr int kVec8 = 8 / sizeof(T);
  if (align % 16 == 0) {
    launch_group<T, kVec16>(rows, mask, K, out, num_segments, width, stream);
  } else if (align % 8 == 0) {
    launch_group<T, kVec8>(rows, mask, K, out, num_segments, width, stream);
  } else {
    launch_group<T, 1>(rows, mask, K, out, num_segments, width, stream);
  }
}

}  // namespace

// rows [num_segments * K, width] and out [num_segments, width] of dtype 0
// float32 or 1 bfloat16; mask [num_segments * K]. Returns the cudaError_t
// of the launch (0 on success).
extern "C" int fgnn_segment_sum_rows(const void* rows, const bool* mask,
                                     int64_t K, void* out,
                                     int64_t num_segments, int64_t width,
                                     int dtype, void* stream) {
  // 32 threads a segment, 256 a block, at most 2^31 - 1 blocks; a row's
  // vector count fits an int
  if (num_segments <= 0 || num_segments >= (int64_t{1} << 34) || K <= 0 ||
      width <= 0 || width >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch_type<float>(rows, mask, K, out, num_segments, width, s);
  } else if (dtype == 1) {
    launch_type<__nv_bfloat16>(rows, mask, K, out, num_segments, width, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
