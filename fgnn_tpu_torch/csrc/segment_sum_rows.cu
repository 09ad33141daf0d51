// Segment sum of rows for Hopper (sm_90a): out[s, :] = sum of the rows of
// segment s, accumulated in float32 and written in the rows' dtype (float32
// or bfloat16). One kernel, two index modes:
//   * regular: segment s covers entries [s*K, s*K + K); entry j adds
//     rows[j] where mask[j]. This is the forward of segment_agg's regular
//     branch (fgnn_tpu_torch/models/aggregate.py), the masked sum of a dst's
//     K message slots, which the JAX reference leaves to XLA
//     (fgnn_tpu/models/aggregate.py::segment_agg, regular branch);
//   * explicit: segment s covers entries [ptr[s], ptr[s+1]); entry j adds
//     rows[idx[j]] where idx[j] >= 0. The deterministic mode of
//     scatter_add_rows (fgnn_tpu_torch/ops/segment.py) sorts the scatter's
//     slots by target row and sums each row here, in ascending slot order,
//     with no atomics.
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
//   * a masked entry (or idx < 0) issues no read of its row;
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

template <typename T, int N, int kGroup, bool kExplicit>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const Pack<T, N>* __restrict__ rows,
                   const bool* __restrict__ mask, int64_t K,
                   const int64_t* __restrict__ ptr,
                   const int64_t* __restrict__ idx,
                   Pack<T, N>* __restrict__ out, int64_t num_segments,
                   int row_vecs) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t seg = t / kGroup;
  if (seg >= num_segments) return;
  const int lane = static_cast<int>(t % kGroup);
  int64_t begin, end;
  if (kExplicit) {
    begin = ptr[seg];
    end = ptr[seg + 1];
  } else {
    begin = seg * K;
    end = begin + K;
  }
  Pack<T, N>* dst = out + seg * row_vecs;
  for (int v = lane; v < row_vecs; v += kGroup) {
    float acc[N] = {};
#pragma unroll 4
    for (int64_t j = begin; j < end; ++j) {
      int64_t r;
      if (kExplicit) {
        r = __ldg(idx + j);
        if (r < 0) continue;
      } else {
        if (!mask[j]) continue;
        r = j;
      }
      const Pack<T, N> p = rows[r * row_vecs + v];
#pragma unroll
      for (int e = 0; e < N; ++e) acc[e] += to_float(p.v[e]);
    }
    Pack<T, N> o;
#pragma unroll
    for (int e = 0; e < N; ++e) o.v[e] = from_float<T>(acc[e]);
    dst[v] = o;
  }
}

template <typename T, int N, int kGroup, bool kExplicit>
void launch(const void* rows, const bool* mask, int64_t K, const int64_t* ptr,
            const int64_t* idx, void* out, int64_t num_segments, int row_vecs,
            cudaStream_t stream) {
  const int64_t threads = num_segments * kGroup;
  const unsigned int blocks =
      static_cast<unsigned int>((threads + kThreads - 1) / kThreads);
  segment_sum_kernel<T, N, kGroup, kExplicit><<<blocks, kThreads, 0, stream>>>(
      static_cast<const Pack<T, N>*>(rows), mask, K, ptr, idx,
      static_cast<Pack<T, N>*>(out), num_segments, row_vecs);
}

template <typename T, int N, bool kExplicit>
void launch_group(const void* rows, const bool* mask, int64_t K,
                  const int64_t* ptr, const int64_t* idx, void* out,
                  int64_t num_segments, int64_t width, cudaStream_t stream) {
  const int row_vecs = static_cast<int>(width / N);
#define FGNN_LAUNCH(G)                                                      \
  launch<T, N, G, kExplicit>(rows, mask, K, ptr, idx, out, num_segments,    \
                             row_vecs, stream)
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

template <typename T, bool kExplicit>
void launch_type(const void* rows, const bool* mask, int64_t K,
                 const int64_t* ptr, const int64_t* idx, void* out,
                 int64_t num_segments, int64_t width, cudaStream_t stream) {
  const int64_t row_bytes = width * static_cast<int64_t>(sizeof(T));
  const uintptr_t align = reinterpret_cast<uintptr_t>(rows) |
                          reinterpret_cast<uintptr_t>(out) |
                          static_cast<uintptr_t>(row_bytes);
  constexpr int kVec16 = 16 / sizeof(T);
  constexpr int kVec8 = 8 / sizeof(T);
  if (align % 16 == 0) {
    launch_group<T, kVec16, kExplicit>(rows, mask, K, ptr, idx, out,
                                       num_segments, width, stream);
  } else if (align % 8 == 0) {
    launch_group<T, kVec8, kExplicit>(rows, mask, K, ptr, idx, out,
                                      num_segments, width, stream);
  } else {
    launch_group<T, 1, kExplicit>(rows, mask, K, ptr, idx, out, num_segments,
                                  width, stream);
  }
}

template <bool kExplicit>
int dispatch(const void* rows, const bool* mask, int64_t K, const int64_t* ptr,
             const int64_t* idx, void* out, int64_t num_segments,
             int64_t width, int dtype, cudaStream_t stream) {
  if (dtype == 0) {
    launch_type<float, kExplicit>(rows, mask, K, ptr, idx, out, num_segments,
                                  width, stream);
  } else if (dtype == 1) {
    launch_type<__nv_bfloat16, kExplicit>(rows, mask, K, ptr, idx, out,
                                          num_segments, width, stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

bool bad_size(int64_t num_segments, int64_t width) {
  // 32 threads a segment, 256 a block, at most 2^31 - 1 blocks; a row's
  // vector count fits an int
  return num_segments <= 0 || num_segments >= (int64_t{1} << 34) ||
         width <= 0 || width >= (int64_t{1} << 31);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (rows and out share it). Returns the
// cudaError_t of the launch (0 on success).

// Regular mode: rows [num_segments * K, width], mask [num_segments * K].
extern "C" int fgnn_segment_sum_rows(const void* rows, const bool* mask,
                                     int64_t K, void* out,
                                     int64_t num_segments, int64_t width,
                                     int dtype, void* stream) {
  if (bad_size(num_segments, width) || K <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dispatch<false>(rows, mask, K, nullptr, nullptr, out, num_segments,
                         width, dtype, static_cast<cudaStream_t>(stream));
}

// Explicit mode: ptr [num_segments + 1] nondecreasing, idx [ptr[last]] with
// every entry in [-1, rows); rows [*, width].
extern "C" int fgnn_segment_sum_rows_by_ptr(const void* rows,
                                            const int64_t* ptr,
                                            const int64_t* idx, void* out,
                                            int64_t num_segments,
                                            int64_t width, int dtype,
                                            void* stream) {
  if (bad_size(num_segments, width)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dispatch<true>(rows, nullptr, 0, ptr, idx, out, num_segments, width,
                        dtype, static_cast<cudaStream_t>(stream));
}
