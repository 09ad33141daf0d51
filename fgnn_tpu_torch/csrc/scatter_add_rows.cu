// Row scatter-add for Hopper (sm_90a), the transpose of the row gather:
// grad[ids[i], :] += grad_out[i / K, :] for every slot i with ids[i] >= 0
// (and mask[i], where a mask is given), into a zeroed float32 buffer.
//   * K = 1 (no mask) is the backward of GatherRows
//     (fgnn_tpu_torch/ops/gather.py), the gather of K1 and K2;
//   * K > 1 with the block's mask is the backward of GatherSegmentSum
//     (fgnn_tpu_torch/ops/segment.py) on a regular block, where slot
//     d*K + k belongs to dst d: it reads each dst's gradient row once and
//     adds it into that dst's K sources. No [E, D] gradient is built.
// It replaces no TPU kernel: the JAX reference's gather backward is XLA's
// scatter-add (the VJP of fgnn_tpu/ops/extract.py::device_gather). It was
// added because the masked_fill and float32 index_add_ of that backward were
// the largest device ops of GCN's training step on an H100.
//
// What bounds it: bytes. Each dst's gradient row is read once, the ids once,
// and each target row is written; the adds are float32 atomics in L2, whose
// order changes from run to run (the deterministic mode of the wrapper
// takes segment_sum_rows.cu's explicit mode instead). Design:
//   * a group of G threads (G a power of two <= 32) owns one dst row; each
//     thread loads its 16-byte vectors of the row once into registers, in
//     float32, then adds them into the row of each of the dst's valid slots;
//   * the adds are vector atomics: atomicAdd on float4 (float2) global
//     addresses, one red.global.add.v4.f32 each on sm_90, so a 1 KB row is
//     64 reductions rather than 256;
//   * a padding slot (id < 0 or masked) issues no add;
//   * grad_out may be float32 or bfloat16; the buffer is float32, so bf16
//     rows that many slots share do not lose their small terms; the wrapper
//     casts it back;
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

// dst[0..N) += f[0..N), by the widest vector atomics the count allows
template <int N>
__device__ __forceinline__ void add_row(float* dst, const float (&f)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int e = 0; e < N; e += 4) {
      atomicAdd(reinterpret_cast<float4*>(dst + e),
                make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]));
    }
  } else if constexpr (N == 2) {
    atomicAdd(reinterpret_cast<float2*>(dst), make_float2(f[0], f[1]));
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) atomicAdd(dst + e, f[e]);
  }
}

template <typename T, int N, int kGroup>
__global__ void __launch_bounds__(kThreads)
scatter_add_kernel(const Pack<T, N>* __restrict__ grad_out,
                   const int32_t* __restrict__ ids,
                   const bool* __restrict__ mask, float* __restrict__ grad,
                   int64_t num_dst, int64_t K, int row_vecs, int64_t width) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t d = t / kGroup;
  if (d >= num_dst) return;
  const int lane = static_cast<int>(t % kGroup);
  const int32_t* slot_ids = ids + d * K;
  const bool* slot_mask = mask == nullptr ? nullptr : mask + d * K;
  for (int v = lane; v < row_vecs; v += kGroup) {
    const Pack<T, N> p = grad_out[d * row_vecs + v];
    float f[N];
#pragma unroll
    for (int e = 0; e < N; ++e) f[e] = to_float(p.v[e]);
    for (int64_t k = 0; k < K; ++k) {
      const int64_t id = __ldg(slot_ids + k);
      if (id < 0 || (slot_mask != nullptr && !slot_mask[k])) continue;
      add_row<N>(grad + id * width + static_cast<int64_t>(v) * N, f);
    }
  }
}

template <typename T, int N>
void launch_group(const void* grad_out, const int32_t* ids, const bool* mask,
                  float* grad, int64_t num_dst, int64_t K, int64_t width,
                  cudaStream_t stream) {
  const int row_vecs = static_cast<int>(width / N);
  int group = 32;
  for (int g = 1; g < 32; g *= 2) {
    if (row_vecs <= g) {
      group = g;
      break;
    }
  }
  const int64_t threads = num_dst * group;
  const unsigned int blocks =
      static_cast<unsigned int>((threads + kThreads - 1) / kThreads);
  const auto* src = static_cast<const Pack<T, N>*>(grad_out);
#define FGNN_LAUNCH(G)                                                   \
  scatter_add_kernel<T, N, G><<<blocks, kThreads, 0, stream>>>(          \
      src, ids, mask, grad, num_dst, K, row_vecs, width)
  switch (group) {
    case 1: FGNN_LAUNCH(1); break;
    case 2: FGNN_LAUNCH(2); break;
    case 4: FGNN_LAUNCH(4); break;
    case 8: FGNN_LAUNCH(8); break;
    case 16: FGNN_LAUNCH(16); break;
    default: FGNN_LAUNCH(32); break;
  }
#undef FGNN_LAUNCH
}

template <typename T>
void launch_type(const void* grad_out, const int32_t* ids, const bool* mask,
                 float* grad, int64_t num_dst, int64_t K, int64_t width,
                 cudaStream_t stream) {
  // a vector of n elements must divide the row, and its loads from grad_out
  // (n * sizeof(T) bytes) and its adds into grad (4n bytes) must be aligned
  const auto fits = [&](int n) {
    return width % n == 0 &&
           reinterpret_cast<uintptr_t>(grad_out) % (n * sizeof(T)) == 0 &&
           reinterpret_cast<uintptr_t>(grad) % (4 * n) == 0;
  };
  constexpr int kVec16 = 16 / sizeof(T);
  constexpr int kVec8 = 8 / sizeof(T);
  if (fits(kVec16)) {
    launch_group<T, kVec16>(grad_out, ids, mask, grad, num_dst, K, width,
                            stream);
  } else if (fits(kVec8)) {
    launch_group<T, kVec8>(grad_out, ids, mask, grad, num_dst, K, width,
                           stream);
  } else {
    launch_group<T, 1>(grad_out, ids, mask, grad, num_dst, K, width, stream);
  }
}

}  // namespace

// grad_out [num_dst, width] of dtype 0 float32 or 1 bfloat16; ids and mask
// (or null) [num_dst * K], every id in [-1, rows of grad); grad [*, width]
// float32, zeroed by the caller. Returns the cudaError_t of the launch.
extern "C" int fgnn_scatter_add_rows(const void* grad_out, const int32_t* ids,
                                     const bool* mask, float* grad,
                                     int64_t num_dst, int64_t K, int64_t width,
                                     int dtype, void* stream) {
  if (num_dst <= 0 || num_dst >= (int64_t{1} << 34) || K <= 0 || width <= 0 ||
      width >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch_type<float>(grad_out, ids, mask, grad, num_dst, K, width, s);
  } else if (dtype == 1) {
    launch_type<__nv_bfloat16>(grad_out, ids, mask, grad, num_dst, K, width,
                               s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
