// Streaming pass for Hopper (sm_90a): out = x + 1 over a contiguous float32
// array, each block owning one chunk of rows.
//
// Replaces K3, the TPU's inline Pallas copy_kernel in
// tools/gather_campaign.py::stream_campaign (o = x + 1.0 over [N, 128]
// float32, one grid step per chunk of 512 / 2048 / 8192 rows, moved
// HBM -> VMEM -> HBM by the Pallas pipeline). It measures the card's
// contiguous copy ceiling, against which the row gather is judged.
//
// What bounds it: bytes, 4 read and 4 written per element, with one add.
// The TPU kernel relied on the Pallas pipeline to double-buffer whole chunks
// through VMEM; on Hopper nothing has to be staged, so the design keeps
// enough 16-byte loads in flight straight from device memory:
//   * block b owns rows [b * chunk_rows, (b + 1) * chunk_rows), the meaning
//     of the Pallas chunk; the last block masks its ragged end, so N need
//     not be a multiple of the chunk (Pallas required it);
//   * inside its chunk a block of 512 threads moves float4 words, eight per
//     thread per iteration (64 KB of loads in flight per block, two blocks
//     an SM at the 60 registers this takes), with neighbouring threads on
//     neighbouring words; the eight loads are issued before any store;
//   * a chunk whose start is off the 16-byte grid (any D, or a misaligned
//     base) first moves a scalar head up to the next 16-byte boundary, and
//     every chunk ends with a scalar tail; when x and out are misaligned
//     against each other the host picks the all-scalar instantiation;
//   * loads go through the read-only path (__ldg). Streaming (evict-first)
//     hints on loads and stores, 256- or 1024-thread blocks and four words
//     a thread measured equal or slower on an H100 at chunks 512-8192.
// It launches on the caller's stream, allocates nothing, and reports
// cudaGetLastError() to the caller.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kUnroll = 8;

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
stream_add_one_kernel(const float* __restrict__ x, float* __restrict__ out,
                      int64_t n, int chunk_elems) {
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * chunk_elems;
  const int len = static_cast<int>(min(static_cast<int64_t>(chunk_elems), n - lo));
  const float* src = x + lo;
  float* dst = out + lo;
  const int tid = threadIdx.x;

  int head = len;  // the all-scalar instantiation moves the chunk as a head
  if (kVec) {
    const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(src) & 15) >> 2);
    head = min(mis ? 4 - mis : 0, len);
  }
  for (int i = tid; i < head; i += kThreads) dst[i] = __ldg(src + i) + 1.0f;
  if (!kVec) return;

  const int nvec = (len - head) >> 2;
  const float4* sv = reinterpret_cast<const float4*>(src + head);
  float4* dv = reinterpret_cast<float4*>(dst + head);
  int v = tid;
  for (; v + (kUnroll - 1) * kThreads < nvec; v += kUnroll * kThreads) {
    float4 a[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) a[u] = __ldg(sv + v + u * kThreads);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      a[u].x += 1.0f; a[u].y += 1.0f; a[u].z += 1.0f; a[u].w += 1.0f;
      dv[v + u * kThreads] = a[u];
    }
  }
  for (; v < nvec; v += kThreads) {
    float4 a = __ldg(sv + v);
    a.x += 1.0f; a.y += 1.0f; a.z += 1.0f; a.w += 1.0f;
    dv[v] = a;
  }
  for (int i = head + 4 * nvec + tid; i < len; i += kThreads) {
    dst[i] = __ldg(src + i) + 1.0f;
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). n > 0 elements in
// ceil(n / chunk_elems) blocks; 0 < chunk_elems < 2^31; the block count fits
// the 1-D grid (< 2^31).
extern "C" int fgnn_stream_add_one(const float* x, float* out, int64_t n,
                                   int64_t chunk_elems, void* stream) {
  if (n <= 0 || chunk_elems <= 0 || chunk_elems >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks = (n + chunk_elems - 1) / chunk_elems;
  if (blocks >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool same_grid = ((reinterpret_cast<uintptr_t>(x) ^
                           reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const unsigned int grid = static_cast<unsigned int>(blocks);
  const int chunk = static_cast<int>(chunk_elems);
  if (same_grid) {
    stream_add_one_kernel<true><<<grid, kThreads, 0, s>>>(x, out, n, chunk);
  } else {
    stream_add_one_kernel<false><<<grid, kThreads, 0, s>>>(x, out, n, chunk);
  }
  return static_cast<int>(cudaGetLastError());
}
