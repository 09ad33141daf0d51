// Row gather for Hopper (sm_90a): out[i] = table[ids[i]], a zero row where
// ids[i] < 0.
//
// Replaces the TPU's two Pallas row gathers:
//   K1 fgnn_tpu/ops/pallas_gather2.py::gather_rows_v2 (kernel body from
//      _make_kernel; skip_invalid=True issues no read for padding ids);
//   K2 fgnn_tpu/ops/pallas_gather.py::gather_rows, with its any-M wrapper
//      gather_rows_padded.
// Both compute the semantics of fgnn_tpu/ops/extract.py::device_gather.
//
// What bounds it: bytes moved, rows x row_bytes read plus the same written.
// There is no arithmetic. The TPU kernels staged ids in SMEM and kept a ring
// of per-row DMAs in flight because the TPU's scalar core issues one copy at
// a time; here every row is independent work for the SMs, so the design is
// a row-parallel copy:
//   * a group of G threads (G a power of two <= 32, the smallest that covers
//     the row's vectors) copies one row; neighbouring threads touch
//     neighbouring 16-byte words, so each row is read and written in whole
//     32-byte sectors, and a warp keeps 32/G rows in flight;
//   * rows move as 16-byte vectors when the row's byte count and both base
//     pointers allow it, else as 8, 4, 2 or 1-byte words (the host side
//     picks the widest width that divides all three); the kernel never looks
//     at the element type, so f32, bf16 and any other dtype share it;
//   * a padding row (id < 0) is written as zeros with no read of the table
//     (K1's skip_invalid=True);
//   * any number of rows: the last block masks its tail, so there is no
//     block multiple and no padding of ids;
//   * row offsets are 64-bit (at papers100M scale N x D reaches 1.4e10
//     elements, past what a 32-bit product holds); the index of a word
//     inside one row is 32-bit (a row is under 2 GB), which keeps the
//     16-byte path free of register spills;
//   * table reads go through the read-only path (__ldg): the table is never
//     written while the kernel runs.
// It launches on the caller's stream, allocates nothing, and reports
// cudaGetLastError() to the caller.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename Vec, int kGroup>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const Vec* __restrict__ table,
                   const int32_t* __restrict__ ids,
                   Vec* __restrict__ out,
                   int64_t num_ids,
                   int row_vecs) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t row = t / kGroup;
  if (row >= num_ids) return;
  const int lane = static_cast<int>(t % kGroup);
  const int64_t id = ids[row];
  Vec* dst = out + row * row_vecs;
  if (id < 0) {
    const Vec zero{};
    for (int v = lane; v < row_vecs; v += kGroup) dst[v] = zero;
    return;
  }
  const Vec* src = table + id * row_vecs;
  for (int v = lane; v < row_vecs; v += kGroup) dst[v] = __ldg(src + v);
}

template <typename Vec, int kGroup>
void launch(const void* table, const int32_t* ids, void* out, int64_t num_ids,
            int row_vecs, cudaStream_t stream) {
  const int64_t threads = num_ids * kGroup;
  const unsigned int blocks =
      static_cast<unsigned int>((threads + kThreads - 1) / kThreads);
  gather_rows_kernel<Vec, kGroup><<<blocks, kThreads, 0, stream>>>(
      static_cast<const Vec*>(table), ids, static_cast<Vec*>(out), num_ids,
      row_vecs);
}

template <typename Vec>
void launch_vec(const void* table, const int32_t* ids, void* out,
                int64_t num_ids, int64_t row_bytes, cudaStream_t stream) {
  const int row_vecs = static_cast<int>(row_bytes / sizeof(Vec));
  if (row_vecs <= 1) {
    launch<Vec, 1>(table, ids, out, num_ids, row_vecs, stream);
  } else if (row_vecs <= 2) {
    launch<Vec, 2>(table, ids, out, num_ids, row_vecs, stream);
  } else if (row_vecs <= 4) {
    launch<Vec, 4>(table, ids, out, num_ids, row_vecs, stream);
  } else if (row_vecs <= 8) {
    launch<Vec, 8>(table, ids, out, num_ids, row_vecs, stream);
  } else if (row_vecs <= 16) {
    launch<Vec, 16>(table, ids, out, num_ids, row_vecs, stream);
  } else {
    launch<Vec, 32>(table, ids, out, num_ids, row_vecs, stream);
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). num_ids must be > 0
// and fit the 1-D grid (num_ids * 32 / 256 < 2^31); a row is under 2^31
// bytes.
extern "C" int fgnn_gather_rows(const void* table, const int32_t* ids,
                                void* out, int64_t num_ids, int64_t row_bytes,
                                void* stream) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(table) |
                          reinterpret_cast<uintptr_t>(out) |
                          static_cast<uintptr_t>(row_bytes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_ids <= 0 || row_bytes <= 0 || row_bytes >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (align % 16 == 0) {
    launch_vec<uint4>(table, ids, out, num_ids, row_bytes, s);
  } else if (align % 8 == 0) {
    launch_vec<uint2>(table, ids, out, num_ids, row_bytes, s);
  } else if (align % 4 == 0) {
    launch_vec<unsigned int>(table, ids, out, num_ids, row_bytes, s);
  } else if (align % 2 == 0) {
    launch_vec<unsigned short>(table, ids, out, num_ids, row_bytes, s);
  } else {
    launch_vec<unsigned char>(table, ids, out, num_ids, row_bytes, s);
  }
  return static_cast<int>(cudaGetLastError());
}
