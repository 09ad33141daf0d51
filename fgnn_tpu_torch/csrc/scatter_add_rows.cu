// Row scatter-add for Hopper (sm_90a), the transpose of the row gather,
// computed in gather form:
//   grad[r, :] = sum of grad_out[i / K, :] over the slots i with ids[i] == r
//                (and mask[i], where a mask is given),
// accumulated in float32 and written once, in grad_out's dtype (float32 or
// bfloat16); a row that no slot names is written as zeros.
//   * K = 1 (no mask) is the backward of GatherRows
//     (fgnn_tpu_torch/ops/gather.py), the gather of K1 and K2;
//   * K > 1 with the block's mask is the backward of GatherSegmentSum
//     (fgnn_tpu_torch/ops/segment.py) on a regular block, where slot
//     d*K + k belongs to dst d: no [E, D] gradient is built.
// It replaces no TPU kernel: the JAX reference's gather backward is XLA's
// scatter-add (the VJP of fgnn_tpu/ops/extract.py::device_gather). It was
// added because the masked_fill and float32 index_add_ of that backward were
// the largest device ops of GCN's training step on an H100.
//
// What bounds it: bytes. Each valid slot's gradient row is read once and
// each output row is written once; the ids, the mask and the CSR built from
// them are a few bytes a slot. A push (one float atomic a slot into a zeroed
// float32 buffer) also moves each target row through HBM once a slot when
// the rows do not fit L2, and needs the zero fill and, for bf16, a cast
// pass. This kernel pulls instead. Stages, all on the caller's stream:
//   1. count: counts[r], the valid slots of each row (a memset, then one
//      integer atomic a warp and row: lanes that name the same row are
//      merged by __match_any_sync, so a hub row costs one atomic a warp);
//   2. scan: ptr, the exclusive sum of counts, in three launches (each tile
//      of kTile counts summed, a one-block scan of the tile sums, each tile
//      scanned from its offset); the last one also lists the long rows;
//   3. fill: each valid slot writes i / K into idx[ptr[r] + --counts[r]],
//      the transpose as a CSR; a row's slots in the order of the atomics;
//   4. sum: a group of G threads (G a power of two <= 32) owns an output
//      row. It loads up to G of the row's idx entries in one coalesced load
//      and hands them round by shuffles; each thread then loads its
//      kVecsPerLane 16-byte vectors of kUnroll slots' rows together (8
//      independent loads in flight) and adds them into float32 registers
//      in ascending slot order. The row is written once, in the output
//      dtype, with no atomics;
//   5. long rows: a row of more than kChunk slots is cut into chunks of
//      kChunk. Each chunk is a group of its own, first in the grid, and
//      writes its float32 partial sum to the workspace; a last launch over
//      the long rows only folds each row's partials in chunk order. A hub
//      row cannot hold the tail of the launch.
// The second entry point takes a CSR (ptr, idx) that the caller sorted (a
// stable sort, so each row's slots ascend) and runs stages 4-5: its sums do
// not change from run to run. The sum's order inside a row follows idx,
// so the first entry point's may change from run to run, as the atomics'
// order did.
// The sum stage keeps 8 loads in flight a thread (2 vectors of 4 slots,
// added in a fixed order) rather than a ring of 1-D bulk copies into
// shared memory: most rows take one to three slots, too few to fill a
// ring, and measured at GCN's first layer on an H100 80GB HBM3 (python -m
// fgnn_tpu_torch.tools.segment_kernels) the sum moves its 3.08 GB (each
// valid slot's row read, each output row written) at 2.64 TB/s, 89% of
// the 2.97 TB/s the card's plain copy reaches, which leaves a ring little
// to gain.
//   * rows move as 16-byte vectors where the row's byte count and both base
//     pointers allow it, else 8-byte or one-element words; D may be any
//     width;
//   * row offsets are 64-bit; slots and rows are counted in 32 bits (the
//     wrapper holds both under 2^31).
// It allocates nothing: the caller passes a workspace of
// fgnn_scatter_add_rows_workspace() bytes (the counts, the CSR, the chunk
// lists and the long rows' partials). It reports cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 128;       // slots one group sums into one row
constexpr int kUnroll = 4;        // slots whose rows a thread loads together
constexpr int kVecsPerLane = 2;   // vectors of a row one thread owns
constexpr int kScanItems = 8;     // counts one thread scans
constexpr int kTile = kThreads * kScanItems;
constexpr int kScanThreads = 1024;

// the long rows' lists, counted by atomics; zeroed by the host each call
struct Plan {
  int num_chunks;  // chunks of long rows: one partial row each
  int num_long;    // long rows
};

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

// -- stages 1-3: the CSR ------------------------------------------------------

// the row slot i adds into, or -1 (padding, masked, or past the end)
__device__ __forceinline__ int slot_row(const int32_t* __restrict__ ids,
                                        const bool* __restrict__ mask,
                                        int64_t i, int64_t num_slots) {
  if (i >= num_slots) return -1;
  const int32_t id = ids[i];
  if (id < 0 || (mask != nullptr && !mask[i])) return -1;
  return id;
}

__global__ void __launch_bounds__(kThreads)
count_kernel(const int32_t* __restrict__ ids, const bool* __restrict__ mask,
             int* __restrict__ counts, int64_t num_slots) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int r = slot_row(ids, mask, i, num_slots);
  const unsigned peers = __match_any_sync(0xffffffffu, r);
  if (r >= 0 && static_cast<int>(threadIdx.x & 31) == __ffs(peers) - 1) {
    atomicAdd(counts + r, __popc(peers));
  }
}

__global__ void __launch_bounds__(kThreads)
fill_kernel(const int32_t* __restrict__ ids, const bool* __restrict__ mask,
            int64_t K, int* __restrict__ counts, const int* __restrict__ ptr,
            int32_t* __restrict__ idx, int64_t num_slots) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int r = slot_row(ids, mask, i, num_slots);
  const unsigned peers = __match_any_sync(0xffffffffu, r);
  const int lane = static_cast<int>(threadIdx.x & 31);
  const int leader = __ffs(peers) - 1;
  int left = 0;
  if (r >= 0 && lane == leader) left = atomicSub(counts + r, __popc(peers));
  left = __shfl_sync(0xffffffffu, left, leader);
  if (r >= 0) {
    const int rank = __popc(peers & ((1u << lane) - 1));
    idx[ptr[r] + left - 1 - rank] = static_cast<int32_t>(i / K);
  }
}

// the exclusive sum of x over the block's threads; total gets the block's sum
template <int kBlock>
__device__ __forceinline__ int block_exclusive_sum(int x, int& total) {
  constexpr int kWarps = kBlock / 32;
  __shared__ int warp_sums[kWarps + 1];
  const int lane = static_cast<int>(threadIdx.x & 31);
  const int warp = static_cast<int>(threadIdx.x >> 5);
  int incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int s = lane < kWarps ? warp_sums[lane] : 0;
    int si = s;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, si, o);
      if (lane >= o) si += y;
    }
    if (lane < kWarps) warp_sums[lane] = si - s;
    if (lane == 31) warp_sums[kWarps] = si;
  }
  __syncthreads();
  const int out = warp_sums[warp] + incl - x;
  total = warp_sums[kWarps];
  __syncthreads();  // the next call writes warp_sums again
  return out;
}

__global__ void __launch_bounds__(kThreads)
tile_sum_kernel(const int* __restrict__ counts, int* __restrict__ tile_sums,
                int64_t num_rows) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile +
                       static_cast<int64_t>(threadIdx.x) * kScanItems;
  int s = 0;
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    if (base + k < num_rows) s += counts[base + k];
  }
  int total;
  block_exclusive_sum<kThreads>(s, total);
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = total;
}

// one block: tile_sums becomes each tile's offset; *ptr_end the total
__global__ void __launch_bounds__(kScanThreads)
tile_scan_kernel(int* __restrict__ tile_sums, int64_t num_tiles,
                 int* __restrict__ ptr_end) {
  int carry = 0;
  for (int64_t b0 = 0; b0 < num_tiles; b0 += kScanThreads) {
    const int64_t b = b0 + threadIdx.x;
    const int x = b < num_tiles ? tile_sums[b] : 0;
    int total;
    const int ex = block_exclusive_sum<kScanThreads>(x, total);
    if (b < num_tiles) tile_sums[b] = carry + ex;
    carry += total;
  }
  if (threadIdx.x == 0) *ptr_end = carry;
}

// a row of n > kChunk slots: its chunks (row, j) and the row's first chunk
__device__ __forceinline__ void plan_row(int r, int n, Plan* __restrict__ plan,
                                         int2* __restrict__ chunks,
                                         int2* __restrict__ longs) {
  if (n <= kChunk) return;
  const int c = (n + kChunk - 1) / kChunk;
  const int first = atomicAdd(&plan->num_chunks, c);
  for (int j = 0; j < c; ++j) chunks[first + j] = make_int2(r, j);
  longs[atomicAdd(&plan->num_long, 1)] = make_int2(r, first);
}

__global__ void __launch_bounds__(kThreads)
ptr_kernel(const int* __restrict__ counts,
           const int* __restrict__ tile_offsets, int* __restrict__ ptr,
           int64_t num_rows, Plan* __restrict__ plan,
           int2* __restrict__ chunks, int2* __restrict__ longs) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile +
                       static_cast<int64_t>(threadIdx.x) * kScanItems;
  int c[kScanItems];
  int s = 0;
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    c[k] = base + k < num_rows ? counts[base + k] : 0;
    s += c[k];
  }
  int total;
  int run = tile_offsets[blockIdx.x] + block_exclusive_sum<kThreads>(s, total);
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    if (base + k < num_rows) {
      ptr[base + k] = run;
      plan_row(static_cast<int>(base + k), c[k], plan, chunks, longs);
      run += c[k];
    }
  }
}

// the second entry point's plan, from a given ptr
__global__ void __launch_bounds__(kThreads)
plan_kernel(const int* __restrict__ ptr, int64_t num_rows,
            Plan* __restrict__ plan, int2* __restrict__ chunks,
            int2* __restrict__ longs) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= num_rows) return;
  plan_row(static_cast<int>(r), ptr[r + 1] - ptr[r], plan, chunks, longs);
}

// -- stages 4-5: the sum --------------------------------------------------------

// the lanes of this thread's group of G inside its warp
template <int G>
__device__ __forceinline__ unsigned group_mask() {
  if constexpr (G == 32) {
    return 0xffffffffu;
  } else {
    const unsigned lane = threadIdx.x & 31;
    return ((1u << G) - 1) << (lane & ~static_cast<unsigned>(G - 1));
  }
}

template <typename O, int N>
__device__ __forceinline__ void store(Pack<O, N>* dst, const float (&a)[N]) {
  Pack<O, N> o;
#pragma unroll
  for (int e = 0; e < N; ++e) o.v[e] = from_float<O>(a[e]);
  *dst = o;
}

// dst[v] = the float32 sum of rows[idx[j]][v] over begin <= j < end (idx[j]
// >= 0), in ascending j, for the vectors v this lane owns
template <typename T, int N, int G, typename O>
__device__ __forceinline__ void sum_segment(
    const Pack<T, N>* __restrict__ rows, const int32_t* __restrict__ idx,
    int begin, int end, int lane, int row_vecs, Pack<O, N>* __restrict__ dst) {
  const unsigned gmask = group_mask<G>();
  for (int v0 = 0; v0 < row_vecs; v0 += G * kVecsPerLane) {
    float acc[kVecsPerLane][N] = {};
    for (int base = begin; base < end; base += G) {
      const int n = min(G, end - base);
      const int mine = lane < n ? __ldg(idx + base + lane) : -1;
      for (int k = 0; k < n; k += kUnroll) {
        int id[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int s = __shfl_sync(gmask, mine, (k + u) % G, G);
          id[u] = k + u < n ? s : -1;
        }
        Pack<T, N> p[kUnroll][kVecsPerLane];
        bool ok[kUnroll][kVecsPerLane];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
          for (int w = 0; w < kVecsPerLane; ++w) {
            const int v = v0 + w * G + lane;
            ok[u][w] = id[u] >= 0 && v < row_vecs;
            if (ok[u][w]) {
              p[u][w] = rows[static_cast<int64_t>(id[u]) * row_vecs + v];
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
          for (int w = 0; w < kVecsPerLane; ++w) {
            if (!ok[u][w]) continue;
#pragma unroll
            for (int e = 0; e < N; ++e) acc[w][e] += to_float(p[u][w].v[e]);
          }
        }
      }
    }
#pragma unroll
    for (int w = 0; w < kVecsPerLane; ++w) {
      const int v = v0 + w * G + lane;
      if (v < row_vecs) store<O, N>(dst + v, acc[w]);
    }
  }
}

// groups [0, max_chunks) take the long rows' chunks, into partials; groups
// [max_chunks, max_chunks + num_rows) the rows of up to kChunk slots
template <typename T, int N, int G>
__global__ void __launch_bounds__(kThreads)
sum_kernel(const Pack<T, N>* __restrict__ rows, const int* __restrict__ ptr,
           const int32_t* __restrict__ idx, const Plan* __restrict__ plan,
           const int2* __restrict__ chunks,
           Pack<float, N>* __restrict__ partials, Pack<T, N>* __restrict__ out,
           int64_t max_chunks, int64_t num_rows, int row_vecs) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t g = t / G;
  const int lane = static_cast<int>(t % G);
  if (g < max_chunks) {
    if (g >= plan->num_chunks) return;
    const int2 c = chunks[g];
    const int begin = ptr[c.x] + c.y * kChunk;
    const int end = begin + min(kChunk, ptr[c.x + 1] - begin);
    sum_segment<T, N, G, float>(rows, idx, begin, end, lane, row_vecs,
                                partials + g * row_vecs);
    return;
  }
  const int64_t r = g - max_chunks;
  if (r >= num_rows) return;
  const int begin = ptr[r], end = ptr[r + 1];
  if (end - begin > kChunk) return;  // its chunks' partials, folded below
  sum_segment<T, N, G, T>(rows, idx, begin, end, lane, row_vecs,
                          out + r * row_vecs);
}

template <typename T, int N, int G>
__global__ void __launch_bounds__(kThreads)
fold_kernel(const Pack<float, N>* __restrict__ partials,
            const int* __restrict__ ptr, const Plan* __restrict__ plan,
            const int2* __restrict__ longs, Pack<T, N>* __restrict__ out,
            int row_vecs) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t g = t / G;
  const int lane = static_cast<int>(t % G);
  if (g >= plan->num_long) return;
  const int2 l = longs[g];
  const int c = (ptr[l.x + 1] - ptr[l.x] + kChunk - 1) / kChunk;
  for (int v = lane; v < row_vecs; v += G) {
    float acc[N] = {};
    for (int j = 0; j < c; ++j) {
      const Pack<float, N> p =
          partials[static_cast<int64_t>(l.y + j) * row_vecs + v];
#pragma unroll
      for (int e = 0; e < N; ++e) acc[e] += p.v[e];
    }
    store<T, N>(out + static_cast<int64_t>(l.x) * row_vecs + v, acc);
  }
}

// -- host side ----------------------------------------------------------------

int64_t max_chunks(int64_t num_slots) {
  // rows of n > kChunk slots take ceil(n / kChunk) <= 2n / (kChunk + 1)
  return 2 * num_slots / (kChunk + 1);
}
int64_t max_long(int64_t num_slots) { return num_slots / (kChunk + 1); }
int64_t num_tiles(int64_t num_rows) { return (num_rows + kTile - 1) / kTile; }
int64_t align_up(int64_t x) { return (x + 255) / 256 * 256; }

// byte offsets into the workspace; csr: the first entry point's stages 1-3
struct Layout {
  int64_t plan, counts, chunks, longs, partials, ptr, idx, tiles, total;
};

Layout layout(int64_t num_rows, int64_t num_slots, int64_t width, bool csr) {
  Layout l{};
  int64_t off = 0;
  l.plan = off;
  off += sizeof(Plan);
  l.counts = off;  // right after the plan: one memset clears both
  off = align_up(off + (csr ? 4 * num_rows : 0));
  l.chunks = off;
  off = align_up(off + 8 * max_chunks(num_slots));
  l.longs = off;
  off = align_up(off + 8 * max_long(num_slots));
  l.partials = off;
  off = align_up(off + 4 * width * max_chunks(num_slots));
  if (csr) {
    l.ptr = off;
    off = align_up(off + 4 * (num_rows + 1));
    l.idx = off;
    off = align_up(off + 4 * num_slots);
    l.tiles = off;
    off = align_up(off + 4 * num_tiles(num_rows));
  }
  l.total = off;
  return l;
}

unsigned int blocks_for(int64_t threads) {
  return static_cast<unsigned int>((threads + kThreads - 1) / kThreads);
}

struct SumArgs {
  const void* rows;
  const int* ptr;
  const int32_t* idx;
  const Plan* plan;
  const int2* chunks;
  const int2* longs;
  float* partials;
  void* out;
  int64_t num_rows, num_slots, width;
};

template <typename T, int N, int G>
void launch_sum(const SumArgs& a, cudaStream_t s) {
  const int row_vecs = static_cast<int>(a.width / N);
  const int64_t chunks = max_chunks(a.num_slots);
  sum_kernel<T, N, G><<<blocks_for((chunks + a.num_rows) * G), kThreads, 0,
                        s>>>(
      static_cast<const Pack<T, N>*>(a.rows), a.ptr, a.idx, a.plan, a.chunks,
      reinterpret_cast<Pack<float, N>*>(a.partials),
      static_cast<Pack<T, N>*>(a.out), chunks, a.num_rows, row_vecs);
  const int64_t longs = max_long(a.num_slots);
  if (longs > 0) {
    fold_kernel<T, N, G><<<blocks_for(longs * G), kThreads, 0, s>>>(
        reinterpret_cast<const Pack<float, N>*>(a.partials), a.ptr, a.plan,
        a.longs, static_cast<Pack<T, N>*>(a.out), row_vecs);
  }
}

template <typename T, int N>
void launch_group(const SumArgs& a, cudaStream_t s) {
  // the smallest group whose threads cover the row at kVecsPerLane each
  const int64_t row_vecs = a.width / N;
  if (row_vecs <= 1 * kVecsPerLane) {
    launch_sum<T, N, 1>(a, s);
  } else if (row_vecs <= 2 * kVecsPerLane) {
    launch_sum<T, N, 2>(a, s);
  } else if (row_vecs <= 4 * kVecsPerLane) {
    launch_sum<T, N, 4>(a, s);
  } else if (row_vecs <= 8 * kVecsPerLane) {
    launch_sum<T, N, 8>(a, s);
  } else if (row_vecs <= 16 * kVecsPerLane) {
    launch_sum<T, N, 16>(a, s);
  } else {
    launch_sum<T, N, 32>(a, s);
  }
}

template <typename T>
void launch_type(const SumArgs& a, cudaStream_t s) {
  const int64_t row_bytes = a.width * static_cast<int64_t>(sizeof(T));
  const uintptr_t align = reinterpret_cast<uintptr_t>(a.rows) |
                          reinterpret_cast<uintptr_t>(a.out) |
                          static_cast<uintptr_t>(row_bytes);
  if (align % 16 == 0) {
    launch_group<T, 16 / sizeof(T)>(a, s);
  } else if (align % 8 == 0) {
    launch_group<T, 8 / sizeof(T)>(a, s);
  } else {
    launch_group<T, 1>(a, s);
  }
}

int sum_stages(const SumArgs& a, int dtype, cudaStream_t s) {
  if (dtype == 0) {
    launch_type<float>(a, s);
  } else {
    launch_type<__nv_bfloat16>(a, s);
  }
  return static_cast<int>(cudaGetLastError());
}

bool bad_size(int64_t num_rows, int64_t num_slots, int64_t width, int dtype) {
  constexpr int64_t kMax = (int64_t{1} << 31) - 1;
  return num_rows <= 0 || num_rows >= kMax || num_slots < 0 ||
         num_slots >= kMax || width <= 0 || width >= kMax ||
         (dtype != 0 && dtype != 1);
}

}  // namespace

// Bytes of workspace the entry points below need: csr 1 for
// fgnn_scatter_add_rows, 0 for fgnn_scatter_add_rows_by_ptr.
extern "C" int64_t fgnn_scatter_add_rows_workspace(int64_t num_rows,
                                                   int64_t num_slots,
                                                   int64_t width, int csr) {
  return layout(num_rows, num_slots, width, csr != 0).total;
}

// grad_out [num_dst, width] of dtype 0 float32 or 1 bfloat16; ids and mask
// (or null) [num_dst * K], every id in [-1, num_rows); out [num_rows, width]
// of grad_out's dtype, every row written; workspace of
// fgnn_scatter_add_rows_workspace(num_rows, num_dst * K, width, 1) bytes,
// 256-byte aligned. Returns the cudaError_t of the launches.
extern "C" int fgnn_scatter_add_rows(const void* grad_out, const int32_t* ids,
                                     const bool* mask, void* out,
                                     void* workspace, int64_t num_dst,
                                     int64_t K, int64_t num_rows,
                                     int64_t width, int dtype, void* stream) {
  if (num_dst < 0 || K <= 0 || num_dst > (int64_t{1} << 31) / K ||
      bad_size(num_rows, num_dst * K, width, dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t num_slots = num_dst * K;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout l = layout(num_rows, num_slots, width, true);
  char* ws = static_cast<char*>(workspace);
  Plan* plan = reinterpret_cast<Plan*>(ws + l.plan);
  int* counts = reinterpret_cast<int*>(ws + l.counts);
  int* ptr = reinterpret_cast<int*>(ws + l.ptr);
  int32_t* idx = reinterpret_cast<int32_t*>(ws + l.idx);
  int* tiles = reinterpret_cast<int*>(ws + l.tiles);
  int2* chunks = reinterpret_cast<int2*>(ws + l.chunks);
  int2* longs = reinterpret_cast<int2*>(ws + l.longs);
  cudaError_t err = cudaMemsetAsync(ws, 0, l.counts + 4 * num_rows, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_slots > 0) {
    count_kernel<<<blocks_for(num_slots), kThreads, 0, s>>>(ids, mask, counts,
                                                            num_slots);
  }
  const int64_t n_tiles = num_tiles(num_rows);
  tile_sum_kernel<<<static_cast<unsigned int>(n_tiles), kThreads, 0, s>>>(
      counts, tiles, num_rows);
  tile_scan_kernel<<<1, kScanThreads, 0, s>>>(tiles, n_tiles, ptr + num_rows);
  ptr_kernel<<<static_cast<unsigned int>(n_tiles), kThreads, 0, s>>>(
      counts, tiles, ptr, num_rows, plan, chunks, longs);
  if (num_slots > 0) {
    fill_kernel<<<blocks_for(num_slots), kThreads, 0, s>>>(
        ids, mask, K, counts, ptr, idx, num_slots);
  }
  const SumArgs a{grad_out, ptr, idx, plan, chunks, longs,
                  reinterpret_cast<float*>(ws + l.partials), out,
                  num_rows, num_slots, width};
  return sum_stages(a, dtype, s);
}

// The sum of stages 4-5 on a given CSR: out[r] = the float32 sum of
// grad_out[idx[j]] over ptr[r] <= j < ptr[r+1] (idx[j] >= 0), in ascending
// j (a row of more than 128 entries in chunks of 128, folded in order).
// ptr [num_rows + 1] int32, nondecreasing from 0 to at most num_slots; idx
// [num_slots] int32, every entry in [-1, rows of grad_out); workspace of
// fgnn_scatter_add_rows_workspace(num_rows, num_slots, width, 0) bytes.
extern "C" int fgnn_scatter_add_rows_by_ptr(const void* grad_out,
                                            const int32_t* ptr,
                                            const int32_t* idx, void* out,
                                            void* workspace, int64_t num_rows,
                                            int64_t num_slots, int64_t width,
                                            int dtype, void* stream) {
  if (bad_size(num_rows, num_slots, width, dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout l = layout(num_rows, num_slots, width, false);
  char* ws = static_cast<char*>(workspace);
  Plan* plan = reinterpret_cast<Plan*>(ws + l.plan);
  int2* chunks = reinterpret_cast<int2*>(ws + l.chunks);
  int2* longs = reinterpret_cast<int2*>(ws + l.longs);
  cudaError_t err = cudaMemsetAsync(plan, 0, sizeof(Plan), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  plan_kernel<<<blocks_for(num_rows), kThreads, 0, s>>>(ptr, num_rows, plan,
                                                        chunks, longs);
  const SumArgs a{grad_out, ptr, idx, plan, chunks, longs,
                  reinterpret_cast<float*>(ws + l.partials), out,
                  num_rows, num_slots, width};
  return sum_stages(a, dtype, s);
}
