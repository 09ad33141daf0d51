// Streaming pass for Hopper (sm_90a): out = x + 1 over a contiguous float32
// array, moved by 1-D TMA bulk copies through a shared-memory ring on a
// persistent grid.
//
// Replaces K3, the TPU's inline Pallas copy_kernel in
// tools/gather_campaign.py::stream_campaign (copy_kernel :121, pallas_call
// :129): o = x + 1.0 over [N, 128] float32, one grid step per chunk of
// 512 / 2048 / 8192 rows, moved HBM -> VMEM -> HBM by the Pallas pipeline.
// It measures the card's contiguous copy ceiling, against which the row
// gather is judged.
//
// What bounds it: bytes, 4 read and 4 written per element, with one add.
// The design keeps many bytes in flight on every SM, spends no thread on
// addresses, and lets no SM wait for another:
//   * persistent grid: G = SMs x the CTAs per SM that the ring's shared
//     memory allows (one on an H100: 132 CTAs), both queried once per
//     device; never more CTAs than tiles. The unit of work is a 16 KB stage
//     tile;
//   * tiles are dealt at run time: the CTA's thread 0 takes the next tile
//     index from a global ticket (atomicAdd) each time it fills a stage, so
//     the G CTAs walk one contiguous window in tile order, as PyTorch's
//     elementwise kernel does, and a CTA on a faster SM takes more tiles.
//     The SMs of an H100 do not stream at one rate: dealt this way the
//     132 CTAs took 54 to 86 tiles of 32 KB each (mean 62), so a fixed
//     deal (CTA b taking tiles b, b + G, ...) ends with the slowest SM and
//     measured 4-5% slower. The last CTA to finish rewinds the ticket;
//     the host keeps two launches from overlapping;
//   * each CTA owns a ring of 12 stages in dynamic shared memory (192 KB),
//     each stage with a "full" mbarrier. Thread 0 keeps 11 loads in
//     flight: mbarrier.arrive.expect_tx with the tile's exact byte count,
//     then cp.async.bulk global -> shared completing on that barrier (a
//     plain arrive marks the end). The 256 threads wait on the stage's
//     parity (flipped at each wrap of the ring), add 1.0 in shared memory
//     a float4 at a time, fence.proxy.async and meet at a CTA barrier;
//     thread 0 stores the stage with cp.async.bulk shared -> global in a
//     bulk group, then, once cp.async.bulk.wait_group.read says the
//     previous tile's store has read its stage, refills that stage. 28
//     registers a thread, no spill (ptxas -v, sm_90a). Adding in registers
//     and storing with st.global.v4 instead, other tile x depth (8-64 KB x
//     3-24) and evict-first L2 hints measured equal or slower;
//   * the chunk no longer sets the grid. On the TPU it only sized the VMEM
//     double buffer; here one 512-row chunk (256 KB) is already larger
//     than a CTA's 227 KB of shared memory, and a block per chunk fixed
//     the grid at 1,024 / 256 / 64 blocks for chunks 512 / 2048 / 8192,
//     leaving ragged waves or, at 8192, 68 of 132 SMs idle. chunk_elems is
//     checked and sets nothing;
//   * edges: cp.async.bulk needs 16-byte aligned addresses and sizes. A
//     scalar head up to x's first 16-byte boundary and a scalar tail of
//     the last under-16-byte remainder are moved once for the whole array,
//     by CTA 0; the last tile is partial and expects its real byte count.
//     When x and out are misaligned against each other the host picks an
//     all-scalar kernel, a correctness path. Offsets are 64-bit.
// It launches on the caller's stream, allocates nothing, and returns the
// error of the shared-memory attribute, the occupancy query, the event or
// the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kThreads = 256;
constexpr int kTileBytes = 16 * 1024;
constexpr int kStages = 12;
constexpr int kMaxDevices = 64;

// The ring's dynamic shared memory: the stages, then one mbarrier each.
constexpr int kSmemBytes = (kTileBytes + 8) * kStages;

// Elements before x's first 16-byte boundary, bulk body bytes, and the
// first element of the under-16-byte tail.
struct Split {
  int64_t head;
  int64_t body;
  int64_t tail;
};

__host__ __device__ inline Split split(uintptr_t x, int64_t n) {
  const int64_t mis = static_cast<int64_t>((x & 15) >> 2);
  int64_t head = mis ? 4 - mis : 0;
  if (head > n) head = n;
  const int64_t body = ((n - head) >> 2) << 4;
  return {head, body, head + (body >> 2)};
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// One tile global -> shared, completing on bar with its byte count.
__device__ __forceinline__ void load_tile(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// One tile shared -> global as its own bulk group.
__device__ __forceinline__ void store_tile(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               :: "l"(dst), "r"(src), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// The running launch's next tile and its finished CTAs. The last CTA to
// finish rewinds both, so every launch starts from zero; the host keeps
// two launches from overlapping (fgnn_stream_add_one).
__device__ unsigned long long g_ticket;
__device__ unsigned int g_done;

__global__ void __launch_bounds__(kThreads)
stream_add_one_bulk(const float* __restrict__ x, float* __restrict__ out,
                    int64_t n) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int64_t stage_tile[kStages];  // the tile each stage holds
  const int tid = threadIdx.x;
  const Split sp = split(reinterpret_cast<uintptr_t>(x), n);
  if (blockIdx.x == 0) {
    for (int64_t i = tid; i < sp.head; i += kThreads) out[i] = x[i] + 1.0f;
    for (int64_t i = sp.tail + tid; i < n; i += kThreads) out[i] = x[i] + 1.0f;
  }
  const int64_t tiles = (sp.body + kTileBytes - 1) / kTileBytes;
  if (tiles == 0) return;
  const char* src = reinterpret_cast<const char*>(x + sp.head);
  char* dst = reinterpret_cast<char*>(out + sp.head);
  const uint32_t ring = smem_u32(smem);
  const uint32_t bars = ring + kTileBytes * kStages;
  // only the array's last tile is short
  auto bytes = [&](int64_t t) {
    const int64_t left = sp.body - t * kTileBytes;
    return static_cast<uint32_t>(left < kTileBytes ? left : kTileBytes);
  };
  // thread 0: load the next tile into stage s, or mark the end there
  auto fill = [&](uint32_t s) {
    const auto t = static_cast<int64_t>(atomicAdd(&g_ticket, 1ull));
    stage_tile[s] = t;
    const uint32_t bar = bars + 8 * s;
    if (t >= tiles) {
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
                   :: "r"(bar) : "memory");
      return false;
    }
    load_tile(ring + s * kTileBytes, src + t * kTileBytes, bytes(t), bar);
    return true;
  };

  bool more = true;  // thread 0: the end is not in the ring yet
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                   :: "r"(bars + 8 * s), "r"(1) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (uint32_t s = 0; s + 1 < kStages && more; ++s) more = fill(s);
  }
  __syncthreads();

  uint32_t s = 0;
  uint32_t parity = 0;
  for (;;) {
    mbar_wait(bars + 8 * s, parity);
    const int64_t t = stage_tile[s];
    if (t >= tiles) break;
    const uint32_t nbytes = bytes(t);
    float4* v = reinterpret_cast<float4*>(smem + s * kTileBytes);
    const int nvec = static_cast<int>(nbytes >> 4);
#pragma unroll 4
    for (int k = tid; k < nvec; k += kThreads) {
      float4 a = v[k];
      a.x += 1.0f; a.y += 1.0f; a.z += 1.0f; a.w += 1.0f;
      v[k] = a;
    }
    // the generic-proxy writes above, seen by the bulk store's async proxy
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (tid == 0) {
      store_tile(dst + t * kTileBytes, ring + s * kTileBytes, nbytes);
      if (more) {
        // the stage to refill held the previous tile: its store must have
        // read it
        asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
        more = fill((s + kStages - 1) % kStages);
      }
    }
    if (++s == kStages) {
      s = 0;
      parity ^= 1;
    }
  }
  if (tid == 0) {
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
    __threadfence();
    if (atomicAdd(&g_done, 1u) == gridDim.x - 1) {  // every ticket is taken
      g_ticket = 0;
      g_done = 0;
    }
  }
}

// x and out misaligned against each other: no common 16-byte grid.
__global__ void __launch_bounds__(kThreads)
stream_add_one_scalar(const float* __restrict__ x, float* __restrict__ out,
                      int64_t n) {
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += step) {
    out[i] = __ldg(x + i) + 1.0f;
  }
}


// One device's SMs and ring CTAs per SM, queried once, and its last bulk
// launch: launches share the ticket, so one made on another stream first
// waits for the last one's event.
struct Device {
  int sms = 0;
  int ctas_per_sm = 0;
  cudaEvent_t done = nullptr;
  cudaStream_t last = nullptr;
  bool launched = false;
};

std::mutex g_mu;  // guards g_devices and keeps a wait, launch, record whole
Device g_devices[kMaxDevices];

// The current device's entry, set up at first use. Call with g_mu held.
cudaError_t current_device(Device** out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  Device& d = g_devices[dev];
  if (d.ctas_per_sm == 0) {
    int sms = 0;
    int ctas = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(stream_add_one_bulk,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &ctas, stream_add_one_bulk, kThreads, kSmemBytes);
    if (err != cudaSuccess) return err;
    if (sms < 1 || ctas < 1) return cudaErrorInvalidConfiguration;
    if (d.done == nullptr) {
      err = cudaEventCreateWithFlags(&d.done, cudaEventDisableTiming);
      if (err != cudaSuccess) return err;
    }
    d.sms = sms;
    d.ctas_per_sm = ctas;
  }
  *out = &d;
  return cudaSuccess;
}

int64_t bulk_tiles(uintptr_t x, int64_t n) {
  return (split(x, n).body + kTileBytes - 1) / kTileBytes;
}

int64_t clamp_grid(int64_t want, const Device& d) {
  const int64_t slots = static_cast<int64_t>(d.sms) * d.ctas_per_sm;
  return want < 1 ? 1 : (want < slots ? want : slots);
}

}  // namespace

// Returns the cudaError_t of the set-up or the launch (0 on success).
// n > 0 elements; 0 < chunk_elems < 2^31 (checked, sets nothing).
extern "C" int fgnn_stream_add_one(const float* x, float* out, int64_t n,
                                   int64_t chunk_elems, void* stream) {
  if (n <= 0 || chunk_elems <= 0 || chunk_elems >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  std::lock_guard<std::mutex> lock(g_mu);
  Device* d = nullptr;
  cudaError_t err = current_device(&d);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  if (((xa ^ reinterpret_cast<uintptr_t>(out)) & 15) != 0) {
    const auto grid = static_cast<unsigned int>(
        clamp_grid((n + kThreads - 1) / kThreads, *d));
    stream_add_one_scalar<<<grid, kThreads, 0, s>>>(x, out, n);
    return static_cast<int>(cudaGetLastError());
  }
  if (d->launched && s != d->last) {
    err = cudaStreamWaitEvent(s, d->done, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const auto grid = static_cast<unsigned int>(clamp_grid(bulk_tiles(xa, n), *d));
  stream_add_one_bulk<<<grid, kThreads, kSmemBytes, s>>>(
      x, out, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaEventRecord(d->done, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  d->last = s;
  d->launched = true;
  return 0;
}

// The launch fgnn_stream_add_one makes for n elements from a 16-byte
// aligned x on the current device: cfg = {grid, tiles, tile bytes, ring
// stages, CTAs per SM, SMs}. Returns the cudaError_t of the device query.
extern "C" int fgnn_stream_add_one_config(int64_t n, int64_t* cfg) {
  std::lock_guard<std::mutex> lock(g_mu);
  Device* d = nullptr;
  cudaError_t err = current_device(&d);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tiles = bulk_tiles(0, n);
  cfg[0] = clamp_grid(tiles, *d);
  cfg[1] = tiles;
  cfg[2] = kTileBytes;
  cfg[3] = kStages;
  cfg[4] = d->ctas_per_sm;
  cfg[5] = d->sms;
  return 0;
}
