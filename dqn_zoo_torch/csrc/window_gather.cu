// K1: replay window gather.
//
// Replaces the TPU kernel `gather_windows_pallas` / `_window_kernel` in
// dqn_zoo_tpu/replay/window_gather.py (per-sample async DMAs, 16 in flight
// per program, over (64, 128)-padded rows).
//
// out[b, w] = frames[stream[b], start[b] + w] for w < W, one 84x84 uint8 row
// each. Rows are stored unpadded: 7056 bytes = 441 x 16 bytes, so every row
// and every window is 16-byte aligned and a window of W rows is one
// contiguous run of W * 7056 bytes in both the frame store and the output.
// Indices follow lax.dynamic_slice: a negative index counts from the end,
// then the window is clamped into range. They are read at the width the
// caller gives (int64 on the replay's sample path, or int32), so a call is
// one launch and no conversion.
//
// Bound on the H100: bytes, 2 * B * W * 7056 moved (36.1 MB each way at
// B = 1024, W = 5) plus the index bytes, no arithmetic.
//
// Design: Hopper's bulk asynchronous copy (`cp.async.bulk`, the 1-D form of
// the TMA, which needs no tensor map) in both directions, the counterpart of
// the TPU kernel's DMAs in flight. Each window is cut into equal pieces of at
// most 40 KB (one piece of 35,280 bytes at W = 5), and each block, one per
// SM, walks a contiguous run of pieces through a ring of 5 piece buffers in
// shared memory with one mbarrier each: one thread issues every copy, a
// load completes on its buffer's mbarrier (expect_tx), the store from that
// buffer follows as a bulk group, and the buffer is loaded again once that
// store has read it, with up to 2 stores still reading. So 2-3 windows
// (70-105 KB) are loading per SM while 2 are being stored. The block's 32
// lanes first turn its windows' indices into source rows. Whole windows are
// fewer copies than rows, and a ring of rows (24 x 7056 bytes) measured no
// faster; at these sizes the kernel moves data at about the rate of
// `index_select` on precomputed rows, which sets the pace of both.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSlots = 5;            // piece buffers per block
constexpr int kLag = 2;              // stores in flight per block
constexpr int kMaxPiece = 40960;     // bytes
constexpr int kMaxDevices = 64;
constexpr int kWinPerBlock = 256;    // most windows one block spans

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t n) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(n) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t n, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(n), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t n) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(dst), "r"(smem_addr(src)), "r"(n) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

template <typename Index>
__global__ void __launch_bounds__(32, 1)
gather_windows_kernel(const uint8_t* __restrict__ frames,
                      const Index* __restrict__ stream,
                      const Index* __restrict__ start,
                      uint8_t* __restrict__ out, long long items,
                      int num_streams, int rows_per_stream, int window,
                      int row_bytes, int npieces, int piece) {
  extern __shared__ __align__(128) uint8_t ring[];  // [kSlots][piece]
  __shared__ uint64_t bars[kSlots];
  __shared__ long long src_row[kWinPerBlock];
  const int lane = threadIdx.x;
  const long long i0 = items * blockIdx.x / gridDim.x;
  const long long i1 = items * (blockIdx.x + 1) / gridDim.x;
  if (i1 <= i0) return;
  if (lane == 0) {
    for (int k = 0; k < kSlots; ++k) mbar_init(&bars[k]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const long long b0 = i0 / npieces;
  const int nwin = (int)((i1 - 1) / npieces - b0 + 1);
  for (int k = lane; k < nwin; k += 32) {
    long long st = stream[b0 + k], s0 = start[b0 + k];
    if (st < 0) st += num_streams;
    if (s0 < 0) s0 += rows_per_stream;
    st = min(max(st, 0LL), (long long)num_streams - 1);
    s0 = min(max(s0, 0LL), (long long)(rows_per_stream - window));
    src_row[k] = st * rows_per_stream + s0;
  }
  __syncwarp();
  if (lane != 0) return;

  const long long win = (long long)window * row_bytes;
  auto place = [&](long long i, const uint8_t** src, uint8_t** dst) {
    const long long b = i / npieces;
    const long long off = (i - b * npieces) * (long long)piece;
    if (src) *src = frames + src_row[b - b0] * row_bytes + off;
    if (dst) *dst = out + b * win + off;
    return (uint32_t)min((long long)piece, win - off);
  };
  auto load = [&](long long k) {
    const int slot = (int)(k % kSlots);
    const uint8_t* src;
    const uint32_t n = place(i0 + k, &src, nullptr);
    mbar_expect_tx(&bars[slot], n);
    bulk_load(ring + (long long)slot * piece, src, n, &bars[slot]);
  };

  const long long n = i1 - i0;
  for (long long k = 0; k < n && k < kSlots; ++k) load(k);
  for (long long k = 0; k < n; ++k) {
    const int slot = (int)(k % kSlots);
    mbar_wait(&bars[slot], (uint32_t)((k / kSlots) & 1));
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    uint8_t* dst;
    const uint32_t bytes = place(i0 + k, nullptr, &dst);
    bulk_store(dst, ring + (long long)slot * piece, bytes);
    // The buffer of the piece kLag before is free once its store has read
    // it (kLag stores may still be reading).
    if (k >= kLag && k - kLag + kSlots < n) {
      asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(kLag)
                   : "memory");
      load(k - kLag + kSlots);
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <typename Index>
cudaError_t launch(const void* frames, const void* stream, const void* start,
                   void* out, int batch, int num_streams,
                   int rows_per_stream, int window, int row_bytes,
                   cudaStream_t st) {
  const long long win = (long long)window * row_bytes;
  const int npieces = (int)((win + kMaxPiece - 1) / kMaxPiece);
  const int piece = (int)(((win + npieces - 1) / npieces + 15) / 16 * 16);
  if ((long long)(npieces - 1) * piece >= win) return cudaErrorInvalidValue;
  // Per device, once: the shared-memory limit for the largest ring, and the
  // number of SMs.
  static int sm_count[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (sm_count[dev] == 0) {
    err = cudaFuncSetAttribute(gather_windows_kernel<Index>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSlots * kMaxPiece);
    if (err != cudaSuccess) return err;
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    sm_count[dev] = sms;
  }
  // One block per SM, and enough blocks that none spans more than
  // kWinPerBlock windows.
  const long long items = (long long)batch * npieces;
  long long grid = sm_count[dev];
  if (grid > items) grid = items;
  const long long per_block = (long long)npieces * (kWinPerBlock - 1);
  if (grid < (items + per_block - 1) / per_block)
    grid = (items + per_block - 1) / per_block;
  gather_windows_kernel<Index><<<(unsigned)grid, 32, kSlots * piece, st>>>(
      (const uint8_t*)frames, (const Index*)stream, (const Index*)start,
      (uint8_t*)out, items, num_streams, rows_per_stream, window, row_bytes,
      npieces, piece);
  return cudaGetLastError();
}

}  // namespace

// frames (num_streams, rows_per_stream, row_bytes) uint8, 16-byte aligned;
// stream, start (batch,) of index_bytes 8 (int64) or 4 (int32) each;
// out (batch, window, row_bytes). Returns cudaGetLastError().
extern "C" int dz_gather_windows(const void* frames, const void* stream,
                                 const void* start, void* out, int batch,
                                 int num_streams, int rows_per_stream,
                                 int window, int row_bytes, int index_bytes,
                                 void* cuda_stream) {
  if (row_bytes % 16 != 0 || (index_bytes != 4 && index_bytes != 8))
    return (int)cudaErrorInvalidValue;
  if (batch <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)cuda_stream;
  return (int)(index_bytes == 8
                   ? launch<int64_t>(frames, stream, start, out, batch,
                                     num_streams, rows_per_stream, window,
                                     row_bytes, st)
                   : launch<int32_t>(frames, stream, start, out, batch,
                                     num_streams, rows_per_stream, window,
                                     row_bytes, st));
}
