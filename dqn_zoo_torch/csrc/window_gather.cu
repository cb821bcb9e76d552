// K1: replay window gather.
//
// Replaces the TPU kernel `gather_windows_pallas` / `_window_kernel` in
// dqn_zoo_tpu/replay/window_gather.py (per-sample async DMAs, 16 in flight
// per program, over (64, 128)-padded rows).
//
// out[b, w] = frames[stream[b], start[b] + w] for w < W, one 84x84 uint8 row
// each. Rows are stored unpadded: 7056 bytes = 441 x 16 bytes, so every row
// and every window is 16-byte aligned and a window of W rows is one
// contiguous run of W * 441 uint4 in both the frame store and the output.
//
// Bound on the H100: pure data movement, B*W*7056 bytes read and the same
// written (36.1 MB each way at B = 1024, W = 5), no arithmetic. The design
// does the least a copy can: one block per sample loads its own two indices
// (the TPU's scalar prefetch), then its threads stream the contiguous window
// with 16-byte read-only loads and 16-byte stores, neighbouring threads on
// neighbouring addresses. Indices follow lax.dynamic_slice: a negative
// index counts from the end, then the window is clamped into range.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void gather_windows_kernel(const uint4* __restrict__ frames,
                                      const int32_t* __restrict__ stream,
                                      const int32_t* __restrict__ start,
                                      uint4* __restrict__ out,
                                      int num_streams, int rows_per_stream,
                                      int window, int row_vec) {
  const int b = blockIdx.x;
  int st = stream[b];
  int s0 = start[b];
  if (st < 0) st += num_streams;
  if (s0 < 0) s0 += rows_per_stream;
  st = min(max(st, 0), num_streams - 1);
  s0 = min(max(s0, 0), rows_per_stream - window);
  const long long n = (long long)window * row_vec;
  const uint4* src =
      frames + ((long long)st * rows_per_stream + s0) * row_vec;
  uint4* dst = out + (long long)b * n;
  for (long long i = threadIdx.x; i < n; i += kThreads) {
    dst[i] = __ldg(src + i);
  }
}

}  // namespace

extern "C" int dz_gather_windows(const void* frames, const void* stream,
                                 const void* start, void* out, int batch,
                                 int num_streams, int rows_per_stream,
                                 int window, int row_bytes,
                                 void* cuda_stream) {
  if (row_bytes % 16 != 0) return (int)cudaErrorInvalidValue;
  if (batch > 0) {
    gather_windows_kernel<<<batch, kThreads, 0, (cudaStream_t)cuda_stream>>>(
        (const uint4*)frames, (const int32_t*)stream, (const int32_t*)start,
        (uint4*)out, num_streams, rows_per_stream, window, row_bytes / 16);
  }
  return (int)cudaGetLastError();
}
