// K2: pooled raw frames -> 84x84 observation.
//
// Replaces the TPU kernel `pooled_frame_to_84_pallas` / `_kernel` in
// dqn_zoo_tpu/prep/pallas_prep.py.
//
// out[b] = clip(rint(Ry . Y . Cx^T), 0, 255) with
//   Y  = min(floor(luma(max(f1[b], f2[b]))), 255)   (210 x 160, uint8 values)
//   Ry = (84, 210), Cx = (84, 160) antialiased linear resize matrices.
//
// Bound on the H100: bytes. Two (210, 160, 3) uint8 frames are read per env
// (201,600 bytes) for 7,056 bytes written; the separable resize touches only
// the band of each weight row (4-5 taps of Ry, 3-4 of Cx), so the arithmetic
// is about 0.25 MFLOP per env, far below what the reads take.
//
// Design: a grid of (bands, envs). Each env's 84 output rows are cut into
// bands of `band_rows` rows (6 on the main path: 14 bands, so 1,792 blocks
// at B = 128 and 56 at B = 4, where one block per env gave 128 and 4). A
// band needs only the input rows its rows' Ry taps reach (at most 17 of
// 210 at 6 rows; 1.12 x the frame read over all bands, the overlap from
// L2), and those rows are one contiguous run of rows x 480 bytes of each
// HWC frame: one thread loads both runs into shared memory with two bulk
// asynchronous copies (`cp.async.bulk`, the 1-D TMA) completing on one
// mbarrier. Then three passes with a block barrier between them: pool and
// luma of 4 pixels a thread (per-byte max of 12 bytes of each frame, luma
// in explicitly rounded multiplies and adds, so that it is the plain
// version's f32 arithmetic bit for bit, stored as f32); the vertical sums
// of the band's rows, 4 columns a thread; the horizontal sums and rounding
// (half to even like torch.round). Each sum is an fmaf chain from 0 over
// its taps in ascending input order, as the one-block-per-env kernel before
// this one summed them, so the output is bit-identical to that kernel's.
// No pass takes a conversion instruction (the conversion pipe, 16 results a
// clock per SM, set the pace when luma converted each byte): bytes become
// floats and floats integers by exact additions of 2^23 (see byte_float).
// The taps come from the wrapper's plan (prep/cuda_prep.band_plan): each
// band's first input row and row count, then a record of each output row's
// and column's first tap, tap count and weights. A block loads the records
// its passes read while its copies run and stages them in shared memory,
// so that no pass waits on a global load. Shared memory is 1,600 bytes an
// input row (27,200 at 6 output rows): under 48 KB, so the launch needs no
// attribute (bands of 12 rows or more take the opt-in, once per device and
// size). On an H100 at B = 128 the bulk copies alone take 0.0101 ms of the
// kernel's 0.0127 (tools/torch_kernel_variants.py k2).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kH = 210, kW = 160, kOut = 84;
constexpr int kRowBytes = kW * 3;                       // 480
constexpr long long kFrameBytes = (long long)kH * kRowBytes;
// A tap record of an output row (Ry) or column (Cx): its first input row or
// column, its tap count, and kTaps weights (f32 bits; Ry has 4-5 taps, Cx
// 3-4). The plan holds the bands' spans, then Ry's 84 records, then Cx's.
constexpr int kTaps = 5;
constexpr int kRec = 2 + kTaps;
constexpr int kStage = 3;  // plan words a thread stages
constexpr int kSmemDefault = 48 * 1024;  // a block's without the opt-in
constexpr int kSmemLimit = 200 * 1024;   // and the most this takes with it
constexpr int kMaxDevices = 64;
constexpr int kMaxBatch = 65535;  // grid.y

__host__ __device__ constexpr int smem_bytes(int max_rows) {
  // Both frames' rows, then their luma (f32); the band's vertical sums (f32,
  // band_rows x kW) take the first frame's rows once luma is done.
  return 2 * max_rows * kRowBytes + max_rows * kW * 4;
}

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

// Conversions run on the conversion pipe (16 results a clock per SM), and
// luma would take five a pixel: these exact float tricks use the FP32 and
// integer pipes instead. 2^23 + v is a float for an integer v in [0, 2^23),
// with v in its low mantissa bits.
constexpr float kTwo23 = 8388608.0f;

// Byte j of w as a float, exactly: 0x4B0000vv is 2^23 + v.
__device__ __forceinline__ float byte_float(uint32_t w, int j) {
  return __fsub_rn(__uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440 | j)),
                   kTwo23);
}

// min(floor(luma), 255) of one pixel, as a float. Rounding 2^23 + y down
// takes floor(y) for 0 <= y < 2^23.
__device__ __forceinline__ float luma(float r, float g, float b) {
  const float w0 = (float)0.299, w1 = (float)0.587,
              w2 = (float)(1.0 - (0.299 + 0.587));
  const float y = __fadd_rn(__fadd_rn(__fmul_rn(r, w0), __fmul_rn(g, w1)),
                            __fmul_rn(b, w2));
  return fminf(__fsub_rn(__fadd_rd(y, kTwo23), kTwo23), 255.0f);
}

// plan (int32): bands x {first input row, row count}, then kOut tap
// records of Ry's rows, then kOut of Cx's rows.
__global__ void __launch_bounds__(kThreads)
pooled_frame_to_84_kernel(const uint8_t* __restrict__ f1,
                          const uint8_t* __restrict__ f2,
                          const int32_t* __restrict__ plan,
                          uint8_t* __restrict__ out, int band_rows,
                          int max_rows) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ uint64_t bar;
  const int band = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int y0 = __ldg(plan + 2 * band), rows = __ldg(plan + 2 * band + 1);
  uint8_t* raw1 = smem;
  uint8_t* raw2 = smem + max_rows * kRowBytes;
  float* ys = reinterpret_cast<float*>(smem + 2 * max_rows * kRowBytes);
  // Once luma is done: the band's vertical sums over the first frame's rows,
  // its tap records over the second's.
  float* vsum = reinterpret_cast<float*>(raw1);
  int32_t* taps = reinterpret_cast<int32_t*>(raw2);

  if (tid == 0) {
    mbar_init(&bar);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    const uint32_t n = (uint32_t)rows * kRowBytes;
    const long long off = b * kFrameBytes + (long long)y0 * kRowBytes;
    mbar_expect_tx(&bar, 2 * n);
    bulk_load(raw1, f1 + off, n, &bar);
    bulk_load(raw2, f2 + off, n, &bar);
  }
  // The tap records the passes read (the band's Ry records, all of Cx's)
  // are loaded into registers while the copies run, and staged in shared
  // memory after luma: the passes then wait on no global load.
  const int i0 = band * band_rows, nr = min(band_rows, kOut - i0);
  const int32_t* ry_rec = plan + 2 * gridDim.x + i0 * kRec;
  const int32_t* cx_rec = plan + 2 * gridDim.x + kOut * kRec;
  const int nry = nr * kRec, nstage = nry + kOut * kRec;
  int32_t staged[kStage];
#pragma unroll
  for (int k = 0; k < kStage; ++k) {
    const int w = tid + k * kThreads;
    if (w < nstage) staged[k] = __ldg(w < nry ? ry_rec + w : cx_rec + w - nry);
  }
  __syncthreads();  // the mbarrier is initialised before anyone waits on it
  mbar_wait(&bar, 0);

  // Pool + luma: item i covers the band's pixels 4i..4i+3 = bytes
  // 12i..12i+11 of each frame's rows (three words, so a warp's loads and
  // its 16-byte stores meet no bank conflict).
  for (int i = tid; i < rows * (kW / 4); i += kThreads) {
    const uint32_t* a = reinterpret_cast<const uint32_t*>(raw1) + 3 * i;
    const uint32_t* c = reinterpret_cast<const uint32_t*>(raw2) + 3 * i;
    const uint32_t m0 = __vmaxu4(a[0], c[0]), m1 = __vmaxu4(a[1], c[1]),
                   m2 = __vmaxu4(a[2], c[2]);
    reinterpret_cast<float4*>(ys)[i] = make_float4(
        luma(byte_float(m0, 0), byte_float(m0, 1), byte_float(m0, 2)),
        luma(byte_float(m0, 3), byte_float(m1, 0), byte_float(m1, 1)),
        luma(byte_float(m1, 2), byte_float(m1, 3), byte_float(m2, 0)),
        luma(byte_float(m2, 1), byte_float(m2, 2), byte_float(m2, 3)));
  }
  __syncthreads();  // raw2 is read
#pragma unroll
  for (int k = 0; k < kStage; ++k) {
    const int w = tid + k * kThreads;
    if (w < nstage) taps[w] = staged[k];
  }
  __syncthreads();

  // Vertical pass: vsum[r][x] = sum_t Ry[i][lo + t] * Y[lo + t][x] for the
  // band's output rows i = i0 + r, 4 columns an item.
  for (int it = tid; it < nr * (kW / 4); it += kThreads) {
    const int r = it / (kW / 4), x = 4 * (it - r * (kW / 4));
    const int32_t* rec = taps + r * kRec;
    const int lo = rec[0] - y0, n = rec[1];
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int t = 0; t < kTaps; ++t) {
      if (t < n) {
        const float wt = __int_as_float(rec[2 + t]);
        const float4 v = *reinterpret_cast<const float4*>(ys + (lo + t) * kW + x);
        acc.x = fmaf(wt, v.x, acc.x);
        acc.y = fmaf(wt, v.y, acc.y);
        acc.z = fmaf(wt, v.z, acc.z);
        acc.w = fmaf(wt, v.w, acc.w);
      }
    }
    reinterpret_cast<float4*>(vsum + r * kW)[x / 4] = acc;
  }
  __syncthreads();

  // Horizontal pass + round half to even + clip; the band's output rows are
  // one contiguous run of nr x 84 bytes. 1.5 x 2^23 + acc rounds to the
  // nearest integer, ties to even, for |acc| < 2^22, as rintf does.
  uint8_t* o = out + b * (long long)(kOut * kOut) + i0 * kOut;
  for (int it = tid; it < nr * kOut; it += kThreads) {
    const int r = it / kOut, j = it - r * kOut;
    const int32_t* rec = taps + nry + j * kRec;
    const float* row = vsum + r * kW + rec[0];
    const int n = rec[1];
    float acc = 0.0f;
#pragma unroll
    for (int t = 0; t < kTaps; ++t) {
      if (t < n) acc = fmaf(row[t], __int_as_float(rec[2 + t]), acc);
    }
    const int v = __float_as_int(__fadd_rn(acc, 1.5f * kTwo23)) -
                  __float_as_int(1.5f * kTwo23);
    o[it] = (uint8_t)min(max(v, 0), 255);
  }
}

}  // namespace

// Shared memory of a block whose band reads at most `max_rows` input rows.
extern "C" int dz_pooled_frame_to_84_smem(int max_rows) {
  return smem_bytes(max_rows);
}

// f1, f2 (batch, 210, 160, 3) uint8, 16-byte aligned; the plan as above,
// for `bands` bands of `band_rows` output rows of which none reads more
// than `max_rows` input rows; out (batch, 84, 84) uint8. Returns
// cudaGetLastError().
extern "C" int dz_pooled_frame_to_84(const void* f1, const void* f2,
                                     const void* plan, void* out, int batch,
                                     int bands, int band_rows, int max_rows,
                                     void* cuda_stream) {
  const int smem = smem_bytes(max_rows);
  const int stage = (band_rows + kOut) * kRec;  // words, at most
  if (band_rows <= 0 || max_rows <= 0 || max_rows > kH || batch > kMaxBatch ||
      bands != (kOut + band_rows - 1) / band_rows ||
      band_rows * kW * 4 > max_rows * kRowBytes ||
      stage > kStage * kThreads || stage * 4 > max_rows * kRowBytes ||
      smem > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  if (smem > kSmemDefault) {
    // Bands of 12 rows or more take over 48 KB: opt in once per device for
    // each larger size (the main path's bands need no opt-in).
    static int opted[kMaxDevices];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
    if (smem > opted[dev]) {
      err = cudaFuncSetAttribute(pooled_frame_to_84_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
      if (err != cudaSuccess) return (int)err;
      opted[dev] = smem;
    }
  }
  if (batch > 0) {
    pooled_frame_to_84_kernel<<<dim3(bands, batch), kThreads, smem,
                                (cudaStream_t)cuda_stream>>>(
        (const uint8_t*)f1, (const uint8_t*)f2, (const int32_t*)plan,
        (uint8_t*)out, band_rows, max_rows);
  }
  return (int)cudaGetLastError();
}
