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
// the band of each weight row (about 6 taps), so the arithmetic is about
// 0.25 MFLOP per env, far below what the reads take.
//
// Design: one block per env. The interleaved HWC frames are read directly
// (the planar transpose of the TPU kernel was for its 128 lanes): each thread
// takes 16 pixels as three 16-byte loads from each frame, pools them with
// per-byte max, and writes 16 luma bytes to shared memory (33.6 KB). The
// vertical pass (84 x 160 f32 rows, 53.8 KB of shared memory) and the
// horizontal pass then run over each weight row's nonzero band [lo, hi),
// which the wrapper passes beside the two matrices. Luma uses explicitly
// rounded multiplies and adds so that it is the plain version's f32
// arithmetic bit for bit; rounding is half to even (rintf), like jnp.round.
// Shared memory is 87 KB, so two blocks share an SM.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kH = 210, kW = 160, kOut = 84;
constexpr int kPix = kH * kW;        // 33600
constexpr int kRowsOff = kPix;       // byte offset of the f32 rows in smem
constexpr int kSmem = kPix + kOut * kW * 4;  // 87360 bytes

__device__ __forceinline__ uint32_t byte_at(const uint32_t* w, int j) {
  return (w[j >> 2] >> (8 * (j & 3))) & 0xffu;
}

__device__ __forceinline__ uint32_t luma(uint32_t r, uint32_t g, uint32_t b) {
  const float w0 = (float)0.299, w1 = (float)0.587,
              w2 = (float)(1.0 - (0.299 + 0.587));
  float y = __fadd_rn(__fadd_rn(__fmul_rn((float)r, w0), __fmul_rn((float)g, w1)),
                      __fmul_rn((float)b, w2));
  y = fminf(floorf(y), 255.0f);
  return (uint32_t)y;
}

__global__ void __launch_bounds__(kThreads)
pooled_frame_to_84_kernel(const uint4* __restrict__ f1,
                          const uint4* __restrict__ f2,
                          const float* __restrict__ ry,
                          const float* __restrict__ cx,
                          const int32_t* __restrict__ ry_band,
                          const int32_t* __restrict__ cx_band,
                          uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* ys = smem;
  float* rows = reinterpret_cast<float*>(smem + kRowsOff);
  const int b = blockIdx.x;
  const long long frame_vec = (long long)kPix * 3 / 16;  // 6300 uint4
  const uint4* a = f1 + b * frame_vec;
  const uint4* c = f2 + b * frame_vec;

  // Pool + luma: item i covers pixels 16i..16i+15 = bytes 48i..48i+47.
  for (int i = threadIdx.x; i < kPix / 16; i += kThreads) {
    uint32_t w[12];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      uint4 x = __ldg(a + 3 * i + k), y = __ldg(c + 3 * i + k);
      w[4 * k + 0] = __vmaxu4(x.x, y.x);
      w[4 * k + 1] = __vmaxu4(x.y, y.y);
      w[4 * k + 2] = __vmaxu4(x.z, y.z);
      w[4 * k + 3] = __vmaxu4(x.w, y.w);
    }
    uint32_t o[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      uint32_t v = luma(byte_at(w, 3 * q), byte_at(w, 3 * q + 1),
                        byte_at(w, 3 * q + 2));
      o[q >> 2] |= v << (8 * (q & 3));
    }
    reinterpret_cast<uint4*>(ys)[i] = make_uint4(o[0], o[1], o[2], o[3]);
  }
  __syncthreads();

  // Vertical pass: rows[i][x] = sum_y Ry[i][y] * Y[y][x] over Ry's band.
  for (int idx = threadIdx.x; idx < kOut * kW; idx += kThreads) {
    const int i = idx / kW, x = idx - i * kW;
    const int lo = ry_band[2 * i], hi = ry_band[2 * i + 1];
    float acc = 0.0f;
    for (int y = lo; y < hi; ++y) {
      acc = fmaf(__ldg(ry + i * kH + y), (float)ys[y * kW + x], acc);
    }
    rows[idx] = acc;
  }
  __syncthreads();

  // Horizontal pass + round half to even + clip.
  uint8_t* o = out + (long long)b * kOut * kOut;
  for (int idx = threadIdx.x; idx < kOut * kOut; idx += kThreads) {
    const int i = idx / kOut, j = idx - i * kOut;
    const int lo = cx_band[2 * j], hi = cx_band[2 * j + 1];
    float acc = 0.0f;
    for (int x = lo; x < hi; ++x) {
      acc = fmaf(rows[i * kW + x], __ldg(cx + j * kW + x), acc);
    }
    o[idx] = (uint8_t)fminf(fmaxf(rintf(acc), 0.0f), 255.0f);
  }
}

}  // namespace

extern "C" int dz_pooled_frame_to_84(const void* f1, const void* f2,
                                     const void* ry, const void* cx,
                                     const void* ry_band, const void* cx_band,
                                     void* out, int batch, void* cuda_stream) {
  cudaError_t err = cudaFuncSetAttribute(
      pooled_frame_to_84_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (err != cudaSuccess) return (int)err;
  if (batch > 0) {
    pooled_frame_to_84_kernel<<<batch, kThreads, kSmem,
                                (cudaStream_t)cuda_stream>>>(
        (const uint4*)f1, (const uint4*)f2, (const float*)ry,
        (const float*)cx, (const int32_t*)ry_band, (const int32_t*)cx_band,
        (uint8_t*)out);
  }
  return (int)cudaGetLastError();
}
