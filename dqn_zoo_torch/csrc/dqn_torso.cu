// K3: the DQN torso forward, uint8 frames -> (B, 3136) f32 embedding.
//
// Replaces the TPU kernels of dqn_zoo_tpu/nets/torso_pallas.py:
//   K3a `_fwd_call(with_residuals=False)` -> `_kernel_fwd_only`
//   K3b `_fwd_call(with_residuals=True)`  -> `_kernel`
//
//   h0 = x / 255                                  x: (B, 84, 84, 4) uint8 NHWC
//   z1 = relu(conv(h0, w1, stride 4) + b1)        (B, 20, 20, 32)
//   z2 = relu(conv(z1, w2, stride 2) + b2)        (B, 9, 9, 64)
//   z3 = relu(conv(z2, w3, stride 1) + b3)        (B, 7, 7, 64) -> (B, 3136)
// VALID padding, weights in HWIO exactly as the JAX package keeps them, the
// output flattened in (y, x, c) order as JAX flattens NHWC. K3b also writes
// z1 and z2 (post-ReLU, NHWC) for the backward pass, which runs outside this
// kernel as in the JAX package.
//
// Bound on the H100: operations. 7.74 M multiply-adds per sample (15.9
// GFLOP at B = 1024) against 28 KB of input and 12.5 KB of output per
// sample, all in f32 on the CUDA cores (no tensor cores in this version).
//
// Design: one block per sample, 256 threads. The sample's uint8 input
// (28 KB), z1 (51 KB) and z2 (21 KB) stay in shared memory (100 KB, two
// blocks per SM), so the forward-only variant writes nothing but the
// embedding. Weights stream from L2 through the read-only cache. Each thread
// computes a register tile of positions x output channels, so every weight
// it loads serves several positions and every input value several channels:
//   conv1: 5 positions (along x) x 4 channels, 640 tiles;
//   conv2: 3 positions x 8 channels, 216 tiles;
//   conv3: 7 positions (a full row) x 2 channels, 224 tiles.
// Lanes of a warp share positions and differ in channels, so shared-memory
// reads are broadcasts and weight reads are coalesced. The 1/255 scale is
// applied to each uint8 value as it is loaded, bias and ReLU in each layer's
// epilogue. The TPU kernel's lane packing of output positions (_wb1-_wb3)
// fed its 128-wide matrix unit and has no counterpart here.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kXBytes = 84 * 84 * 4;   // 28224
constexpr int kZ1 = 20 * 20 * 32;      // 12800 floats
constexpr int kZ2 = 9 * 9 * 64;        // 5184 floats
constexpr int kOut = 7 * 7 * 64;       // 3136 floats
constexpr int kSmem = kXBytes + (kZ1 + kZ2) * 4;  // 100160 bytes

__device__ __forceinline__ float relu(float v) { return fmaxf(v, 0.0f); }

__device__ __forceinline__ void fma4(float (&acc)[4], float v, float4 w) {
  acc[0] = fmaf(v, w.x, acc[0]);
  acc[1] = fmaf(v, w.y, acc[1]);
  acc[2] = fmaf(v, w.z, acc[2]);
  acc[3] = fmaf(v, w.w, acc[3]);
}

template <bool kResiduals>
__global__ void __launch_bounds__(kThreads, 2)
dqn_torso_kernel(const uint8_t* __restrict__ x,
                 const float* __restrict__ w1, const float* __restrict__ b1,
                 const float* __restrict__ w2, const float* __restrict__ b2,
                 const float* __restrict__ w3, const float* __restrict__ b3,
                 float* __restrict__ out, float* __restrict__ z1g,
                 float* __restrict__ z2g) {
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t* xs = reinterpret_cast<const uint32_t*>(smem);  // 4 ch/pixel
  float* z1 = reinterpret_cast<float*>(smem + kXBytes);
  float* z2 = z1 + kZ1;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;

  {
    const uint4* src = reinterpret_cast<const uint4*>(x + (long long)b * kXBytes);
    uint4* dst = reinterpret_cast<uint4*>(smem);
    for (int i = tid; i < kXBytes / 16; i += kThreads) dst[i] = __ldg(src + i);
  }
  __syncthreads();

  // conv1: 8x8 stride 4, 4 -> 32 channels.
  const float scale = 1.0f / 255.0f;
  for (int item = tid; item < 80 * 8; item += kThreads) {
    const int cg = item & 7, pg = item >> 3;
    const int oy = pg >> 2, ox0 = (pg & 3) * 5, co0 = cg * 4;
    float acc[5][4] = {};
    for (int ky = 0; ky < 8; ++ky) {
      const uint32_t* row = xs + (4 * oy + ky) * 84 + 4 * ox0;
      for (int kx = 0; kx < 8; ++kx) {
        const float4* wp =
            reinterpret_cast<const float4*>(w1 + (ky * 8 + kx) * 4 * 32 + co0);
        float4 wv[4];
#pragma unroll
        for (int ci = 0; ci < 4; ++ci) wv[ci] = __ldg(wp + ci * 8);
#pragma unroll
        for (int p = 0; p < 5; ++p) {
          const uint32_t px = row[4 * p + kx];
#pragma unroll
          for (int ci = 0; ci < 4; ++ci) {
            const float v = __fmul_rn((float)((px >> (8 * ci)) & 0xffu), scale);
            fma4(acc[p], v, wv[ci]);
          }
        }
      }
    }
    const float4 bb = __ldg(reinterpret_cast<const float4*>(b1 + co0));
#pragma unroll
    for (int p = 0; p < 5; ++p) {
      *reinterpret_cast<float4*>(z1 + (oy * 20 + ox0 + p) * 32 + co0) =
          make_float4(relu(acc[p][0] + bb.x), relu(acc[p][1] + bb.y),
                      relu(acc[p][2] + bb.z), relu(acc[p][3] + bb.w));
    }
  }
  __syncthreads();
  if (kResiduals) {
    float4* dst = reinterpret_cast<float4*>(z1g + (long long)b * kZ1);
    const float4* src = reinterpret_cast<const float4*>(z1);
    for (int i = tid; i < kZ1 / 4; i += kThreads) dst[i] = src[i];
  }

  // conv2: 4x4 stride 2, 32 -> 64 channels.
  for (int item = tid; item < 27 * 8; item += kThreads) {
    const int cg = item & 7, pg = item >> 3;
    const int oy = pg / 3, ox0 = (pg % 3) * 3, co0 = cg * 8;
    float acc[3][8] = {};
    for (int ky = 0; ky < 4; ++ky) {
      for (int kx = 0; kx < 4; ++kx) {
        const float* in0 = z1 + ((2 * oy + ky) * 20 + 2 * ox0 + kx) * 32;
        const float* wk = w2 + (ky * 4 + kx) * 32 * 64 + co0;
        for (int ci = 0; ci < 32; ci += 4) {
          float4 wv[4][2];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float4* wp = reinterpret_cast<const float4*>(wk + (ci + q) * 64);
            wv[q][0] = __ldg(wp);
            wv[q][1] = __ldg(wp + 1);
          }
#pragma unroll
          for (int p = 0; p < 3; ++p) {
            const float4 v = *reinterpret_cast<const float4*>(in0 + p * 64 + ci);
            const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              float* a = acc[p];
              a[0] = fmaf(vs[q], wv[q][0].x, a[0]);
              a[1] = fmaf(vs[q], wv[q][0].y, a[1]);
              a[2] = fmaf(vs[q], wv[q][0].z, a[2]);
              a[3] = fmaf(vs[q], wv[q][0].w, a[3]);
              a[4] = fmaf(vs[q], wv[q][1].x, a[4]);
              a[5] = fmaf(vs[q], wv[q][1].y, a[5]);
              a[6] = fmaf(vs[q], wv[q][1].z, a[6]);
              a[7] = fmaf(vs[q], wv[q][1].w, a[7]);
            }
          }
        }
      }
    }
    const float4 bb0 = __ldg(reinterpret_cast<const float4*>(b2 + co0));
    const float4 bb1 = __ldg(reinterpret_cast<const float4*>(b2 + co0 + 4));
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      float4* dst = reinterpret_cast<float4*>(z2 + (oy * 9 + ox0 + p) * 64 + co0);
      dst[0] = make_float4(relu(acc[p][0] + bb0.x), relu(acc[p][1] + bb0.y),
                           relu(acc[p][2] + bb0.z), relu(acc[p][3] + bb0.w));
      dst[1] = make_float4(relu(acc[p][4] + bb1.x), relu(acc[p][5] + bb1.y),
                           relu(acc[p][6] + bb1.z), relu(acc[p][7] + bb1.w));
    }
  }
  __syncthreads();
  if (kResiduals) {
    float4* dst = reinterpret_cast<float4*>(z2g + (long long)b * kZ2);
    const float4* src = reinterpret_cast<const float4*>(z2);
    for (int i = tid; i < kZ2 / 4; i += kThreads) dst[i] = src[i];
  }

  // conv3: 3x3 stride 1, 64 -> 64 channels, written straight to the output.
  for (int item = tid; item < 7 * 32; item += kThreads) {
    const int cg = item & 31, oy = item >> 5, co0 = cg * 2;
    float acc[7][2] = {};
    for (int ky = 0; ky < 3; ++ky) {
      for (int kx = 0; kx < 3; ++kx) {
        const float* in0 = z2 + ((oy + ky) * 9 + kx) * 64;
        const float* wk = w3 + (ky * 3 + kx) * 64 * 64 + co0;
        for (int ci = 0; ci < 64; ci += 4) {
          float2 wv[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            wv[q] = __ldg(reinterpret_cast<const float2*>(wk + (ci + q) * 64));
#pragma unroll
          for (int p = 0; p < 7; ++p) {
            const float4 v = *reinterpret_cast<const float4*>(in0 + p * 64 + ci);
            acc[p][0] = fmaf(v.x, wv[0].x, acc[p][0]);
            acc[p][1] = fmaf(v.x, wv[0].y, acc[p][1]);
            acc[p][0] = fmaf(v.y, wv[1].x, acc[p][0]);
            acc[p][1] = fmaf(v.y, wv[1].y, acc[p][1]);
            acc[p][0] = fmaf(v.z, wv[2].x, acc[p][0]);
            acc[p][1] = fmaf(v.z, wv[2].y, acc[p][1]);
            acc[p][0] = fmaf(v.w, wv[3].x, acc[p][0]);
            acc[p][1] = fmaf(v.w, wv[3].y, acc[p][1]);
          }
        }
      }
    }
    const float2 bb = __ldg(reinterpret_cast<const float2*>(b3 + co0));
    float* o = out + (long long)b * kOut + oy * 7 * 64 + co0;
#pragma unroll
    for (int p = 0; p < 7; ++p) {
      *reinterpret_cast<float2*>(o + p * 64) =
          make_float2(relu(acc[p][0] + bb.x), relu(acc[p][1] + bb.y));
    }
  }
}

}  // namespace

extern "C" int dz_dqn_torso(const void* x, const void* w1, const void* b1,
                            const void* w2, const void* b2, const void* w3,
                            const void* b3, void* out, void* z1, void* z2,
                            int batch, int residuals, void* cuda_stream) {
  cudaStream_t s = (cudaStream_t)cuda_stream;
  const uint8_t* xx = (const uint8_t*)x;
  const float *p1 = (const float*)w1, *q1 = (const float*)b1,
              *p2 = (const float*)w2, *q2 = (const float*)b2,
              *p3 = (const float*)w3, *q3 = (const float*)b3;
  cudaError_t err;
  if (residuals) {
    err = cudaFuncSetAttribute(dqn_torso_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmem);
    if (err != cudaSuccess) return (int)err;
    if (batch > 0)
      dqn_torso_kernel<true><<<batch, kThreads, kSmem, s>>>(
          xx, p1, q1, p2, q2, p3, q3, (float*)out, (float*)z1, (float*)z2);
  } else {
    err = cudaFuncSetAttribute(dqn_torso_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmem);
    if (err != cudaSuccess) return (int)err;
    if (batch > 0)
      dqn_torso_kernel<false><<<batch, kThreads, kSmem, s>>>(
          xx, p1, q1, p2, q2, p3, q3, (float*)out, nullptr, nullptr);
  }
  return (int)cudaGetLastError();
}
