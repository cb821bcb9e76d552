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
// sample. On the CUDA cores in f32 no design goes below 0.24 ms at B = 1024;
// the products run on the tensor cores instead, in 3xTF32 (tf32_mma.cuh,
// `mma.sync.m16n8k8`, the path of K4a, K4b and K4c): each f32 operand is
// split into two TF32 parts and three TF32 products keep f32 accuracy.
//
// Design: one block of 256 threads (8 warps) per sample. The sample's uint8
// input (28 KB) and z1 (51 KB) stay in shared memory; z2 (21 KB) takes the
// input's place once conv1 has read it (79 KB, two blocks per SM), so the
// forward-only variant writes nothing but the embedding. The weights are
// read from L2 through the read-only cache.
//
// Each convolution is one implicit GEMM, computed by one layer routine
// (`conv_layer`) instantiated three times: rows are the output positions of
// the sample (M = 400, 81, 49), columns the output channels (N = 32, 64,
// 64), and k = (ky, kx, ci), the row order of the HWIO weights
// (K = 256, 512, 576). For a fixed ky, the k of one output position lie
// contiguous in the NHWC input: a tap row of R = KW x CI elements (conv1:
// 8 pixels x 4 channels = 32 bytes; conv2: 128 floats; conv3: 192 floats).
// A tap row is walked in chunks of 16 k, two k-steps of the mma:
//   - the reduction order inside a chunk is free, so lane (g, t) takes the
//     four consecutive elements 4t .. 4t + 3 of the chunk as k = t, t + 4 of
//     the first k-step and of the second: one load gives its A values of
//     both k-steps (16 bytes of f32, or one uint8 pixel of 4 channels,
//     scaled by 1/255 as it is loaded, exactly as the plain version does);
//   - the column order is free too: column g of n-tile j is output channel
//     n0 + 2g + j, so a lane's B values of both n-tiles are one float2 of a
//     weight row, and its accumulators are the four consecutive channels
//     n0 + 4t .. 4t + 3 of rows g and g + 8: one 16-byte store each.
// A warp owns MT m16 tiles x 2 n8 tiles (16 channels) at a time and walks
// the items of its layer in turn (conv1 MT = 2: 26 items; conv2 MT = 3 and
// conv3 MT = 2: 8 items, one per warp).
//
// Ragged M: conv2's last tile holds 81 - 80 = 1 real row, conv3's 49 - 48,
// conv1 a whole padded tile (400 rows in 13 pairs of tiles). Rows past M
// read the last position's data (clamped) and are never stored.
//
// Bank conflicts: the eight lanes of one 16-byte load phase are rows g and
// g + 1 of a tile, t = 0 .. 3. In z1 a pixel is 128 bytes and in z2 256, so
// every pixel starts in the same bank and rows g, g + 1 would read the same
// four banks. z1 and z2 are stored with their 16-byte pieces XOR 4 where
// x / S + y / S of the pixel (x, y) is odd, S the stride of the layer that
// reads it: for consecutive output positions that parity alternates, within
// an output row and across its end (an output row is an odd number of
// positions wide in both layers that read). K3b's copies of z1 and z2 to
// device memory undo the swizzle, so they are NHWC bit for bit. conv1 reads
// the input as 4-byte pixels: lanes (g, t) read 32 consecutive words.
//
// Accumulation: the tensor cores add in f32 with truncation. The k-depths
// here are 32, 64 and 72 k-steps in one accumulator, as K4c's dhi (64):
// the CPU plan test (tests/test_torch_kernel_plans.py) keeps the truncating
// sum of every layer within a small share of the tolerance without a fold.
// Bias and ReLU are applied in each layer's epilogue.
//
// The TPU kernel's lane packing of output positions (_wb1-_wb3) fed its
// 128-wide matrix unit and has no counterpart here.

#include <cstdint>
#include <cuda_runtime.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kXBytes = 84 * 84 * 4;   // 28224
constexpr int kZ1 = 20 * 20 * 32;      // 12800 floats
constexpr int kZ2 = 9 * 9 * 64;        // 5184 floats
constexpr int kOut = 7 * 7 * 64;       // 3136 floats
constexpr int kXZ2Bytes = kXBytes > kZ2 * 4 ? kXBytes : kZ2 * 4;
constexpr int kSmem = kZ1 * 4 + kXZ2Bytes;  // 79424 bytes

__device__ __forceinline__ float relu(float v) { return fmaxf(v, 0.0f); }

// The XOR of the 16-byte piece index at pixel (x, y) of an activation read
// by a layer of stride S (0: no swizzle).
template <int S>
__device__ __forceinline__ int swizzle(int x, int y) {
  if constexpr (S == 0) {
    return 0;
  } else {
    return ((x / S + y / S) & 1) << 2;
  }
}

// Four consecutive k of one row: a uint8 pixel (4 channels) scaled by
// 1/255, or a 16-byte piece of f32 channels.
__device__ __forceinline__ float4 load4(const uint8_t* p) {
  const uint32_t v = *reinterpret_cast<const uint32_t*>(p);
  const float s = 1.0f / 255.0f;
  return make_float4(__fmul_rn((float)(v & 0xffu), s),
                     __fmul_rn((float)((v >> 8) & 0xffu), s),
                     __fmul_rn((float)((v >> 16) & 0xffu), s),
                     __fmul_rn((float)(v >> 24), s));
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// out = relu(conv(in, w, stride S) + bias) for one sample, VALID padding.
// in: (W, W, CI) in shared memory, uint8 or f32 (swizzled for stride S);
// w: HWIO (KH, KW, CI, CO); out: (OW, OW, CO), in shared memory swizzled
// for the next layer's stride kOutS, or in device memory (kOutS = 0).
template <typename In, int KH, int KW, int S, int CI, int CO, int W, int OW,
          int MT, int kOutS>
__device__ __forceinline__ void conv_layer(const In* in,
                                           const float* __restrict__ w,
                                           const float* __restrict__ bias,
                                           float* out, int warp, int lane) {
  constexpr int M = OW * OW;
  constexpr int R = KW * CI;        // k of one tap row, contiguous
  constexpr int kChunks = R / 16;   // chunks of 16 k: two k-steps
  constexpr int kGroups = ((M + 15) / 16 + MT - 1) / MT;
  constexpr int kSlices = CO / 16;  // 16 channels: two n-tiles
  static_assert(R % 16 == 0 && CO % 16 == 0, "tap row or N not in chunks");
  static_assert(sizeof(In) == 4 || CI == 4, "uint8 pixels hold 4 channels");
  const int g = lane >> 2, t = lane & 3;
  for (int item = warp; item < kGroups * kSlices; item += kWarps) {
    const int m0 = (item / kSlices) * MT * 16;
    const int n0 = (item % kSlices) * 16;
    int base[MT][2], par[MT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = min(m0 + 16 * i + 8 * h + g, M - 1);
        const int oy = m / OW, ox = m % OW;
        base[i][h] = S * oy * W + S * ox;
        par[i][h] = ox + oy;
      }
    }
    float acc[MT][2][4] = {};
    const float* wl = w + 4 * t * CO + n0 + 2 * g;
    for (int ky = 0; ky < KH; ++ky) {
      // Where lane t's four elements of chunk 0 of tap row ky lie, for
      // each row. For f32 a chunk's piece lies 16 floats on or not, by the
      // swizzle: rp[i][h][f] is its place for a chunk whose own bits give
      // f (below); uint8 input is not swizzled.
      const In* rp[MT][2][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const In* p = in + (base[i][h] + ky * W) * CI + 4 * t;
          const int odd = (par[i][h] + ky / S) & 1;
          rp[i][h][0] = sizeof(In) == 1 ? p : p + 16 * odd;
          rp[i][h][1] = p + 16 * (1 - odd);
        }
      }
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        // Chunk c is elements 16c .. 16c + 15 of the tap row: for uint8, 4
        // pixels; for f32, piece kq .. kq + 3 of pixel kx, stored at
        // ((kq + t) ^ swz) = (kq & ~4) + t + 4 ((kq >> 2) ^ swz >> 2).
        float4 a[MT][2];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if constexpr (sizeof(In) == 1) {
              a[i][h] = load4(rp[i][h][0] + 16 * c);
            } else {
              const int kx = 16 * c / CI, kq = 16 * c % CI / 4;
              const int f = ((kq >> 2) ^ (kx / S)) & 1;
              a[i][h] = load4(rp[i][h][f] + kx * CI + 4 * (kq & ~4));
            }
          }
        }
        float2 b[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          b[j] = __ldg(reinterpret_cast<const float2*>(
              wl + (ky * R + 16 * c + j) * CO));
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          uint32_t ab[MT][4], as[MT][4], bb[2][2], bs[2][2];
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            split_tf32(s ? a[i][0].z : a[i][0].x, ab[i][0], as[i][0]);
            split_tf32(s ? a[i][1].z : a[i][1].x, ab[i][1], as[i][1]);
            split_tf32(s ? a[i][0].w : a[i][0].y, ab[i][2], as[i][2]);
            split_tf32(s ? a[i][1].w : a[i][1].y, ab[i][3], as[i][3]);
          }
          split_tf32(b[2 * s].x, bb[0][0], bs[0][0]);
          split_tf32(b[2 * s + 1].x, bb[0][1], bs[0][1]);
          split_tf32(b[2 * s].y, bb[1][0], bs[1][0]);
          split_tf32(b[2 * s + 1].y, bb[1][1], bs[1][1]);
#pragma unroll
          for (int i = 0; i < MT; ++i) {
#pragma unroll
            for (int j = 0; j < 2; ++j)
              mma_3xtf32(acc[i][j], ab[i], as[i], bb[j], bs[j]);
          }
        }
      }
    }
    const float4 bv = __ldg(reinterpret_cast<const float4*>(bias + n0 + 4 * t));
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + 16 * i + 8 * h + g;
        if (m >= M) continue;
        const float4 v = make_float4(relu(acc[i][0][2 * h] + bv.x),
                                     relu(acc[i][1][2 * h] + bv.y),
                                     relu(acc[i][0][2 * h + 1] + bv.z),
                                     relu(acc[i][1][2 * h + 1] + bv.w));
        const int q = (n0 >> 2) + t;
        const int swz = swizzle<kOutS>(m % OW, m / OW);
        *reinterpret_cast<float4*>(out + m * CO + ((q ^ swz) << 2)) = v;
      }
    }
  }
}

// K3b: a swizzled activation (W, W, C) in shared memory to NHWC in device
// memory.
template <int W, int C, int S>
__device__ __forceinline__ void copy_out(const float* z, float* dst,
                                         int tid) {
  constexpr int kPieces = C / 4;
  for (int i = tid; i < W * W * kPieces; i += kThreads) {
    const int p = i / kPieces, q = i % kPieces;
    const int swz = swizzle<S>(p % W, p / W);
    reinterpret_cast<float4*>(dst)[i] =
        *reinterpret_cast<const float4*>(z + p * C + ((q ^ swz) << 2));
  }
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
  float* z1 = reinterpret_cast<float*>(smem);
  uint8_t* xs = smem + kZ1 * 4;
  float* z2 = reinterpret_cast<float*>(xs);  // once conv1 has read xs
  const int b = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  {
    const uint4* src = reinterpret_cast<const uint4*>(x + (long long)b * kXBytes);
    uint4* dst = reinterpret_cast<uint4*>(xs);
    for (int i = tid; i < kXBytes / 16; i += kThreads) dst[i] = __ldg(src + i);
  }
  __syncthreads();

  // conv1: 8x8 stride 4, 4 -> 32 channels.
  conv_layer<uint8_t, 8, 8, 4, 4, 32, 84, 20, 2, 2>(xs, w1, b1, z1, warp,
                                                     lane);
  __syncthreads();
  if (kResiduals) copy_out<20, 32, 2>(z1, z1g + (long long)b * kZ1, tid);

  // conv2: 4x4 stride 2, 32 -> 64 channels.
  conv_layer<float, 4, 4, 2, 32, 64, 20, 9, 3, 1>(z1, w2, b2, z2, warp, lane);
  __syncthreads();
  if (kResiduals) copy_out<9, 64, 1>(z2, z2g + (long long)b * kZ2, tid);

  // conv3: 3x3 stride 1, 64 -> 64 channels, written straight to the output.
  conv_layer<float, 3, 3, 1, 64, 64, 9, 7, 2, 0>(z2, w3, b3,
                                                 out + (long long)b * kOut,
                                                 warp, lane);
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
