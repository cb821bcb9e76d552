// K4a: the fused IQN per-tau head forward, (B*S, 64) cosine features and a
// (B, D) torso embedding -> q (B*S, A) and, optionally, h (B*S, 512).
//
// Replaces the TPU kernel of dqn_zoo_tpu/nets/iqn_head.py:
//   K4a `_fwd_call` -> `_fwd_kernel`
// in two variants from this one source: forward only (acting, eval, target
// nets: writes q) and with residuals (the online net under grad: also writes
// the post-ReLU hidden h, which the backward reads: iqn_head_bwd.cu).
//
// For rows r = (stream, tau) pairs with tau minor, all in float32:
//   te = relu(cos @ we + be)            (rows, D)   tau embedding
//   hi = te * s_emb[r / S]              (rows, D)   head input
//   h  = relu(hi @ wh + bh)             (rows, 512)
//   q  = h @ wo + bo                    (rows, A)
// Like the TPU kernel, te and hi never reach device memory. Unlike it, the
// stream broadcast s_emb[r / S] is a plain index (the TPU's one-hot expand
// product and its 8-stream blocks were there for its relayout cost), so any
// B >= 1, S >= 1 and A >= 1 is taken and the ragged last tile is masked.
//
// Bound on the H100: operations. At the acting shape (B = 128, S = 64,
// A = 6) the three products are 29.6 GFLOP against about 11 MB of inputs
// and outputs; all of it runs in f32 on the CUDA cores in this version (no
// tensor cores), so the bound is the card's f32 FMA rate.
//
// Design: one block of 256 threads per tile of 64 consecutive rows (one
// stream's tau samples at S = 64). The (64, 512) pre-activation of h lives
// in registers, 8 rows x 16 columns per thread: a warp owns 8 rows, a lane
// the columns {4*lane + 128*j .. +3}, so hidden-weight reads from shared
// memory are conflict-free float4s and head-input reads are broadcasts. The
// D axis is a loop inside the block in chunks of 32: for each chunk
//   1. the next chunk of wh (32 x 512, one contiguous 64 KB run) and of we
//      (64 x 32) is started towards the other shared-memory buffer with
//      cp.async, so the copy runs under this chunk's arithmetic;
//   2. te's chunk (64 x 32) is computed from the resident transposed cosine
//      tile and the we chunk, 4 rows x 2 columns per thread, then bias, ReLU
//      and the s_emb factor (read through the read-only cache), and stored
//      transposed as hi_t[k][row];
//   3. acc += hi_t^T @ wh_chunk: per k, 6 shared-memory float4 loads feed
//      128 FMAs per thread.
// Epilogue: bias and ReLU in registers, h stored as coalesced float4s when
// asked for, and q by warp reductions: every lane multiplies its 16 columns
// of h by wo[:, a] and a shuffle tree sums the 32 lanes, so h never goes
// through shared memory. Sums are taken in a fixed order (no atomics): the
// result is the same from run to run.
//
// Shared memory: cosine tile 17 KB + hi chunk 8.5 KB + 2 x we chunk 8 KB +
// 2 x wh chunk 64 KB = 169.5 KB, one block per SM.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kL = 64;    // cosine features per tau sample
constexpr int kH = 512;   // hidden width
constexpr int kM = 64;    // rows per block
constexpr int kKC = 32;   // columns of D per chunk
constexpr int kPad = kM + 4;            // row stride of the transposed tiles
constexpr int kCosT = kL * kPad;        // floats
constexpr int kHiT = kKC * kPad;
constexpr int kWe = kL * kKC;           // per buffer
constexpr int kWh = kKC * kH;           // per buffer
constexpr int kSmem = (kCosT + kHiT + 2 * kWe + 2 * kWh) * 4;  // 173568 B

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void fma4(float* acc, float v, float4 w) {
  acc[0] = fmaf(v, w.x, acc[0]);
  acc[1] = fmaf(v, w.y, acc[1]);
  acc[2] = fmaf(v, w.z, acc[2]);
  acc[3] = fmaf(v, w.w, acc[3]);
}

template <bool kResiduals>
__global__ void __launch_bounds__(kThreads, 1)
iqn_head_kernel(const float* __restrict__ cosx, const float* __restrict__ semb,
                const float* __restrict__ we, const float* __restrict__ be,
                const float* __restrict__ wh, const float* __restrict__ bh,
                const float* __restrict__ wo, const float* __restrict__ bo,
                float* __restrict__ q, float* __restrict__ h,
                int rows, int s, int nb, int d, int a) {
  extern __shared__ __align__(16) float smem[];
  float* cos_t = smem;                 // [kL][kPad]: cos_t[l][row]
  float* hi_t = cos_t + kCosT;         // [kKC][kPad]: hi_t[k][row]
  float* we_s = hi_t + kHiT;           // [2][kL][kKC]
  float* wh_s = we_s + 2 * kWe;        // [2][kKC][kH]
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * kM;
  const int nchunks = d / kKC;

  // Starts chunk c of wh and we towards buffer c & 1.
  auto prefetch = [&](int c) {
    const int buf = c & 1;
    const float* src = wh + (long long)c * kWh;
    float* dst = wh_s + buf * kWh;
    for (int i = tid; i < kWh / 4; i += kThreads)
      cp_async16(dst + 4 * i, src + 4 * i);
    float* wdst = we_s + buf * kWe;
    for (int i = tid; i < kWe / 4; i += kThreads) {
      const int l = i >> 3, c4 = i & 7;
      cp_async16(wdst + l * kKC + 4 * c4,
                 we + (long long)l * d + c * kKC + 4 * c4);
    }
    cp_async_commit();
  };
  prefetch(0);

  // The tile's cosine features, transposed; rows past the end are zero.
  for (int i = tid; i < kM * kL / 4; i += kThreads) {
    const int r = i >> 4, c4 = i & 15;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < rows)
      v = __ldg(reinterpret_cast<const float4*>(
                    cosx + (long long)(row0 + r) * kL) + c4);
    cos_t[(4 * c4 + 0) * kPad + r] = v.x;
    cos_t[(4 * c4 + 1) * kPad + r] = v.y;
    cos_t[(4 * c4 + 2) * kPad + r] = v.z;
    cos_t[(4 * c4 + 3) * kPad + r] = v.w;
  }

  // te phase: this thread's 4 rows x 2 chunk columns, and where each row's
  // stream embedding starts (rows past the end read the last stream).
  const int kg = tid & 15, rg = tid >> 4;
  const float* srow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int st = (row0 + 4 * rg + i) / s;
    st = st < nb ? st : nb - 1;
    srow[i] = semb + (long long)st * d + 2 * kg;
  }

  float acc[8][16];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 16; ++c) acc[r][c] = 0.f;

  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait_all();
    __syncthreads();  // chunk c has landed; everyone has left chunk c - 1
    if (c + 1 < nchunks) prefetch(c + 1);
    const int buf = c & 1;
    const int d0 = c * kKC;

    {  // te and hi for columns [d0, d0 + 32).
      float t[4][2] = {};
      const float* wp = we_s + buf * kWe + 2 * kg;
      const float* cp = cos_t + 4 * rg;
#pragma unroll 8
      for (int l = 0; l < kL; ++l) {
        const float4 cv = *reinterpret_cast<const float4*>(cp + l * kPad);
        const float2 wv = *reinterpret_cast<const float2*>(wp + l * kKC);
        t[0][0] = fmaf(cv.x, wv.x, t[0][0]);
        t[0][1] = fmaf(cv.x, wv.y, t[0][1]);
        t[1][0] = fmaf(cv.y, wv.x, t[1][0]);
        t[1][1] = fmaf(cv.y, wv.y, t[1][1]);
        t[2][0] = fmaf(cv.z, wv.x, t[2][0]);
        t[2][1] = fmaf(cv.z, wv.y, t[2][1]);
        t[3][0] = fmaf(cv.w, wv.x, t[3][0]);
        t[3][1] = fmaf(cv.w, wv.y, t[3][1]);
      }
      const float2 bb = __ldg(reinterpret_cast<const float2*>(be + d0 + 2 * kg));
      float hi[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 sv = __ldg(reinterpret_cast<const float2*>(srow[i] + d0));
        hi[i][0] = fmaxf(t[i][0] + bb.x, 0.f) * sv.x;
        hi[i][1] = fmaxf(t[i][1] + bb.y, 0.f) * sv.y;
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
        *reinterpret_cast<float4*>(hi_t + (2 * kg + j) * kPad + 4 * rg) =
            make_float4(hi[0][j], hi[1][j], hi[2][j], hi[3][j]);
    }
    __syncthreads();

    {  // acc += hi_chunk @ wh_chunk.
      const float* wb = wh_s + buf * kWh + 4 * lane;
      const float* hb = hi_t + 8 * warp;
#pragma unroll 4
      for (int k = 0; k < kKC; ++k) {
        const float4 a0 = *reinterpret_cast<const float4*>(hb + k * kPad);
        const float4 a1 = *reinterpret_cast<const float4*>(hb + k * kPad + 4);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 bv =
              *reinterpret_cast<const float4*>(wb + k * kH + 128 * j);
#pragma unroll
          for (int r = 0; r < 8; ++r) fma4(&acc[r][4 * j], av[r], bv);
        }
      }
    }
  }

  // Epilogue: h = relu(acc + bh), kept in registers.
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float4 bb =
        __ldg(reinterpret_cast<const float4*>(bh + 4 * lane + 128 * j));
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      acc[r][4 * j + 0] = fmaxf(acc[r][4 * j + 0] + bb.x, 0.f);
      acc[r][4 * j + 1] = fmaxf(acc[r][4 * j + 1] + bb.y, 0.f);
      acc[r][4 * j + 2] = fmaxf(acc[r][4 * j + 2] + bb.z, 0.f);
      acc[r][4 * j + 3] = fmaxf(acc[r][4 * j + 3] + bb.w, 0.f);
    }
  }
  const int wrow0 = row0 + 8 * warp;
  if (kResiduals) {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      if (wrow0 + r < rows) {
        float* hp = h + (long long)(wrow0 + r) * kH + 4 * lane;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<float4*>(hp + 128 * j) =
              make_float4(acc[r][4 * j], acc[r][4 * j + 1], acc[r][4 * j + 2],
                          acc[r][4 * j + 3]);
      }
    }
  }

  // q[row][o] = sum over the 512 columns of h[row][col] * wo[col][o] + bo[o]:
  // 16 columns per lane, then a shuffle tree over the warp's 32 lanes.
  for (int o = 0; o < a; ++o) {
    float w[16];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        w[4 * j + e] = __ldg(wo + (long long)(4 * lane + 128 * j + e) * a + o);
    const float bias = __ldg(bo + o);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      float p = 0.f;
#pragma unroll
      for (int e = 0; e < 16; ++e) p = fmaf(acc[r][e], w[e], p);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        p += __shfl_xor_sync(0xffffffffu, p, off);
      if (lane == 0 && wrow0 + r < rows)
        q[(long long)(wrow0 + r) * a + o] = p + bias;
    }
  }
}

}  // namespace

// cos (b*s, 64), semb (b, d), we (64, d), be (d), wh (d, 512), bh (512),
// wo (512, a), bo (a) -> q (b*s, a) and, when residuals != 0, h (b*s, 512).
// d must be a multiple of 32. Returns cudaGetLastError().
extern "C" int dz_iqn_head(const void* cos, const void* semb, const void* we,
                           const void* be, const void* wh, const void* bh,
                           const void* wo, const void* bo, void* q, void* h,
                           int b, int s, int d, int a, int residuals,
                           void* cuda_stream) {
  cudaStream_t st = (cudaStream_t)cuda_stream;
  const int rows = b * s;
  const int blocks = (rows + kM - 1) / kM;
  cudaError_t err;
  if (residuals) {
    err = cudaFuncSetAttribute(iqn_head_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmem);
    if (err != cudaSuccess) return (int)err;
    if (blocks > 0)
      iqn_head_kernel<true><<<blocks, kThreads, kSmem, st>>>(
          (const float*)cos, (const float*)semb, (const float*)we,
          (const float*)be, (const float*)wh, (const float*)bh,
          (const float*)wo, (const float*)bo, (float*)q, (float*)h, rows, s,
          b, d, a);
  } else {
    err = cudaFuncSetAttribute(iqn_head_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmem);
    if (err != cudaSuccess) return (int)err;
    if (blocks > 0)
      iqn_head_kernel<false><<<blocks, kThreads, kSmem, st>>>(
          (const float*)cos, (const float*)semb, (const float*)we,
          (const float*)be, (const float*)wh, (const float*)bh,
          (const float*)wo, (const float*)bo, (float*)q, nullptr, rows, s, b,
          d, a);
  }
  return (int)cudaGetLastError();
}
