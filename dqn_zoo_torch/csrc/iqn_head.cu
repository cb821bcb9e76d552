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
// Bound on the H100: operations. The two products cos @ we (11 % of the
// flops) and hi @ wh (89 %) run on the TF32 tensor cores in 3xTF32: each f32
// operand x is split into big = rna_tf32(x) and small = rna_tf32(x - big),
// and big*big + big*small + small*big is accumulated in f32, which keeps the
// sums within f32 rounding (the TPU kernel's `_dot` with mm = float32 is the
// same multi-pass idea on the MXU). Three TF32 products per f32 product at
// the card's 495 TFLOP/s dense TF32 rate make an effective 165 TFLOP/s, 2.5x
// the 67 TFLOP/s of f32 on the CUDA cores; that is the bound this kernel is
// measured against. The products are `mma.sync.m16n8k8` with TF32 operands.
// `wgmma` is left for later: its TF32 form takes both operands K-major, and
// wh is (D, 512) row-major (N-major), so it would need a transposed copy of
// wh; bf16 operands would leave the reference's f32 numerics.
//
// Design: one block of 256 threads (8 warps) per tile of 64 consecutive rows,
// the (64, 512) pre-activation of h in registers: a warp owns all 64 rows and
// 64 columns, 4 x 8 mma tiles of 16 x 8, 128 floats per thread. D is a loop
// inside the block in chunks of 32, with one barrier per chunk. Between two
// barriers, for chunk c, each warp
//   1. starts the copies of wh's chunk c + 1 (32 x 512) and we's chunk c + 2
//      (64 x 32) towards the free shared-memory buffers with cp.async;
//   2. computes te's chunk c + 1 (its 16 rows x 16 columns of 64 x 32) on the
//      tensor cores from the resident cosine tile, then bias, ReLU and the
//      s_emb factor (loaded into registers a chunk ahead), and stores hi's
//      chunk c + 1, already split into big and small parts, to the other of
//      two hi buffers;
//   3. adds hi's chunk c @ wh's chunk c into its accumulator, splitting its wh
//      B fragments as it loads them.
// So the te products of one warp overlap the main products of the others.
// The tensor cores accumulate in f32 with truncation, which over the 392
// k-steps of D would bias the sums by tens of ulps; each k-step's three
// products therefore go into a zeroed 16 x 8 tile that is then added to the
// accumulator by an f32 add that rounds to nearest.
// The A tiles (cosine tile, hi chunks) are stored in the mma's fragment
// order, so that a thread's four A values arrive by one 16-byte load in the
// order the mma takes them (a row-major tile costs four register moves per
// fragment, and those moves, not the tensor cores, set the pace). Row
// strides of 40 and 520 floats for the B tiles (we, wh chunks) keep their
// fragment loads free of bank conflicts. The rounding to TF32 is done with
// an integer add and mask, the same rounding as cvt.rna.tf32.f32 for every
// finite input and in fewer instructions.
//
// Small grids: with few row tiles (eval at B = 4 is 4 tiles on 132 SMs) the
// wrapper also splits D over a second grid axis (`d_splits` in
// nets/iqn_head.py); each block then writes its raw (64, 512) partial of
// hi @ wh to a scratch buffer, and a second small kernel of the same launch
// adds the partials in split order, then bias, ReLU, h and q. With one split
// the main kernel keeps its own epilogue: bias and ReLU in registers, h
// stored when asked for, q by sums over the thread's 16 columns, then over
// the quad (shuffles), then over the 8 warps' column slabs through shared
// memory in warp order. No atomics anywhere: the result is the same from run
// to run.
//
// Shared memory: split cosine tile 32 KB + 2 x split hi chunk 32 KB + 2 x we
// chunk 20 KB + 2 x wh chunk 130 KB = 214 KB, one block per SM.
//
// The bf16 mode (the reference's `_fwd_call` with mm = bfloat16) is a kernel
// of its own on bf16 `wgmma`: csrc/iqn_head_bf16.cu.

#include <cstdint>
#include <cuda_runtime.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kL = 64;    // cosine features per tau sample
constexpr int kH = 512;   // hidden width
constexpr int kM = 64;    // rows per block
constexpr int kKC = 32;   // columns of D per chunk
constexpr int kWeS = kKC + 8;
constexpr int kWhS = kH + 8;
constexpr int kCos = kM * kL;      // floats of one part (big or small)
constexpr int kHi = kM * kKC;
constexpr int kWe = kL * kWeS;     // floats of one buffer
constexpr int kWh = kKC * kWhS;
constexpr int kSmem = (2 * kCos + 4 * kHi + 2 * kWe + 2 * kWh) * 4;  // 219136 B
constexpr int kWarpCols = kH / kWarps;  // columns of h per warp
constexpr int kJ = kWarpCols / 8;       // mma column tiles per warp
constexpr int kTeJ = 16 / kWarps;       // te column tiles per warp (4 x 4)
constexpr int kQA = 16;   // outputs of q per pass of the epilogue
constexpr int kFinThreads = kH / 4;  // the second kernel: 4 columns a thread
constexpr int kFinQA = 8;
constexpr int kMaxDevices = 64;

// grid (row tiles, splits); split y walks chunks [y * per, (y + 1) * per).
template <bool kResiduals>
__global__ void __launch_bounds__(kThreads, 1)
iqn_head_kernel(const float* __restrict__ cosx, const float* __restrict__ semb,
                const float* __restrict__ we, const float* __restrict__ be,
                const float* __restrict__ wh, const float* __restrict__ bh,
                const float* __restrict__ wo, const float* __restrict__ bo,
                float* __restrict__ q, float* __restrict__ h,
                float* __restrict__ part, int rows, int s, int nb, int d,
                int a, int per) {
  extern __shared__ __align__(16) float smem[];
  float* cos_b = smem;              // fragment order (frag_at<8>), big part
  float* cos_s = cos_b + kCos;      //   and small part
  float* hi_s = cos_s + kCos;       // [2 buffers][big, small] frag_at<4>
  float* we_s = hi_s + 4 * kHi;     // [2][kL][kWeS]
  float* wh_s = we_s + 2 * kWe;     // [2][kKC][kWhS]
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * kM;
  const int c_begin = blockIdx.y * per;
  const int c_end = min(c_begin + per, d / kKC);

  // Copies of wh's chunk c towards buffer c & 1, and of we's.
  auto copy_wh = [&](int c) {
    const float* src = wh + (long long)c * kKC * kH;
    float* dst = wh_s + (c & 1) * kWh;
    for (int i = tid; i < kKC * kH / 4; i += kThreads) {
      const int k = i >> 7, c4 = i & 127;
      cp_async16(dst + k * kWhS + 4 * c4, src + k * kH + 4 * c4);
    }
  };
  auto copy_we = [&](int c) {
    float* dst = we_s + (c & 1) * kWe;
    for (int i = tid; i < kL * kKC / 4; i += kThreads) {
      const int l = i >> 3, c4 = i & 7;
      cp_async16(dst + l * kWeS + 4 * c4,
                 we + (long long)l * d + c * kKC + 4 * c4);
    }
  };
  copy_wh(c_begin);
  copy_we(c_begin);
  if (c_begin + 1 < c_end) copy_we(c_begin + 1);
  cp_async_commit();

  // The tile's cosine features, split; rows past the end are zero.
  for (int i = tid; i < kM * kL / 4; i += kThreads) {
    const int r = i >> 4, c4 = i & 15;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < rows)
      v = __ldg(reinterpret_cast<const float4*>(
                    cosx + (long long)(row0 + r) * kL) + c4);
    const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      store_split(cos_b, cos_s, frag_at<kL / 8>(r, 4 * c4 + j), e[j]);
  }

  // te phase: this warp's 16 rows (tile rt) x 16 chunk columns (tiles ct,
  // ct + 1), and where its two rows' stream embeddings start (rows past the
  // end read the last stream). The bias and s_emb values of the next te
  // chunk are loaded one chunk ahead.
  const int rt = warp & 3, ct = (warp >> 2) * kTeJ;
  const float* srow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    int st = (row0 + 16 * rt + g + 8 * i) / s;
    st = st < nb ? st : nb - 1;
    srow[i] = semb + (long long)st * d + 8 * ct + 2 * t;
  }
  const float* brow = be + 8 * ct + 2 * t;
  float2 pre_b[kTeJ], pre_s[2][kTeJ];  // [j], [i][j]
  auto load_pre = [&](int c) {
#pragma unroll
    for (int j = 0; j < kTeJ; ++j) {
      pre_b[j] = __ldg(reinterpret_cast<const float2*>(brow + c * kKC + 8 * j));
#pragma unroll
      for (int i = 0; i < 2; ++i)
        pre_s[i][j] = __ldg(
            reinterpret_cast<const float2*>(srow[i] + c * kKC + 8 * j));
    }
  };
  load_pre(c_begin);

  // te and hi for chunk c into hi buffer c & 1; then loads the next
  // chunk's bias and s_emb values.
  auto te_phase = [&](int c) {
    float te[kTeJ][4] = {};
    const float* wb = we_s + (c & 1) * kWe + 8 * ct + g + t * kWeS;
#pragma unroll
    for (int ks = 0; ks < kL / 8; ++ks) {
      uint32_t ab[4], as[4];
      load_a(ab, cos_b + rt * kL * 16, ks, lane);
      load_a(as, cos_s + rt * kL * 16, ks, lane);
#pragma unroll
      for (int j = 0; j < kTeJ; ++j) {
        uint32_t bb[2], bs[2];
        load_b(bb, bs, wb + 8 * ks * kWeS + 8 * j, kWeS);
        mma_3xtf32(te[j], ab, as, bb, bs);
      }
    }
    float* hb = hi_s + (c & 1) * 2 * kHi;
#pragma unroll
    for (int j = 0; j < kTeJ; ++j) {
      const int col = 8 * (ct + j) + 2 * t;  // accumulator columns col, +1
#pragma unroll
      for (int i = 0; i < 2; ++i) {  // rows g (c0, c1) and g + 8 (c2, c3)
        const int m = 16 * rt + g + 8 * i;
        store_split(hb, hb + kHi, frag_at<kKC / 8>(m, col),
                    fmaxf(te[j][2 * i] + pre_b[j].x, 0.f) * pre_s[i][j].x);
        store_split(hb, hb + kHi, frag_at<kKC / 8>(m, col + 1),
            fmaxf(te[j][2 * i + 1] + pre_b[j].y, 0.f) * pre_s[i][j].y);
      }
    }
    if (c + 1 < c_end) load_pre(c + 1);
  };

  float acc[4][kJ][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  cp_async_wait_all();
  __syncthreads();  // the cosine tile and the first chunks have landed
  te_phase(c_begin);
  for (int c = c_begin; c < c_end; ++c) {
    cp_async_wait_all();
    __syncthreads();  // hi and wh of chunk c and we of chunk c + 1 are in;
                      // everyone has left chunk c - 1
    if (c + 1 < c_end) {
      copy_wh(c + 1);
      if (c + 2 < c_end) copy_we(c + 2);
      cp_async_commit();
      te_phase(c + 1);
    }
    // acc += hi chunk @ wh chunk, this warp's columns.
    const float* hb = hi_s + (c & 1) * 2 * kHi;
    const float* wb = wh_s + (c & 1) * kWh + kWarpCols * warp + g + t * kWhS;
#pragma unroll
    for (int ks = 0; ks < kKC / 8; ++ks) {
      uint32_t bb[kJ][2], bs[kJ][2];
#pragma unroll
      for (int j = 0; j < kJ; ++j)
        load_b(bb[j], bs[j], wb + 8 * ks * kWhS + 8 * j, kWhS);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t ab[4], as[4];
        load_a(ab, hb + i * kKC * 16, ks, lane);
        load_a(as, hb + kHi + i * kKC * 16, ks, lane);
#pragma unroll
        for (int j = 0; j < kJ; ++j)
          mma_3xtf32_rn(acc[i][j], ab, as, bb[j], bs[j]);
      }
    }
  }

  // This thread's accumulator (i, j, e) is row 16 i + g + 8 (e >> 1) of the
  // tile and column kWarpCols warp + 8 j + 2 t + (e & 1).
  const int col0 = kWarpCols * warp + 2 * t;
  if (gridDim.y > 1) {  // raw partial of split y; the second kernel ends it
    float* pp = part + (long long)blockIdx.y * rows * kH;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = row0 + 16 * i + g + 8 * e;
        if (r < rows) {
#pragma unroll
          for (int j = 0; j < kJ; ++j)
            *reinterpret_cast<float2*>(pp + (long long)r * kH + col0 + 8 * j) =
                make_float2(acc[i][j][2 * e], acc[i][j][2 * e + 1]);
        }
      }
    return;
  }

  // h = relu(acc + bh), kept in registers; stored when asked for.
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    const float2 bb = __ldg(reinterpret_cast<const float2*>(bh + col0 + 8 * j));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[i][j][0] = fmaxf(acc[i][j][0] + bb.x, 0.f);
      acc[i][j][1] = fmaxf(acc[i][j][1] + bb.y, 0.f);
      acc[i][j][2] = fmaxf(acc[i][j][2] + bb.x, 0.f);
      acc[i][j][3] = fmaxf(acc[i][j][3] + bb.y, 0.f);
    }
  }
  if (kResiduals) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = row0 + 16 * i + g + 8 * e;
        if (r < rows) {
#pragma unroll
          for (int j = 0; j < kJ; ++j)
            *reinterpret_cast<float2*>(h + (long long)r * kH + col0 + 8 * j) =
                make_float2(acc[i][j][2 * e], acc[i][j][2 * e + 1]);
        }
      }
  }

  // q[row][o] = sum over the 512 columns of h[row][col] wo[col][o] + bo[o]:
  // the thread's columns, then the quad, then the warps in warp order
  // through shared memory (over the wh buffers, which every warp has left).
  __syncthreads();
  float* red = wh_s;  // [kWarps][kM rows][kQA outputs]
  for (int o0 = 0; o0 < a; o0 += kQA) {
    const int na = min(kQA, a - o0);
    for (int o = 0; o < na; ++o) {
      float w[kJ][2];
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        w[j][0] = __ldg(wo + (long long)(col0 + 8 * j) * a + o0 + o);
        w[j][1] = __ldg(wo + (long long)(col0 + 8 * j + 1) * a + o0 + o);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float p = 0.f;
#pragma unroll
          for (int j = 0; j < kJ; ++j) {
            p = fmaf(acc[i][j][2 * e], w[j][0], p);
            p = fmaf(acc[i][j][2 * e + 1], w[j][1], p);
          }
          p += __shfl_xor_sync(0xffffffffu, p, 1);
          p += __shfl_xor_sync(0xffffffffu, p, 2);
          if (t == 0) red[(warp * kM + 16 * i + g + 8 * e) * kQA + o] = p;
        }
    }
    __syncthreads();
    for (int x = tid; x < kM * na; x += kThreads) {
      const int m = x / na, o = x - m * na;
      if (row0 + m < rows) {
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) sum += red[(w * kM + m) * kQA + o];
        q[(long long)(row0 + m) * a + o0 + o] = sum + __ldg(bo + o0 + o);
      }
    }
    __syncthreads();
  }
}

// One block per row: h = relu(sum of the splits' partials in split order +
// bh), h stored when asked for, q = h @ wo + bo by a shuffle tree over each
// warp and the 4 warps in order.
template <bool kResiduals>
__global__ void __launch_bounds__(kFinThreads)
iqn_head_finish_kernel(const float* __restrict__ part,
                       const float* __restrict__ bh,
                       const float* __restrict__ wo,
                       const float* __restrict__ bo, float* __restrict__ q,
                       float* __restrict__ h, int rows, int a, int splits) {
  __shared__ float red[kFinThreads / 32][kFinQA];
  const int r = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int col = 4 * tid;
  const long long plane = (long long)rows * kH;
  const float4* pp =
      reinterpret_cast<const float4*>(part + (long long)r * kH + col);
  float4 v = __ldg(pp);
#pragma unroll 8
  for (int z = 1; z < splits; ++z) {
    const float4 u = __ldg(pp + z * (plane / 4));
    v.x += u.x;
    v.y += u.y;
    v.z += u.z;
    v.w += u.w;
  }
  const float4 bb = __ldg(reinterpret_cast<const float4*>(bh + col));
  v.x = fmaxf(v.x + bb.x, 0.f);
  v.y = fmaxf(v.y + bb.y, 0.f);
  v.z = fmaxf(v.z + bb.z, 0.f);
  v.w = fmaxf(v.w + bb.w, 0.f);
  if (kResiduals)
    *reinterpret_cast<float4*>(h + (long long)r * kH + col) = v;
  for (int o0 = 0; o0 < a; o0 += kFinQA) {
    const int na = min(kFinQA, a - o0);
    for (int o = 0; o < na; ++o) {
      const float* wp = wo + (long long)col * a + o0 + o;
      float p = v.x * __ldg(wp);
      p = fmaf(v.y, __ldg(wp + a), p);
      p = fmaf(v.z, __ldg(wp + 2 * a), p);
      p = fmaf(v.w, __ldg(wp + 3 * a), p);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        p += __shfl_xor_sync(0xffffffffu, p, off);
      if (lane == 0) red[warp][o] = p;
    }
    __syncthreads();
    if (tid < na) {
      float sum = 0.f;
#pragma unroll
      for (int w4 = 0; w4 < kFinThreads / 32; ++w4) sum += red[w4][tid];
      q[(long long)r * a + o0 + tid] = sum + __ldg(bo + o0 + tid);
    }
    __syncthreads();
  }
}

template <bool kResiduals>
cudaError_t launch(const void* cos, const void* semb, const void* we,
                   const void* be, const void* wh, const void* bh,
                   const void* wo, const void* bo, void* q, void* h,
                   void* part, int b, int s, int d, int a, int splits,
                   int per, cudaStream_t st) {
  static bool smem_set[kMaxDevices];  // per device, once
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(iqn_head_kernel<kResiduals>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmem);
    if (err != cudaSuccess) return err;
    smem_set[dev] = true;
  }
  const int rows = b * s;
  const int tiles = (rows + kM - 1) / kM;
  iqn_head_kernel<kResiduals>
      <<<dim3(tiles, splits), kThreads, kSmem, st>>>(
      (const float*)cos, (const float*)semb, (const float*)we,
      (const float*)be, (const float*)wh, (const float*)bh,
      (const float*)wo, (const float*)bo, (float*)q, (float*)h,
      (float*)part, rows, s, b, d, a, per);
  if (splits > 1) {
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    iqn_head_finish_kernel<kResiduals><<<rows, kFinThreads, 0, st>>>(
        (const float*)part, (const float*)bh, (const float*)wo,
        (const float*)bo, (float*)q, (float*)h, rows, a, splits);
  }
  return cudaGetLastError();
}

}  // namespace

// cos (b*s, 64), semb (b, d), we (64, d), be (d), wh (d, 512), bh (512),
// wo (512, a), bo (a) -> q (b*s, a) and, when residuals != 0, h (b*s, 512).
// d must be a multiple of 32. D is cut into `splits` runs of `per` chunks of
// 32 columns (the last may be shorter, none empty); with splits > 1, part is
// scratch of (splits, b*s, 512) floats. Returns cudaGetLastError().
extern "C" int dz_iqn_head(const void* cos, const void* semb, const void* we,
                           const void* be, const void* wh, const void* bh,
                           const void* wo, const void* bo, void* q, void* h,
                           void* part, int b, int s, int d, int a,
                           int residuals, int splits, int per,
                           void* cuda_stream) {
  cudaStream_t st = (cudaStream_t)cuda_stream;
  if (b * s <= 0) return (int)cudaGetLastError();
  if (splits < 1 || per < 1 || (splits - 1) * per >= d / kKC ||
      splits * per < d / kKC || (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  return (int)(residuals
                   ? launch<true>(cos, semb, we, be, wh, bh, wo, bo, q, h,
                                  part, b, s, d, a, splits, per, st)
                   : launch<false>(cos, semb, we, be, wh, bh, wo, bo, q, h,
                                   part, b, s, d, a, splits, per, st));
}
