// K4b and K4c: the backward kernels of the fused IQN per-tau head.
//
// Replace the TPU kernels of dqn_zoo_tpu/nets/iqn_head.py:
//   K4b `_bwd_w_call` -> `_bwd_w_kernel`   dwh, dbh
//   K4c `_bwd_d_call` -> `_bwd_d_kernel`   dwe, dbe, ds_emb, dcos
//
// For rows r = (stream, tau) pairs with tau minor, all in float32, given
// dh (rows, 512), the cotangent of the hidden pre-activation (already masked
// by h > 0), both recompute
//   te_pre = cos @ we + be,  te = relu(te_pre),  hi = te * s_emb[r / S]
// and then
//   K4b: dwh = hi^T @ dh (D, 512),  dbh = sum_rows dh (512)
//   K4c: dhi = dh @ wh^T (rows, D)
//        ds_emb[b] = sum over the stream's rows of dhi * te      (B, D)
//        dte = (te_pre > 0) * dhi * s_emb[r / S]
//        dwe = cos^T @ dte (64, D),  dbe = sum_rows dte (D)
//        dcos = dte @ we^T (rows, 64), only when asked for
// Like the TPU kernels, the (rows, D) tensors te, hi, dhi and dte never reach
// device memory.
//
// The TPU kernels walk row tiles on a sequential grid and add each tile's
// dwh, dwe and dbe into a resident output. A CUDA grid has no order, so here
// the loop is turned round: one block owns 32 columns of D (D / 32 = 98 at
// D = 3136) and walks the rows in steps. Every sum over rows then lives in
// one block's registers from its first row to its last:
//   K4b: the block's (32, 512) tile of dwh, 8 x 8 per thread;
//   K4c: its (64, 32) tile of dwe, its 32 entries of dbe and the running
//        per-stream sum of ds_emb, written out whenever the stream index
//        r / S changes (rows arrive in order, so any B and S are taken and a
//        stream may straddle steps).
// Each sum is taken by one thread in row order: no atomics, results repeat
// bit for bit. 98 blocks would leave 34 of the card's 132 SMs idle, so at
// large B the streams are cut into G consecutive groups (the grid's second
// axis, G <= 4, chosen by the wrapper from the shape alone): each block
// walks its group's rows, writes its sums to partial g, and a small second
// kernel adds the G partials in group order. A group holds whole streams,
// so ds_emb needs no partial.
//
// dcos is the one sum over D, so over blocks: each block writes its partial
// (rows, 64) product into a scratch buffer and the same small kernel adds the
// 98 partials in block order. The learn step draws its cosine features from
// tau samples and needs no dcos: a null pointer skips all of it.
//
// Bound on the H100: operations (f32 FMAs on the CUDA cores, no tensor
// cores in this version). At the learn shape (B = 1024, S = 64) K4b is
// 237 GFLOP and K4c 289 GFLOP against 151 MB and 170 MB of inputs.
//
// The thread's column of we (64 values) is kept in registers for the whole
// walk, so the te recompute reads only broadcast cosine rows from shared
// memory. cos and dh steps arrive by cp.async into a second buffer under the
// arithmetic of the current step.
//
// K4c's 512-deep product dhi = dh_step (16, 512) @ wh_tile^T (512, 32) has
// only 512 outputs per step, so the depth is split over the 8 warps (64 each,
// 4 rows x 4 columns per lane) and the 8 partials are added in warp order
// through shared memory. The block's 32 rows of wh (64 KB, one contiguous run)
// stay resident in shared memory.
//
// ReLU branch: te_pre is summed here in another order than a library product
// sums it, so an entry within rounding of 0 may take the other branch and
// move dte by a whole term. K4c can write its own branch bits (te_pre > 0) to
// a (rows, D) byte mask so that a check can hold the arithmetic apart from
// those flips.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kL = 64;    // cosine features per tau sample
constexpr int kH = 512;   // hidden width
constexpr int kDC = 32;   // columns of D per block

// K4b: rows per step, shared-memory floats.
constexpr int kRW = 32;
constexpr int kSmemW = (2 * kRW * kL + 2 * kRW * kH + kRW * kDC) * 4;

// K4c: rows per step and padded strides (see the bank notes at each use).
constexpr int kRD = 16;
constexpr int kHS = kH + 4;    // row stride of the wh tile and the dh steps
constexpr int kRS = 40;        // row stride of the depth-split partials
constexpr int kWS = kDC + 4;   // row stride of the we tile (dcos only)
constexpr int kSmemD = (kDC * kHS + 2 * kRD * kHS + 2 * kRD * kL +
                        8 * kRD * kRS + 2 * kRD * kDC + kL * kWS) * 4;

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

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// First stream of group g when nb streams are cut into `groups` consecutive
// groups (group_begin(groups, ...) = nb).
__device__ __forceinline__ int group_begin(int g, int groups, int nb) {
  return (int)((long long)g * nb / groups);
}

// Starts `nrows` rows of `width` floats, from global row `row0` on, towards
// shared rows of stride `stride`; rows past the end are zero-filled.
template <int kWidth>
__device__ __forceinline__ void fetch_rows(float* dst, int stride,
                                           const float* src, int row0,
                                           int nrows, int rows, int tid) {
  constexpr int kVec = kWidth / 4;
  for (int i = tid; i < nrows * kVec; i += kThreads) {
    const int r = i / kVec, c4 = i % kVec;
    float* p = dst + r * stride + 4 * c4;
    if (row0 + r < rows)
      cp_async16(p, src + (long long)(row0 + r) * kWidth + 4 * c4);
    else
      *reinterpret_cast<float4*>(p) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// te_pre of one row for this thread's column: bias + cos_row . we_column.
__device__ __forceinline__ float te_pre_of(const float* cos_row,
                                           const float (&wreg)[kL],
                                           float bias) {
  float t = bias;
#pragma unroll
  for (int l4 = 0; l4 < kL / 4; ++l4) {
    const float4 cv = *reinterpret_cast<const float4*>(cos_row + 4 * l4);
    t = fmaf(cv.x, wreg[4 * l4 + 0], t);
    t = fmaf(cv.y, wreg[4 * l4 + 1], t);
    t = fmaf(cv.z, wreg[4 * l4 + 2], t);
    t = fmaf(cv.w, wreg[4 * l4 + 3], t);
  }
  return t;
}

// ---------------------------------------------------------------- K4b ------

__global__ void __launch_bounds__(kThreads, 1)
iqn_head_bwd_w_kernel(const float* __restrict__ cosx,
                      const float* __restrict__ semb,
                      const float* __restrict__ dh,
                      const float* __restrict__ we,
                      const float* __restrict__ be,
                      float* __restrict__ out,  // [groups][d * 512 + 512]
                      int s, int nb, int d) {
  extern __shared__ __align__(16) float smem[];
  float* cos_s = smem;                     // [2][kRW][kL]
  float* dh_s = cos_s + 2 * kRW * kL;      // [2][kRW][kH]
  float* hi_s = dh_s + 2 * kRW * kH;       // [kRW][kDC]
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int d0 = blockIdx.x * kDC;
  // This block's group of streams, and its rows [row_lo, rows).
  const int row_lo = group_begin(blockIdx.y, gridDim.y, nb) * s;
  const int rows = group_begin(blockIdx.y + 1, gridDim.y, nb) * s;
  const int nsteps = (rows - row_lo + kRW - 1) / kRW;

  auto prefetch = [&](int c) {
    const int buf = c & 1;
    const int r0 = row_lo + c * kRW;
    fetch_rows<kL>(cos_s + buf * kRW * kL, kL, cosx, r0, kRW, rows, tid);
    fetch_rows<kH>(dh_s + buf * kRW * kH, kH, dh, r0, kRW, rows, tid);
    cp_async_commit();
  };
  prefetch(0);

  // This thread's column d0 + lane of we and be, for the whole walk.
  float wreg[kL];
#pragma unroll
  for (int l = 0; l < kL; ++l) wreg[l] = __ldg(we + (long long)l * d + d0 + lane);
  const float bias = __ldg(be + d0 + lane);

  // Product phase: warp (dg, hh) owns dwh rows d0 + 8 dg .. + 7 and columns
  // 256 hh + {4 lane .. + 3} and + 128: head-input reads are broadcasts,
  // dh reads conflict-free float4s.
  const int dg = warp & 3, hh = warp >> 2;
  const bool sums_dbh = blockIdx.x == 0 && dg == 0;
  float* dwh = out + (long long)blockIdx.y * ((long long)d * kH + kH);
  float* dbh = dwh + (long long)d * kH;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float bsum[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};

  for (int c = 0; c < nsteps; ++c) {
    cp_async_wait_all();
    __syncthreads();  // step c has landed; everyone has left step c - 1
    if (c + 1 < nsteps) prefetch(c + 1);
    const int buf = c & 1;
    const int r0 = row_lo + c * kRW;

    // hi for rows 4 warp .. + 3 of the step, column lane of the tile.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * warp + i;
      const float t = te_pre_of(cos_s + (buf * kRW + r) * kL, wreg, bias);
      int st = (r0 + r) / s;
      st = st < nb ? st : nb - 1;  // rows past the end: dh is zero there
      hi_s[r * kDC + lane] =
          fmaxf(t, 0.f) * __ldg(semb + (long long)st * d + d0 + lane);
    }
    __syncthreads();

    const float* hb = hi_s + 8 * dg;
    const float* db = dh_s + buf * kRW * kH + 256 * hh + 4 * lane;
#pragma unroll 4
    for (int r = 0; r < kRW; ++r) {
      const float4 a0 = *reinterpret_cast<const float4*>(hb + r * kDC);
      const float4 a1 = *reinterpret_cast<const float4*>(hb + r * kDC + 4);
      const float4 b0 = *reinterpret_cast<const float4*>(db + r * kH);
      const float4 b1 = *reinterpret_cast<const float4*>(db + r * kH + 128);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        fma4(&acc[i][0], av[i], b0);
        fma4(&acc[i][4], av[i], b1);
      }
      if (sums_dbh) {
        bsum[0] += b0.x; bsum[1] += b0.y; bsum[2] += b0.z; bsum[3] += b0.w;
        bsum[4] += b1.x; bsum[5] += b1.y; bsum[6] += b1.z; bsum[7] += b1.w;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* p = dwh + (long long)(d0 + 8 * dg + i) * kH + 256 * hh + 4 * lane;
    *reinterpret_cast<float4*>(p) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(p + 128) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
  if (sums_dbh) {
    float* p = dbh + 256 * hh + 4 * lane;
    *reinterpret_cast<float4*>(p) =
        make_float4(bsum[0], bsum[1], bsum[2], bsum[3]);
    *reinterpret_cast<float4*>(p + 128) =
        make_float4(bsum[4], bsum[5], bsum[6], bsum[7]);
  }
}

// ---------------------------------------------------------------- K4c ------

__global__ void __launch_bounds__(kThreads, 1)
iqn_head_bwd_d_kernel(const float* __restrict__ cosx,
                      const float* __restrict__ semb,
                      const float* __restrict__ dh,
                      const float* __restrict__ we,
                      const float* __restrict__ be,
                      const float* __restrict__ wh,
                      float* __restrict__ out,  // [groups][64 * d + d]
                      float* __restrict__ dsemb,
                      float* __restrict__ dcos_part,   // null: no dcos
                      uint8_t* __restrict__ te_mask,   // null: not written
                      int s, int nb, int d) {
  extern __shared__ __align__(16) float smem[];
  float* wh_s = smem;                       // [kDC][kHS]
  float* dh_s = wh_s + kDC * kHS;           // [2][kRD][kHS]
  float* cos_s = dh_s + 2 * kRD * kHS;      // [2][kRD][kL]
  float* red_s = cos_s + 2 * kRD * kL;      // [8][kRD][kRS]
  float* dte_s = red_s + 8 * kRD * kRS;     // [kRD][kDC]
  float* g_s = dte_s + kRD * kDC;           // [kRD][kDC]: dhi * te
  float* we_s = g_s + kRD * kDC;            // [kL][kWS]
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int d0 = blockIdx.x * kDC;
  // This block's group of streams, and its rows [row_lo, rows).
  const int row_lo = group_begin(blockIdx.y, gridDim.y, nb) * s;
  const int rows = group_begin(blockIdx.y + 1, gridDim.y, nb) * s;
  const int nsteps = (rows - row_lo + kRD - 1) / kRD;

  auto prefetch = [&](int c) {
    const int buf = c & 1;
    const int r0 = row_lo + c * kRD;
    fetch_rows<kL>(cos_s + buf * kRD * kL, kL, cosx, r0, kRD, rows, tid);
    fetch_rows<kH>(dh_s + buf * kRD * kHS, kHS, dh, r0, kRD, rows, tid);
    cp_async_commit();
  };
  // The block's 32 rows of wh, resident for the whole walk (d is a multiple
  // of 32, so none is past the end), with step 0.
  fetch_rows<kH>(wh_s, kHS, wh, d0, kDC, d, tid);
  prefetch(0);

  float wreg[kL];
#pragma unroll
  for (int l = 0; l < kL; ++l) wreg[l] = __ldg(we + (long long)l * d + d0 + lane);
  const float bias = __ldg(be + d0 + lane);
  if (dcos_part != nullptr)
    for (int i = tid; i < kL * kDC; i += kThreads)
      we_s[(i / kDC) * kWS + (i % kDC)] =
          __ldg(we + (long long)(i / kDC) * d + d0 + (i % kDC));

  // Walk-long sums: dwe rows 8 warp .. + 7 at column lane; dbe (warp 0) and
  // the running ds_emb of stream `cur` (warp 1) at column lane.
  float dwe_acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float dbe_acc = 0.f, ds_acc = 0.f;
  int cur = -1;

  // dhi phase: warp = depth slice [64 warp, 64 warp + 64); the lane owns rows
  // rg + 4 i and tile columns kg + 8 j. With the row stride of 516 floats the
  // 4 dh rows and the 8 wh rows a warp reads at once fall on distinct banks.
  const int rg = lane >> 3, kg = lane & 7;

  for (int c = 0; c < nsteps; ++c) {
    cp_async_wait_all();
    __syncthreads();  // step c has landed; everyone has left step c - 1
    if (c + 1 < nsteps) prefetch(c + 1);
    const int buf = c & 1;
    const int r0 = row_lo + c * kRD;
    const float* cosb = cos_s + buf * kRD * kL;

    {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      const float* ab = dh_s + buf * kRD * kHS + rg * kHS + 64 * warp;
      const float* bb = wh_s + kg * kHS + 64 * warp;
#pragma unroll 4
      for (int h4 = 0; h4 < 16; ++h4) {
        float4 a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = *reinterpret_cast<const float4*>(ab + 4 * i * kHS + 4 * h4);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          b[j] = *reinterpret_cast<const float4*>(bb + 8 * j * kHS + 4 * h4);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = dot4(a[i], b[j], acc[i][j]);
      }
      // Row stride 40: the 32 lanes of one store fall on 32 banks.
      float* rp = red_s + (warp * kRD + rg) * kRS + kg;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) rp[4 * i * kRS + 8 * j] = acc[i][j];
    }
    __syncthreads();

    // Elementwise phase: rows warp and warp + 8 of the step, column lane.
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      const int r = warp + 8 * ii;
      const int row = r0 + r;
      float dhi = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) dhi += red_s[(w * kRD + r) * kRS + lane];
      const float tp = te_pre_of(cosb + r * kL, wreg, bias);
      int st = row / s;
      st = st < nb ? st : nb - 1;  // rows past the end: dhi is zero there
      const float sv = __ldg(semb + (long long)st * d + d0 + lane);
      const bool pos = tp > 0.f;
      g_s[r * kDC + lane] = dhi * fmaxf(tp, 0.f);
      dte_s[r * kDC + lane] = pos ? dhi * sv : 0.f;
      if (te_mask != nullptr && row < rows)
        te_mask[(long long)row * d + d0 + lane] = pos ? 1 : 0;
    }
    __syncthreads();

    // Sums over the step's rows, in row order.
#pragma unroll 4
    for (int r = 0; r < kRD; ++r) {
      const float x = dte_s[r * kDC + lane];
      const float4 c0 =
          *reinterpret_cast<const float4*>(cosb + r * kL + 8 * warp);
      const float4 c1 =
          *reinterpret_cast<const float4*>(cosb + r * kL + 8 * warp + 4);
      dwe_acc[0] = fmaf(c0.x, x, dwe_acc[0]);
      dwe_acc[1] = fmaf(c0.y, x, dwe_acc[1]);
      dwe_acc[2] = fmaf(c0.z, x, dwe_acc[2]);
      dwe_acc[3] = fmaf(c0.w, x, dwe_acc[3]);
      dwe_acc[4] = fmaf(c1.x, x, dwe_acc[4]);
      dwe_acc[5] = fmaf(c1.y, x, dwe_acc[5]);
      dwe_acc[6] = fmaf(c1.z, x, dwe_acc[6]);
      dwe_acc[7] = fmaf(c1.w, x, dwe_acc[7]);
      if (warp == 0) dbe_acc += x;
    }
    if (warp == 1) {
      for (int r = 0; r < kRD && r0 + r < rows; ++r) {
        const int st = (r0 + r) / s;
        if (st != cur) {  // the stream's rows are over: write its sum
          if (cur >= 0) dsemb[(long long)cur * d + d0 + lane] = ds_acc;
          ds_acc = 0.f;
          cur = st;
        }
        ds_acc += g_s[r * kDC + lane];
      }
    }
    if (dcos_part != nullptr) {
      // This block's share of dcos: row tid / 16 of the step, columns
      // l4 + 16 e (row stride 36 keeps the we reads apart).
      const int r = tid >> 4, l4 = tid & 15;
      float p[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int k4 = 0; k4 < kDC / 4; ++k4) {
        const float4 dv =
            *reinterpret_cast<const float4*>(dte_s + r * kDC + 4 * k4);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[e] = dot4(dv, *reinterpret_cast<const float4*>(
                              we_s + (l4 + 16 * e) * kWS + 4 * k4), p[e]);
      }
      if (r0 + r < rows) {
        float* out =
            dcos_part + ((long long)blockIdx.x * nb * s + r0 + r) * kL + l4;
#pragma unroll
        for (int e = 0; e < 4; ++e) out[16 * e] = p[e];
      }
    }
  }

  float* dwe = out + (long long)blockIdx.y * ((long long)kL * d + d);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    dwe[(long long)(8 * warp + i) * d + d0 + lane] = dwe_acc[i];
  if (warp == 0) dwe[(long long)kL * d + d0 + lane] = dbe_acc;
  if (warp == 1 && cur >= 0) dsemb[(long long)cur * d + d0 + lane] = ds_acc;
}

// out = the nparts partials added in their order; n4 float4s each.
__global__ void sum_partials_kernel(const float4* __restrict__ part,
                                    float4* __restrict__ out, long long n4,
                                    int nparts) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  float4 acc = part[i];
  for (int c = 1; c < nparts; ++c) {
    const float4 v = part[(long long)c * n4 + i];
    acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
  }
  out[i] = acc;
}

cudaError_t sum_partials(const void* part, void* out, long long n,
                         int nparts, cudaStream_t st) {
  const long long n4 = n / 4;
  sum_partials_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0, st>>>(
      (const float4*)part, (float4*)out, n4, nparts);
  return cudaGetLastError();
}

}  // namespace

// cos (b*s, 64), semb (b, d), dh (b*s, 512), we (64, d), be (d) -> out, one
// run of d * 512 + 512 floats: dwh (d, 512) then dbh (512). With groups > 1
// (at most b) the streams are cut into that many groups and `part` is a
// scratch buffer of groups such runs; with groups == 1 it is not read.
// d must be a multiple of 32, b*s >= 1. Returns cudaGetLastError().
extern "C" int dz_iqn_head_bwd_w(const void* cos, const void* semb,
                                 const void* dh, const void* we,
                                 const void* be, void* out, void* part,
                                 int b, int s, int d, int groups,
                                 void* cuda_stream) {
  cudaStream_t st = (cudaStream_t)cuda_stream;
  cudaError_t err = cudaFuncSetAttribute(
      iqn_head_bwd_w_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemW);
  if (err != cudaSuccess) return (int)err;
  iqn_head_bwd_w_kernel<<<dim3(d / kDC, groups), kThreads, kSmemW, st>>>(
      (const float*)cos, (const float*)semb, (const float*)dh,
      (const float*)we, (const float*)be,
      (float*)(groups > 1 ? part : out), s, b, d);
  err = cudaGetLastError();
  if (err == cudaSuccess && groups > 1)
    err = sum_partials(part, out, (long long)d * kH + kH, groups, st);
  return (int)err;
}

// As above plus wh (d, 512) -> out, one run of 64 * d + d floats: dwe
// (64, d) then dbe (d), with `part` and `groups` as above; dsemb (b, d); and,
// when dcos is not null, dcos (b*s, 64) through dcos_part, a scratch buffer
// of (d / 32, b*s, 64) floats. te_mask, when not null, gets (b*s, d) bytes:
// 1 where te_pre > 0. Returns cudaGetLastError().
extern "C" int dz_iqn_head_bwd_d(const void* cos, const void* semb,
                                 const void* dh, const void* we,
                                 const void* be, const void* wh, void* out,
                                 void* part, void* dsemb, void* dcos,
                                 void* dcos_part, void* te_mask, int b, int s,
                                 int d, int groups, void* cuda_stream) {
  cudaStream_t st = (cudaStream_t)cuda_stream;
  cudaError_t err = cudaFuncSetAttribute(
      iqn_head_bwd_d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemD);
  if (err != cudaSuccess) return (int)err;
  iqn_head_bwd_d_kernel<<<dim3(d / kDC, groups), kThreads, kSmemD, st>>>(
      (const float*)cos, (const float*)semb, (const float*)dh,
      (const float*)we, (const float*)be, (const float*)wh,
      (float*)(groups > 1 ? part : out), (float*)dsemb,
      dcos ? (float*)dcos_part : nullptr, (uint8_t*)te_mask, s, b, d);
  err = cudaGetLastError();
  if (err == cudaSuccess && groups > 1)
    err = sum_partials(part, out, (long long)kL * d + d, groups, st);
  if (err == cudaSuccess && dcos != nullptr)
    err = sum_partials(dcos_part, dcos, (long long)b * s * kL, d / kDC, st);
  return (int)err;
}
