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
// one block from its first row to its last:
//   K4b: the block's (32, 512) tile of dwh, 32 x 64 per warp;
//   K4c: its (64, 32) tile of dwe, its 32 entries of dbe and the running
//        per-stream sum of ds_emb, written out whenever the stream index
//        r / S changes (rows arrive in order, so any B and S are taken and a
//        stream may straddle steps).
// Each sum is taken in a fixed order: no atomics, results repeat bit for
// bit. 98 blocks would leave 34 of the card's 132 SMs idle, so at large B the
// streams are cut into G consecutive groups (the grid's second axis, G <= 4,
// chosen by the wrapper from the shape alone): each block walks its group's
// rows, writes its sums to partial g, and a small second kernel adds the G
// partials in group order. A group holds whole streams, so ds_emb needs no
// partial.
//
// dcos is the one sum over D, so over blocks: each block writes its partial
// (rows, 64) product into a scratch buffer and the same small kernel adds the
// 98 partials in block order. The learn step draws its cosine features from
// tau samples and needs no dcos: a null pointer skips all of it.
//
// Bound on the H100: operations. At the learn shape (B = 1024, S = 64) K4b
// is 237 GFLOP and K4c (without dcos) 263 GFLOP against 151 MB and 170 MB of
// inputs.
//
// Both kernels run their products on the tensor cores in 3xTF32
// (tf32_mma.cuh; `mma.sync.m16n8k8`, the path K4a takes).
//
// K4b. A step is 64 rows, 8 k-steps of dwh; warp w owns dwh's 32 rows (the
// block's columns of D, 2 mma row tiles) x columns 64 w .. 64 w + 63 of H
// (8 mma column tiles, 64 accumulators a lane), so each A fragment serves 8
// tiles and each warp reads only its own 64 columns of dh:
//   te_pre^T = we_tile^T @ cos^T   8 k-steps over latent 64 for the warp's 8
//                                  rows of the step. Taken transposed, its
//                                  accumulators at (column, row) are exactly
//                                  dwh's A fragment of k-step w, so hi =
//                                  relu(te_pre) * s_emb[r / S] is formed in
//                                  registers, split once, and stored in
//                                  fragment order (two 16-byte stores a
//                                  lane) for all warps to load whole. we^T's
//                                  fragments are split once for the walk;
//   dwh += hi_step^T @ dh_step     8 k-steps over the step's rows; the warp's
//                                  64 columns of dh arrive in chunks of 16
//                                  rows through its own ring of 4 buffers
//                                  (cp.async, 3 chunks in flight, no block
//                                  barrier); hi has two buffers, so a step
//                                  waits at one block barrier.
// dwh sums over up to 16,384 rows per group, 2,048 k-steps. Every 4
// k-steps (kFold) their products, summed in a zeroed tile, are folded into
// dwh's accumulators with a rounding f32 add. On the card
// (tools/torch_kernel_variants.py, K4B) a fold every 4 k-steps keeps dwh
// within a tenth of its tolerance, as a fold every k-step does, and runs
// 5-7 % faster; with no fold the tensor cores' truncating adds take dwh to
// 2.6 times its elementwise tolerance.
// dbh is each lane's register sum of its 8 columns of dh over its rows in
// row order (blocks of column 0 only), added over the 4 lanes of a column
// group at the end. K4b does not share K4c's te_pre code: K4c needs te_pre
// at its dhi accumulators' positions, K4b transposed, at its A fragments'.
// Shared memory: 8 warps x 4 ring buffers of 4 KB + hi 2 x 16 KB + we^T 16
// KB + cosine rows 16 KB = 192 KB, one block per SM.
//
// K4c. A step is 128 rows; warp w owns rows 16 w .. 16 w + 15 of it and all
// 32 columns (4 mma column tiles), so each warp runs the full 512-deep
// product itself and nothing is added across warps:
//   te_pre = cos_step @ we_tile   8 k-steps, from the step's cosine rows and
//                                 the block's we tile in shared memory;
//   dhi = dh_step @ wh_tile^T     64 k-steps; the block's 32 rows of wh stay
//                                 resident in shared memory, and the warp's
//                                 16 rows of dh arrive in chunks of 32 deep
//                                 through its own ring of 4 buffers
//                                 (cp.async, 3 chunks in flight, no block
//                                 barrier);
//   dwe += cos_step^T @ dte      16 k-steps over the step's rows; the 16
//                                 tiles of the (64, 32) output are 2 per warp
//                                 and stay in registers for the whole walk.
// te_pre's and dhi's accumulators sit at the same (row, column) lane
// positions, so dte, g = dhi * te and the te_mask bits are computed in
// registers, and so is each lane's share of dbe (its rows' dte, added over
// lanes and warps in a fixed order at the end). dte is staged in shared
// memory for dwe and dcos, g for ds_emb, which the warps take stream by
// stream, each summing its stream's rows in row order on the CUDA cores.
// dwe folds each k-step's three products into its accumulators with a
// rounding f32 add (it sums over up to 16,384 rows per group). dhi (64
// k-steps, even and odd ones in two accumulators) and te_pre (8) take them
// straight: on the card, without the fold every output stays within a fifth
// of its tolerance and the kernel runs 4-9 % faster
// (tools/torch_kernel_variants.py, K4C).
//
// The reduction dimension of a product may be walked in any order as long as
// both operands take the same one. Both kernels use that to load fragments
// whole. In K4c, within 16 columns of dh (two k-steps), lane (g, t) takes
// columns 4t .. 4t+3 by one 16-byte load, the first two as k = t and t + 4
// of the first k-step, the last two of the second; wh's B fragments are read
// the same way, and so are the cosine rows of K4b's te_pre^T. In the k-steps
// over rows (dwe, dwh), lane t takes rows 2t and 2t + 1. In dwh the column
// order is free as well: column 8g + n of the warp's is column g of tile n,
// so a lane loads its 8 columns of a row in two 16-byte loads. Shared-memory
// strides and XOR swizzles keep every fragment load free of bank conflicts.
//
// K4c's shared memory: wh tile 64 KB + 2 x cosine step 34 KB + we tile 10
// KB + dte 18 KB + 8 warps x 4 ring buffers of 2 KB = 224 KB, one block per
// SM.
// What sets the pace (K4C_PARTS in tools/torch_kernel_variants.py): the dhi
// loop alone is three quarters of the time, and without any TF32 split it is
// still 4.1 ms at the learn shape, ~48 % of the rate `mma.sync` reaches with
// no operand traffic; `wgmma` is the next step.
//
// ReLU branch: te_pre is summed here in another order than a library product
// sums it, so an entry within rounding of 0 may take the other branch and
// move dte by a whole term. K4c can write its own branch bits (te_pre > 0) to
// a (rows, D) byte mask so that a check can hold the arithmetic apart from
// those flips.
//
// The bf16 mode of both (the reference's `_bwd_w_call` and `_bwd_d_call`
// with mm = bfloat16) is a pair of kernels of its own, on bf16 tensor cores:
// csrc/iqn_head_bwd_bf16.cu.

#include <cstdint>
#include <cuda_runtime.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kL = 64;    // cosine features per tau sample
constexpr int kH = 512;   // hidden width
constexpr int kDC = 32;   // columns of D per block

// K4b: rows per step (8 a warp: one k-step of dwh each), rows of a dh chunk
// (two k-steps), chunks per step, ring buffers per warp, dh columns per warp,
// floats of one ring buffer and of one fragment tile (32 lanes x 4), and
// k-steps whose products are summed before each rounding fold (0: no fold,
// all products straight into the accumulator).
constexpr int kRW = 8 * kWarps;
constexpr int kWK = 16;
constexpr int kWChunks = kRW / kWK;
constexpr int kWStages = 4;  // a power of 2
constexpr int kWCols = kH / kWarps;
constexpr int kWRing = kWK * kWCols;
constexpr int kFrag = 32 * 4;
constexpr int kFold = 4;
static_assert(kFold == 0 || (2 * kWChunks) % kFold == 0,
              "a fold never straddles a step");
// dh rings + hi fragments (2 steps x 8 k-steps x 2 row tiles x big, small)
// + we^T fragments (2 row tiles x 8 k-steps x big, small) + cosine rows.
constexpr int kSmemW = (kWarps * kWStages * kWRing + 2 * kWarps * 4 * kFrag +
                        2 * 8 * 2 * kFrag + kWarps * 8 * kL) * 4;
static_assert(kSmemW <= 232448, "K4b's shared memory exceeds the H100's");

// K4c: rows per step (16 a warp), depth of a dh chunk, chunks per step, ring
// buffers per warp, and padded row strides (see the bank notes at each use).
constexpr int kRD = 16 * kWarps;
constexpr int kKC = 32;
constexpr int kChunks = kH / kKC;
constexpr int kStages = 4;  // a power of 2
constexpr int kCosS = kL + 4;
constexpr int kDteS = kDC + 4;
constexpr int kWeS = kDC + 8;
constexpr int kRing = 16 * kKC;  // floats of one warp's ring buffer
// The ring buffer of every step's last chunk, which holds g after the step.
constexpr int kGBuf = (kChunks - 1) % kStages;
static_assert(kChunks % kStages == 0, "every step's chunks fill whole rounds");
constexpr int kSmemD = (kDC * kH + 2 * kRD * kCosS + kL * kWeS +
                        kRD * kDteS + kWarps * kStages * kRing + 2 * kDC) * 4;
static_assert(kSmemD <= 232448, "K4c's shared memory exceeds the H100's");
constexpr int kMaxDevices = 64;

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

// Splits four values and stores them as one lane's fragment: the big parts
// at `big`, the small parts kFrag floats on.
__device__ __forceinline__ void store_frag(float* big, float a0, float a1,
                                           float a2, float a3) {
  uint4 b, s;
  split_tf32(a0, b.x, s.x);
  split_tf32(a1, b.y, s.y);
  split_tf32(a2, b.z, s.z);
  split_tf32(a3, b.w, s.w);
  *reinterpret_cast<uint4*>(big) = b;
  *reinterpret_cast<uint4*>(big + kFrag) = s;
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
  float* ring = smem;  // [kWarps][kWStages][kWK][kWCols], swizzled (below)
  // hi in fragment order: [2 steps][8 k-steps][2 row tiles][big, small][kFrag]
  float* hi_s = ring + kWarps * kWStages * kWRing;
  // we^T in fragment order: [2 row tiles][8 k-steps][big, small][kFrag]
  float* wef_s = hi_s + 2 * kWarps * 4 * kFrag;
  float* cos_s = wef_s + 2 * 8 * 2 * kFrag;  // [kWarps][8][kL], swizzled
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int d0 = blockIdx.x * kDC;
  // This block's group of streams, and its rows [row_lo, rows).
  const int row_lo = group_begin(blockIdx.y, gridDim.y, nb) * s;
  const int rows = group_begin(blockIdx.y + 1, gridDim.y, nb) * s;
  const int nsteps = (rows - row_lo + kRW - 1) / kRW;
  const int nchunks = nsteps * kWChunks;

  // The warp's 8 cosine rows of step c (rows 8 warp .. + 7 of the step),
  // each keeping its 16-byte piece p at p ^ 4 (r & 1), so that te_pre's
  // reads (row g, piece 4 p' + t) fall on 8 bank groups per quarter-warp.
  // Lane (crow, cp) copies piece cp of rows crow + 2 u. Rows past the
  // group's end are zero-filled.
  float* const cos_w = cos_s + warp * 8 * kL;
  const int cp = lane & 15, crow = lane >> 4;
  auto copy_cos = [&](int c) {
    const int r = row_lo + c * kRW + 8 * warp + crow;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const bool in = r + 2 * u < rows;
      cp_async16_zfill(cos_w + (crow + 2 * u) * kL + 4 * (cp ^ (crow << 2)),
                       in ? cosx + (long long)(r + 2 * u) * kL + 4 * cp : cosx,
                       in ? 16 : 0);
    }
  };
  // Chunk q (step q / kWChunks, rows kWK (q % kWChunks) .. + 15 of it) of
  // the warp's 64 columns of dh towards its ring buffer q % kWStages. Row r
  // of a chunk keeps its piece p at p ^ f(r), f(r) = bit 1 of r | bit 2 of r
  // << 2, so that the B reads (rows 2t and 2t + 1, pieces 2g and 2g + 1)
  // fall on 8 bank groups per quarter-warp.
  float* const ring_w = ring + warp * kWStages * kWRing;
  auto copy_dh = [&](int q) {
    const int r = row_lo + (q / kWChunks) * kRW + kWK * (q % kWChunks) + crow;
    const float* src = dh + (long long)r * kH + kWCols * warp + 4 * cp;
    float* dst = ring_w + (q % kWStages) * kWRing + crow * kWCols;
#pragma unroll
    for (int u = 0; u < kWK / 2; ++u) {
      const bool in = r + 2 * u < rows;
      cp_async16_zfill(
          dst + 2 * u * kWCols + 4 * (cp ^ ((u & 1) | ((u & 2) << 1))),
          in ? src + 2 * u * kH : dh, in ? 16 : 0);
    }
  };
  copy_cos(0);
  cp_async_commit();
  for (int q = 0; q < kWStages - 1; ++q) {  // nchunks >= kWChunks >= kWStages
    copy_dh(q);
    cp_async_commit();
  }

  // te_pre^T = we_tile^T @ cos_step^T has the block's 32 columns of D as its
  // rows (row tile i: columns 16 i .. + 15) and latent k-steps ordered so
  // that the cosine reads load whole: k-step 2 p + h takes latent 16 p + 4 t
  // + 2 h as k = t and the next one as k = t + 4. Its A fragments are split
  // once, here, for the whole walk.
  for (int e = tid; e < 2 * 8 * 32; e += kThreads) {
    const int ln = e & 31, kl = (e >> 5) & 7, i = e >> 8;
    const int l0 = 16 * (kl >> 1) + 4 * (ln & 3) + 2 * (kl & 1);
    const float* w0 = we + (long long)l0 * d + d0 + 16 * i + (ln >> 2);
    store_frag(wef_s + (i * 8 + kl) * 2 * kFrag + 4 * ln, __ldg(w0),
               __ldg(w0 + 8), __ldg(w0 + d), __ldg(w0 + d + 8));
  }
  // be at this lane's te_pre^T rows: columns 16 i + g and + 8.
  float bias[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    bias[i][0] = __ldg(be + d0 + 16 * i + g);
    bias[i][1] = __ldg(be + d0 + 16 * i + g + 8);
  }
  // This lane's B values in a ring buffer: rows 2t and 2t + 1, logical
  // pieces 2g and 2g + 1, i.e. the warp's columns 8g .. 8g + 7. Column 8g + n
  // is column g of mma tile n, so the lane's accumulators of tile n hold
  // the warp's columns 16 t + n (2t) and 16 t + 8 + n (2t + 1).
  const int fsw = (t & 1) | ((t & 2) << 1);
  const int off0 = 2 * t * kWCols + 4 * ((2 * g) ^ fsw);
  const int off1 = 2 * t * kWCols + 4 * ((2 * g + 1) ^ fsw);
  cp_async_wait<kWStages - 1>();
  __syncthreads();  // we^T's fragments are in, and every warp's cosine rows

  // Walk-long sums: the warp's (32, 64) tile of dwh as 2 x 8 mma tiles, and
  // in the blocks of column 0 this lane's share of dbh: its 8 columns
  // summed over its rows 2t, 2t + 1 of every k-step, in row order.
  const bool sums_dbh = blockIdx.x == 0;
  float acc[2][8][4] = {};
  float pend[2][8][4] = {};  // products since the last fold
  float bsum[8] = {};

  for (int c = 0; c < nsteps; ++c) {
    const int r0 = row_lo + c * kRW;
    float* const hi_c = hi_s + (c & 1) * kWarps * 4 * kFrag;

    // hi of the warp's 8 rows as dwh's A fragments of k-step `warp`: the
    // accumulators of te_pre^T at (column g, row 2t), (g, 2t + 1), (g + 8,
    // 2t), (g + 8, 2t + 1) are that fragment's a0, a2, a1, a3. Even and odd
    // latent k-steps go into two accumulators.
    {
      const int ra = r0 + 8 * warp + 2 * t;
      int sa = ra / s, sb = (ra + 1) / s;
      sa = sa < nb ? sa : nb - 1;  // rows past the end: dh is zero there
      sb = sb < nb ? sb : nb - 1;
      float se[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float* p = semb + d0 + 16 * i + g;
        se[i][0] = __ldg(p + (long long)sa * d);
        se[i][1] = __ldg(p + (long long)sb * d);
        se[i][2] = __ldg(p + (long long)sa * d + 8);
        se[i][3] = __ldg(p + (long long)sb * d + 8);
      }
      float tp[2][2][4] = {};
      const float* cr = cos_w + g * kL;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const float4 x = *reinterpret_cast<const float4*>(
            cr + 4 * ((4 * p + t) ^ ((g & 1) << 2)));
        uint32_t bb[2][2], bs[2][2];
        split_tf32(x.x, bb[0][0], bs[0][0]);
        split_tf32(x.y, bb[0][1], bs[0][1]);
        split_tf32(x.z, bb[1][0], bs[1][0]);
        split_tf32(x.w, bb[1][1], bs[1][1]);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int f = (i * 8 + 2 * p + h) * 2;
            uint32_t ab[4], as[4];
            load_a(ab, wef_s, f, lane);
            load_a(as, wef_s, f + 1, lane);
            mma_3xtf32(tp[i][h], ab, as, bb[h], bs[h]);
          }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float e[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          e[k] = fmaxf(tp[i][0][k] + tp[i][1][k] + bias[i][k >> 1], 0.f) *
                 se[i][k];
        store_frag(hi_c + (warp * 2 + i) * 2 * kFrag + 4 * lane, e[0], e[2],
                   e[1], e[3]);
      }
    }
    __syncthreads();  // the step's hi is in; everyone has left step c - 1

    // dwh += hi_step^T @ dh_step: 8 k-steps of 8 rows, two per dh chunk,
    // the chunks through the warp's ring (three in flight). Lane t takes
    // rows 2t (k = t) and 2t + 1 (k = t + 4) of a k-step, in A and B alike.
#pragma unroll 1
    for (int kc = 0; kc < kWChunks; ++kc) {
      const int q = c * kWChunks + kc;
      cp_async_wait<kWStages - 2>();
      __syncwarp();  // chunk q has landed for every lane; all have left q - 1
      if (q + kWStages - 1 < nchunks) copy_dh(q + kWStages - 1);
      if (kc == 0 && c + 1 < nsteps) copy_cos(c + 1);
      cp_async_commit();
      const float* rb = ring_w + (q % kWStages) * kWRing;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = 2 * kc + u;  // k-step of the step
        uint32_t ab[2][4], as[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          load_a(ab[i], hi_c, (j * 2 + i) * 2, lane);
          load_a(as[i], hi_c, (j * 2 + i) * 2 + 1, lane);
        }
        const float* r = rb + 8 * u * kWCols;
        const float4 x0 = *reinterpret_cast<const float4*>(r + off0);
        const float4 x1 = *reinterpret_cast<const float4*>(r + off1);
        const float4 y0 = *reinterpret_cast<const float4*>(r + kWCols + off0);
        const float4 y1 = *reinterpret_cast<const float4*>(r + kWCols + off1);
        const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
        const float yv[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          uint32_t bb[2], bs[2];
          split_tf32(xv[n], bb[0], bs[0]);
          split_tf32(yv[n], bb[1], bs[1]);
#pragma unroll
          for (int i = 0; i < 2; ++i)
            mma_3xtf32(kFold ? pend[i][n] : acc[i][n], ab[i], as[i], bb, bs);
        }
        if (kFold && (j + 1) % kFold == 0)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int n = 0; n < 8; ++n)
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                acc[i][n][k] += pend[i][n][k];
                pend[i][n][k] = 0.f;
              }
        if (sums_dbh)
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            bsum[n] += xv[n];
            bsum[n] += yv[n];
          }
      }
    }
  }

  // The warp's tile: rows d0 + 16 i + g (+ 8), columns 64 warp + 16 t .. +
  // 15 (accumulator column 2t of tiles 0 .. 7, then 2t + 1 of them).
  float* dwh = out + (long long)blockIdx.y * ((long long)d * kH + kH);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* p = dwh + (long long)(d0 + 16 * i + g + 8 * h) * kH +
                 kWCols * warp + 16 * t;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int k = 2 * h + (v >> 1), n = 4 * (v & 1);
        *reinterpret_cast<float4*>(p + 4 * v) =
            make_float4(acc[i][n][k], acc[i][n + 1][k], acc[i][n + 2][k],
                        acc[i][n + 3][k]);
      }
    }
  // dbh: the four lanes t of a column group add their sums (a butterfly:
  // every lane ends with the same bits), and lane t = 0 writes them.
  if (sums_dbh) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      bsum[n] += __shfl_xor_sync(0xffffffffu, bsum[n], 1);
      bsum[n] += __shfl_xor_sync(0xffffffffu, bsum[n], 2);
    }
    if (t == 0) {
      float* p = dwh + (long long)d * kH + kWCols * warp + 8 * g;
      *reinterpret_cast<float4*>(p) =
          make_float4(bsum[0], bsum[1], bsum[2], bsum[3]);
      *reinterpret_cast<float4*>(p + 4) =
          make_float4(bsum[4], bsum[5], bsum[6], bsum[7]);
    }
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
  float* wh_s = smem;                      // [kDC][kH], swizzled (below)
  float* cos_s = wh_s + kDC * kH;          // [2][kRD][kCosS]
  float* we_s = cos_s + 2 * kRD * kCosS;   // [kL][kWeS]
  float* dte_s = we_s + kL * kWeS;         // [kRD][kDteS]
  float* ring = dte_s + kRD * kDteS;       // [kWarps][kStages][16][kKC]
  float* carry_s = ring + kWarps * kStages * kRing;  // [2][kDC]: ds_emb
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int d0 = blockIdx.x * kDC;
  // This block's group of streams, and its rows [row_lo, rows).
  const int row_lo = group_begin(blockIdx.y, gridDim.y, nb) * s;
  const int rows = group_begin(blockIdx.y + 1, gridDim.y, nb) * s;
  const int nsteps = (rows - row_lo + kRD - 1) / kRD;
  const int nchunks = nsteps * kChunks;

  // The block's 32 rows of wh (columns d0 .. d0 + 31 of D; d is a multiple
  // of 32, so none is past the end) and its (64, 32) tile of we, resident
  // for the whole walk. wh row n keeps its 16-byte piece c4 at c4 ^ 4 (n & 1):
  // the 8 lanes of a quarter-warp read rows n and n + 1 at the same 4
  // pieces, which then fall on all 32 banks.
  for (int i = tid; i < kDC * kH / 4; i += kThreads) {
    const int n = i >> 7, c4 = i & 127;
    cp_async16(wh_s + n * kH + 4 * (c4 ^ ((n & 1) << 2)),
               wh + (long long)(d0 + n) * kH + 4 * c4);
  }
  for (int i = tid; i < kL * kDC / 4; i += kThreads) {
    const int l = i >> 3, c4 = i & 7;
    cp_async16(we_s + l * kWeS + 4 * c4, we + (long long)l * d + d0 + 4 * c4);
  }
  // The cosine rows of step c towards buffer c & 1; rows past the group's
  // end are zero-filled.
  auto copy_cos = [&](int c) {
    float* dst = cos_s + (c & 1) * kRD * kCosS;
    const int r0 = row_lo + c * kRD;
    for (int i = tid; i < kRD * kL / 4; i += kThreads) {
      const int r = i >> 4, c4 = i & 15;
      const bool in = r0 + r < rows;
      cp_async16_zfill(dst + r * kCosS + 4 * c4,
                       cosx + (long long)(in ? r0 + r : 0) * kL + 4 * c4,
                       in ? 16 : 0);
    }
  };
  // Chunk q (step q / kChunks, depth (q % kChunks) * 32 ..) of this warp's
  // 16 rows of dh towards its ring buffer q % kStages, swizzled like wh.
  // Lane (i, c4) = (lane / 8, lane % 8) copies piece c4 of rows i + 4 u.
  const int ci = lane >> 3, c4 = lane & 7;
  float* const ring_w = ring + warp * kStages * kRing;
  const int cdst = ci * kKC + 4 * (c4 ^ ((ci & 1) << 2));
  auto copy_dh = [&](int q) {
    const int r = row_lo + (q / kChunks) * kRD + 16 * warp + ci;
    const float* src = dh + (long long)r * kH + kKC * (q % kChunks) + 4 * c4;
    float* dst = ring_w + (q % kStages) * kRing + cdst;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const bool in = r + 4 * u < rows;
      cp_async16_zfill(dst + 4 * u * kKC, in ? src + 4 * u * kH : dh,
                       in ? 16 : 0);
    }
  };
  copy_cos(0);
  cp_async_commit();
  for (int q = 0; q < kStages - 1; ++q) {  // nchunks >= kChunks > kStages
    copy_dh(q);
    cp_async_commit();
  }

  // be at this lane's accumulator columns 8 j + 2 t, + 1.
  float2 bias[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    bias[j] = __ldg(reinterpret_cast<const float2*>(be + d0 + 8 * j + 2 * t));

  // Walk-long sums: dwe rows 16 wi .. + 15 at column tiles wj, wj + 1 (in
  // mma accumulator order), and this lane's share of dbe: the sum of dte
  // over its rows g and g + 8 of every step, at its accumulator columns
  // (added over the lanes and warps in a fixed order at the end).
  const int wi = warp >> 1, wj = 2 * (warp & 1);
  float dwe_acc[2][4] = {};
  float dbe_acc[4][2] = {};

  for (int c = 0; c < nsteps; ++c) {
    cp_async_wait_all();
    __syncthreads();  // step c's cosine rows have landed; everyone has left
                      // step c - 1's staging
    const int r0 = row_lo + c * kRD;
    const float* cosb = cos_s + (c & 1) * kRD * kCosS;

    // te_pre of the warp's rows: accumulator (j, e) is row 16 warp + g +
    // 8 (e >> 1) of the step, column 8 j + 2 t + (e & 1). Stride 68: the A
    // reads (row g, column t) fall on bank 4 g + t; stride 40: the B reads
    // (row t, column g) on 8 t + g.
    float tp[4][4] = {};
    {
      const float* ap = cosb + (16 * warp + g) * kCosS + t;
      const float* bp = we_s + t * kWeS + g;
#pragma unroll
      for (int ks = 0; ks < kL / 8; ++ks) {
        uint32_t ab[4], as[4];
        split_tf32(ap[8 * ks], ab[0], as[0]);
        split_tf32(ap[8 * kCosS + 8 * ks], ab[1], as[1]);
        split_tf32(ap[8 * ks + 4], ab[2], as[2]);
        split_tf32(ap[8 * kCosS + 8 * ks + 4], ab[3], as[3]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t bb[2], bs[2];
          load_b(bb, bs, bp + 8 * ks * kWeS + 8 * j, kWeS);
          mma_3xtf32(tp[j], ab, as, bb, bs);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        tp[j][0] += bias[j].x;
        tp[j][1] += bias[j].y;
        tp[j][2] += bias[j].x;
        tp[j][3] += bias[j].y;
      }
    }

    // s_emb at the lane's rows g, g + 8 and accumulator columns, loaded
    // here so that the loads are in by the elementwise phase.
    float2 sv[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int st = (r0 + 16 * warp + g + 8 * h) / s;
      st = st < nb ? st : nb - 1;  // rows past the end: dhi is zero there
      const float* sp = semb + (long long)st * d + d0 + 2 * t;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sv[h][j] = __ldg(reinterpret_cast<const float2*>(sp + 8 * j));
    }

    // dhi of the warp's rows, in the same accumulator positions, chunk by
    // chunk through the warp's ring (three chunks in flight). Even and odd
    // k-steps go into two accumulators, added at the end: each then takes
    // the tensor cores' truncating adds over half the k-steps, which halves
    // the error that dhi, with no fold, carries into the outputs.
    float acc[4][4] = {}, acc_odd[4][4] = {};
    for (int kc = 0; kc < kChunks; ++kc) {
      const int q = c * kChunks + kc;
      cp_async_wait<kStages - 2>();
      __syncwarp();  // chunk q has landed for every lane; all have left q - 1
      if (q + kStages - 1 < nchunks) copy_dh(q + kStages - 1);
      if (kc == 0 && c + 1 < nsteps) copy_cos(c + 1);
      cp_async_commit();
      const float* ab_ = ring_w + (q % kStages) * kRing + g * kKC;
      const float* wb = wh_s + g * kH + kKC * kc;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        // Columns 16 p + 4 t .. + 3 of rows g and g + 8: k = t, t + 4 of
        // k-step 2 p, then of k-step 2 p + 1. The swizzle flips bit 2 of a
        // piece's index only, so wh's piece 8 kc + 4 p + t of row 8 j + g
        // lies at 32 kc + sw.
        const int sw = 4 * ((4 * p + t) ^ ((g & 1) << 2));
        const float4 x0 = *reinterpret_cast<const float4*>(ab_ + sw);
        const float4 x1 = *reinterpret_cast<const float4*>(ab_ + 8 * kKC + sw);
        uint32_t a0b[4], a0s[4], a1b[4], a1s[4];
        split_tf32(x0.x, a0b[0], a0s[0]);
        split_tf32(x1.x, a0b[1], a0s[1]);
        split_tf32(x0.y, a0b[2], a0s[2]);
        split_tf32(x1.y, a0b[3], a0s[3]);
        split_tf32(x0.z, a1b[0], a1s[0]);
        split_tf32(x1.z, a1b[1], a1s[1]);
        split_tf32(x0.w, a1b[2], a1s[2]);
        split_tf32(x1.w, a1b[3], a1s[3]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 w =
              *reinterpret_cast<const float4*>(wb + 8 * j * kH + sw);
          uint32_t b0b[2], b0s[2], b1b[2], b1s[2];
          split_tf32(w.x, b0b[0], b0s[0]);
          split_tf32(w.y, b0b[1], b0s[1]);
          split_tf32(w.z, b1b[0], b1s[0]);
          split_tf32(w.w, b1b[1], b1s[1]);
          mma_3xtf32(acc[j], a0b, a0s, b0b, b0s);
          mma_3xtf32(acc_odd[j], a1b, a1s, b1b, b1s);
        }
      }
    }

#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += acc_odd[j][e];

    // Elementwise, in registers: dte, g = dhi * te and the branch bits of
    // rows g (e = 0, 1) and g + 8 (e = 2, 3). dte is staged for dwe and
    // dcos; g for ds_emb in the ring buffer of the step's last chunk, which
    // every lane of the warp has left and no copy refills before the next
    // step (16 x 32, its columns XOR 8 (row & 3) to spread the stores).
    float* g_w = ring_w + kGBuf * kRing;
    __syncwarp();  // every lane has left the last chunk
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * warp + g + 8 * h;
      const int row = r0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float t0 = tp[j][2 * h], t1 = tp[j][2 * h + 1];
        const float x0 = acc[j][2 * h], x1 = acc[j][2 * h + 1];
        const bool p0 = t0 > 0.f, p1 = t1 > 0.f;
        const float2 dte = make_float2(p0 ? x0 * sv[h][j].x : 0.f,
                                       p1 ? x1 * sv[h][j].y : 0.f);
        dbe_acc[j][0] += dte.x;
        dbe_acc[j][1] += dte.y;
        *reinterpret_cast<float2*>(dte_s + r * kDteS + 8 * j + 2 * t) = dte;
        const int i = g + 8 * h;
        *reinterpret_cast<float2*>(g_w + i * kKC +
                                   ((8 * j + 2 * t) ^ ((i & 3) << 3))) =
            make_float2(x0 * fmaxf(t0, 0.f), x1 * fmaxf(t1, 0.f));
        if (te_mask != nullptr && row < rows)
          *reinterpret_cast<uint16_t*>(
              te_mask + (long long)row * d + d0 + 8 * j + 2 * t) =
              (uint16_t)((p0 ? 1u : 0u) | (p1 ? 256u : 0u));
      }
    }
    __syncthreads();

    // dwe += cos_step^T @ dte over the step's 128 rows, 8 a k-step: lane t
    // takes rows 2 t (k = t) and 2 t + 1 (k = t + 4). A (l, row) from the
    // cosine rows, bank 8 t + g at stride 68; B (row, column) from dte,
    // bank 8 t + g at stride 36.
    {
      const float* ap = cosb + 2 * t * kCosS + 16 * wi + g;
      const float* bp = dte_s + 2 * t * kDteS + 8 * wj + g;
#pragma unroll 4
      for (int ks = 0; ks < kRD / 8; ++ks) {
        const float* a = ap + 8 * ks * kCosS;
        uint32_t ab[4], as[4];
        split_tf32(a[0], ab[0], as[0]);
        split_tf32(a[8], ab[1], as[1]);
        split_tf32(a[kCosS], ab[2], as[2]);
        split_tf32(a[kCosS + 8], ab[3], as[3]);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const float* b = bp + 8 * ks * kDteS + 8 * jj;
          uint32_t bb[2], bs[2];
          split_tf32(b[0], bb[0], bs[0]);
          split_tf32(b[kDteS], bb[1], bs[1]);
          mma_3xtf32_rn(dwe_acc[jj], ab, as, bb, bs);
        }
      }
    }

    // ds_emb: warp k takes the step's streams k, k + 8, ... and sums each
    // over its rows of the step in row order, at column lane. A stream that
    // runs on past the step leaves its sum in carry buffer c & 1, and the
    // warp that takes it as the next step's first stream starts from there
    // (two buffers: in one step the first stream's warp may read while the
    // last one's writes). Groups hold whole streams, so every stream ends
    // within its group.
    {
      const float* g_s = ring + kGBuf * kRing;
      const int st0 = r0 / s;
      const int end = min(r0 + kRD, rows);
      const int nst = (end - 1) / s - st0 + 1;
      for (int k = warp; k < nst; k += kWarps) {
        const int st = st0 + k;
        const int a = max(st * s, r0), e = min((st + 1) * s, end);
        float sum = st * s < r0 ? carry_s[((c + 1) & 1) * kDC + lane] : 0.f;
#pragma unroll 4
        for (int r = a; r < e; ++r) {
          const int w = (r - r0) >> 4, i = (r - r0) & 15;
          sum += g_s[w * kStages * kRing + i * kKC + (lane ^ ((i & 3) << 3))];
        }
        if ((st + 1) * s <= end)
          dsemb[(long long)st * d + d0 + lane] = sum;
        else
          carry_s[(c & 1) * kDC + lane] = sum;
      }
    }
    if (dcos_part != nullptr) {
      // This block's share of dcos: rows tid / 16 + 16 i of the step,
      // columns l4 + 16 e.
      const int l4 = tid & 15;
      for (int r = tid >> 4; r < kRD && r0 + r < rows; r += kThreads / 16) {
        float p[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int k4 = 0; k4 < kDC / 4; ++k4) {
          const float4 dv =
              *reinterpret_cast<const float4*>(dte_s + r * kDteS + 4 * k4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float4 wv = *reinterpret_cast<const float4*>(
                we_s + (l4 + 16 * e) * kWeS + 4 * k4);
            p[e] = dot4(dv, wv, p[e]);
          }
        }
        float* o =
            dcos_part + ((long long)blockIdx.x * nb * s + r0 + r) * kL + l4;
#pragma unroll
        for (int e = 0; e < 4; ++e) o[16 * e] = p[e];
      }
    }
  }

  float* dwe = out + (long long)blockIdx.y * ((long long)kL * d + d);
#pragma unroll
  for (int jj = 0; jj < 2; ++jj)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(
          dwe + (long long)(16 * wi + g + 8 * h) * d + d0 + 8 * (wj + jj) +
          2 * t) = make_float2(dwe_acc[jj][2 * h], dwe_acc[jj][2 * h + 1]);
  // dbe: the lanes' sums over g (shuffles), then the warps' in warp order
  // through shared memory (over the dte staging, which everyone has left).
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = dbe_acc[j][e];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      dbe_acc[j][e] = v;
    }
  __syncthreads();
  if (g == 0)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float2*>(dte_s + warp * kDteS + 8 * j + 2 * t) =
          make_float2(dbe_acc[j][0], dbe_acc[j][1]);
  __syncthreads();
  if (warp == 0) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += dte_s[w * kDteS + lane];
    dwe[(long long)kL * d + d0 + lane] = sum;
  }
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

// Raises `kernel`'s dynamic shared-memory limit to `bytes`, once per device
// (`done` is the caller's per-device flag).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

int bwd_w(const void* cos, const void* semb, const void* dh, const void* we,
          const void* be, void* out, void* part, int b, int s, int d,
          int groups, void* cuda_stream) {
  cudaStream_t st = (cudaStream_t)cuda_stream;
  static bool smem_set[kMaxDevices];
  cudaError_t err = allow_smem(iqn_head_bwd_w_kernel, kSmemW, smem_set);
  if (err != cudaSuccess) return (int)err;
  iqn_head_bwd_w_kernel<<<dim3(d / kDC, groups), kThreads, kSmemW, st>>>(
      (const float*)cos, (const float*)semb, (const float*)dh,
      (const float*)we, (const float*)be, (float*)(groups > 1 ? part : out),
      s, b, d);
  err = cudaGetLastError();
  if (err == cudaSuccess && groups > 1)
    err = sum_partials(part, out, (long long)d * kH + kH, groups, st);
  return (int)err;
}

int bwd_d(const void* cos, const void* semb, const void* dh, const void* we,
          const void* be, const void* wh, void* out, void* part, void* dsemb,
          void* dcos, void* dcos_part, void* te_mask, int b, int s, int d,
          int groups, void* cuda_stream) {
  cudaStream_t st = (cudaStream_t)cuda_stream;
  static bool smem_set[kMaxDevices];
  cudaError_t err = allow_smem(iqn_head_bwd_d_kernel, kSmemD, smem_set);
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
  return bwd_w(cos, semb, dh, we, be, out, part, b, s, d, groups,
               cuda_stream);
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
  return bwd_d(cos, semb, dh, we, be, wh, out, part, dsemb, dcos, dcos_part,
               te_mask, b, s, d, groups, cuda_stream);
}

// Bytes of dynamic shared memory a block of K4b (kernel 0) or K4c (1) takes,
// for the build report beside `-Xptxas -v`'s static counts.
extern "C" int dz_iqn_head_bwd_smem(int kernel) {
  return kernel ? kSmemD : kSmemW;
}
