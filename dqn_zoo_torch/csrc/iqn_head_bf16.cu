// K4a in bf16 mode: the forward of the fused IQN per-tau head with bf16
// operands (mm = bfloat16), and the staging pass that feeds it.
//
// Replaces the TPU kernel of dqn_zoo_tpu/nets/iqn_head.py with mm = bfloat16:
//   K4a `_fwd_call` -> `_fwd_kernel`   q (and h)        (fwd_bf16_kernel)
// It computes what csrc/iqn_head.cu computes (its notes give the arithmetic):
//   te = relu(cos @ we + be), hi = te * s_emb[r / S], h = relu(hi @ wh + bh),
//   q = h @ wo + bo,
// with the operands of cos @ we, hi @ wh and h @ wo rounded to bf16 (to
// nearest even, as XLA's convert rounds) and every product accumulated in
// f32; be, bh, bo and the s_emb factor stay f32, and h is stored unrounded
// (the backward's residual). Like the TPU kernel, te and hi never reach
// device memory.
//
// The staging pass (stage_fwd_bf16_kernel) replaces no TPU kernel. It is the
// rounding of the reference's `_dot` (dqn_zoo_tpu/nets/iqn_head.py) applied
// to the weights once a launch: it reads we (64, D), be (D) and wh (D, 512)
// in f32 and writes, for each chunk of 64 rows of D, the bytes the kernel's
// shared-memory stage holds (wh's two column halves and we^T in bf16, in
// wgmma's 128-byte swizzle, and be in f32; rows past D zero), so that one
// block loads a stage with two bulk copies. Its bound is bytes: ~10 MB at
// D = 3136, ~3 us at 3.35 TB/s. Nothing is kept from one launch to the
// next: the online weights change in place every learn step.
//
// Bound on the H100: operations. At the target shape (B = 1024, S = 128)
// the three products are 474 GFLOP, 0.48 ms at the 989 TFLOP/s bf16 rate.
//
// Design: a block owns 128 rows (64 a warpgroup) and one half of H (256
// columns); grid (row tiles, 2, D splits). It walks D in chunks of 64 rows
// through a ring of kStages stages, each filled by bulk copies (the 1-D
// TMA) on one mbarrier: the chunk's wh half (bf16, 4 blocks of 64 columns x
// 64 rows of 128 bytes, swizzled: MN-major, LBO 8192, SBO 1024, as K4b's dh
// in iqn_head_bwd_bf16.cu), its we^T rows (bf16, K-major, swizzled), be
// and, where a warpgroup's 64 rows are one stream (S >= 64 on stream
// boundaries: every shape of the iqn path), the stream's s_emb values. Per
// chunk k a warpgroup
//   1. issues te_pre(k + 1) = cos_tile @ we_chunk(k + 1): 4 wgmma m64n64k16,
//      both operands K-major from shared memory (the cosine tile is rounded
//      to bf16 and stored once per block);
//   2. issues h_pre += hi(k) @ wh_chunk(k): 4 wgmma m64n256k16, hi from
//      registers as the A operand, 128 accumulators a lane;
//   3. waits for te_pre(k + 1) only (its group was committed first), then,
//      while the product of step 2 runs, forms hi(k + 1) = relu(te_pre +
//      be) * s_emb in registers: the accumulators of two neighbouring
//      8-column tiles of te_pre are exactly one A fragment of hi @ wh (K4b's
//      trick in iqn_head_bwd_bf16.cu with the roles turned), so hi is packed
//      to bf16 where it was computed and never stored.
// One block barrier a chunk, after which thread 0 refills the stage both
// warpgroups have left. The sum over D goes straight into the accumulators
// (196 k-steps at D = 3136): the tensor cores' truncating adds keep h within
// a fiftieth of its check (tests/test_torch_kernel_plans.py emulates it).
// wh crosses L2 once per block: 3.3 GB at the target shape, against 13.1 GB
// for the f32 operands of the TF32 kernel before this one.
//
// Epilogue (one split): h = relu(h_pre + bh) in registers, stored when
// asked; the block's half of q = bf16(h) @ bf16(wo) by mma.sync.m16n8k16 (the
// accumulators again form the A fragments; wo's half is staged in shared
// memory in bf16 when the block starts), 16 k-steps in order, into a
// (2, rows, A) scratch; a second kernel of the same launch adds the halves
// in order and bo. Small grids (eval, B = 4) also split D (`splits`); the
// blocks then write raw partials of h_pre and a second kernel adds them in
// split order, then bias, ReLU, h and q. No atomics: results repeat bit for
// bit.
//
// Shared memory: 1 KB to align + the bf16 cosine tile 16 KB + kStages x
// 41 KB stages (wh half 32 KB, we^T 8 KB, be and two s_emb runs 768 B) +
// wo's half in bf16 for the q epilogue (12.4 KB) + bh's half + the stages'
// mbarriers.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kL = 64;    // cosine features per tau sample
constexpr int kH = 512;   // hidden width
constexpr int kBH = 256;  // columns of H a block owns
constexpr int kM = 128;   // rows a block owns, 64 a warpgroup
constexpr int kKC = 64;   // rows of D a chunk
constexpr int kStages = 4;
// One chunk of the staged image: wh's two column halves, we^T, be.
constexpr int kWhHalfB = kKC * kBH * 2;
constexpr int kWeB = kKC * kL * 2;
constexpr int kBeB = kKC * 4;
constexpr int kChunkB = 2 * kWhHalfB + kWeB + kBeB;
// A ring stage: a wh half, we^T, be and the two warpgroups' s_emb runs,
// rounded up to 1024 bytes (the swizzled tiles start on such a boundary).
constexpr int kSembB = kKC * 4;
constexpr int kStageB = (kWhHalfB + kWeB + kBeB + 2 * kSembB + 1023) / 1024 *
                        1024;
constexpr int kCosB = kM * kL * 2;
// The q epilogue: tiles of 8 outputs a pass, and wo's half for a pass as
// bf16 [output][column] with rows of kWoS values (padded: the 8 outputs a
// B fragment reads fall on distinct banks); bh's half in f32 beside it.
constexpr int kQT = 3;
constexpr int kWoS = kBH + 8;
constexpr int kWoB = kQT * 8 * kWoS * 2;
constexpr int kBhB = kBH * 4;
constexpr int kSmem =
    1024 + kCosB + kStages * kStageB + kWoB + kBhB + kStages * 8;
static_assert(kSmem <= 232448, "K4a bf16's shared memory exceeds the H100's");
constexpr int kFinThreads = kH / 4;  // the split finish: 4 columns a thread
constexpr int kFinQA = 8;
constexpr int kStageThreads = 256;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Two floats rounded to bf16 (to nearest even), x in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Byte offset of 16-byte piece p of row r in a tile of 128-byte rows: the
// 128-byte swizzle of wgmma.
__device__ __forceinline__ int swz(int r, int p) {
  return r * 128 + ((p ^ (r & 7)) << 4);
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t n) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(n) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// n bytes (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory, completing on mbarrier `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t n, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(n), "r"(bar) : "memory");
}

// Orders this thread's generic-proxy writes to shared memory before the
// async proxy's accesses (wgmma's reads, the bulk copies' writes).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most n of the warpgroup's committed batches are pending
// (batches complete in the order they were committed).
template <int n>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(n) : "memory");
}

// Keeps the compiler from moving accesses of an accumulator across the
// asynchronous products that update it.
template <int n>
__device__ __forceinline__ void pin(float (&d)[n][4]) {
#pragma unroll
  for (int j = 0; j < n; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e]) :: "memory");
}

// The descriptor of a bf16 operand in shared memory in the 128-byte swizzle
// layout: 8 rows of 128 bytes an atom, each row's 16-byte piece p at
// p ^ (row & 7); MN-major: atoms `lbo` bytes apart along MN and `sbo` apart
// along K; K-major: `sbo` apart along MN (lbo unused). `addr` is 1024-byte
// aligned but for whole rows or a k-step's 32 bytes within a row.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// d += a @ b for the warpgroup's 64 x 256 x 16 step: a (this warp's 16
// rows, laid out as mma.sync's A fragment) from registers, b (16 x 256)
// from shared memory through `desc`, MN-major; d at (row g (+ 8), column
// 8 j + 2 t (+ 1)) of the warp's rows as d[j][0..3], as mma.sync's C
// fragments of 32 column tiles.
__device__ __forceinline__ void wgmma_256(float (&d)[32][4],
                                          const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
        "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
        "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
        "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
        "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
        "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
        "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
        "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
        "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3]),
        "+f"(d[24][0]), "+f"(d[24][1]), "+f"(d[24][2]), "+f"(d[24][3]),
        "+f"(d[25][0]), "+f"(d[25][1]), "+f"(d[25][2]), "+f"(d[25][3]),
        "+f"(d[26][0]), "+f"(d[26][1]), "+f"(d[26][2]), "+f"(d[26][3]),
        "+f"(d[27][0]), "+f"(d[27][1]), "+f"(d[27][2]), "+f"(d[27][3]),
        "+f"(d[28][0]), "+f"(d[28][1]), "+f"(d[28][2]), "+f"(d[28][3]),
        "+f"(d[29][0]), "+f"(d[29][1]), "+f"(d[29][2]), "+f"(d[29][3]),
        "+f"(d[30][0]), "+f"(d[30][1]), "+f"(d[30][2]), "+f"(d[30][3]),
        "+f"(d[31][0]), "+f"(d[31][1]), "+f"(d[31][2]), "+f"(d[31][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d = a @ b (accumulate != 0: d += a @ b) for the warpgroup's 64 x 64 x 16
// step, a (64 x 16) and b (16 x 64) both from shared memory, K-major,
// through their descriptors; d as wgmma_256's, 8 column tiles.
__device__ __forceinline__ void wgmma_64_ss(float (&d)[8][4], uint64_t da,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(accumulate));
}

// c += a @ b for one 16 x 8 x 16 tile: bf16 operands, f32 accumulator.
// A: a0 (g, 2t..), a1 (g + 8, 2t..), a2 (g, 2t + 8..), a3 (g + 8, 2t + 8..);
// B: b0 (k 2t.., n g), b1 (k 2t + 8.., n g); C: c0, c1 (g, 2t..), c2, c3
// (g + 8, 2t..).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------- staging ------

// The image of chunk c (rows 64 c .. 64 c + 63 of D) at img + c * kChunkB,
// in 16-byte pieces, one a thread over a grid-stride loop:
//   [half][4 column blocks][64 rows][8 pieces]  wh: columns 256 half +
//       64 cb + 8 q .. + 7 of D row 64 c + r at piece q ^ (r & 7) of row r
//       of column block cb;
//   [8 pieces][64 rows]                         we^T: latent 8 q .. + 7 of
//       D column 64 c + n at piece q ^ (n & 7) of row n (the thread order
//       puts neighbouring columns, we's contiguous axis, on neighbouring
//       threads);
//   [16 pieces]                                 be[64 c ..], f32;
// all bf16 rounded to nearest even, rows and columns past D zero.
__global__ void __launch_bounds__(kStageThreads)
stage_fwd_bf16_kernel(const float* __restrict__ we,
                      const float* __restrict__ be,
                      const float* __restrict__ wh, uint8_t* __restrict__ img,
                      int d, int nchunks) {
  constexpr int kWhPieces = 2 * kWhHalfB / 16;
  constexpr int kWePieces = kWeB / 16;
  constexpr int kPieces = kChunkB / 16;
  const long long total = (long long)nchunks * kPieces;
  for (long long i = (long long)blockIdx.x * kStageThreads + threadIdx.x;
       i < total; i += (long long)gridDim.x * kStageThreads) {
    const int c = (int)(i / kPieces), u = (int)(i % kPieces);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    int off;
    if (u < kWhPieces) {
      const int half = u >> 11, cb = (u >> 9) & 3, r = (u >> 3) & 63,
                q = u & 7;
      const int row = kKC * c + r;
      off = half * kWhHalfB + cb * (kKC * 128) + swz(r, q);
      if (row < d) {
        const float4* p = reinterpret_cast<const float4*>(
            wh + (long long)row * kH + kBH * half + 64 * cb + 8 * q);
        const float4 x = __ldg(p), y = __ldg(p + 1);
        v = make_uint4(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w),
                       pack_bf16(y.x, y.y), pack_bf16(y.z, y.w));
      }
    } else if (u < kWhPieces + kWePieces) {
      const int w = u - kWhPieces, n = w & 63, lp = w >> 6;  // logical piece
      const int col = kKC * c + n;
      off = 2 * kWhHalfB + swz(n, lp);
      if (col < d) {
        const float* p = we + (long long)(8 * lp) * d + col;
        v = make_uint4(pack_bf16(__ldg(p), __ldg(p + d)),
                       pack_bf16(__ldg(p + 2 * d), __ldg(p + 3 * d)),
                       pack_bf16(__ldg(p + 4 * d), __ldg(p + 5 * d)),
                       pack_bf16(__ldg(p + 6 * d), __ldg(p + 7 * d)));
      }
    } else {
      const int col = kKC * c + 4 * (u - kWhPieces - kWePieces);
      off = 2 * kWhHalfB + kWeB + 16 * (u - kWhPieces - kWePieces);
      if (col < d) v = __ldg(reinterpret_cast<const uint4*>(be + col));
    }
    *reinterpret_cast<uint4*>(img + (long long)c * kChunkB + off) = v;
  }
}

// ---------------------------------------------------------------- K4a ------

// grid (row tiles of 128, 2 halves of H, splits); split z walks chunks
// [z * per, (z + 1) * per) of D. One split: h (when asked) and the half's
// q partial to qpart[half]; else the raw h_pre partial to part[z].
template <bool kResiduals>
__global__ void __launch_bounds__(kThreads, 1)
fwd_bf16_kernel(const float* __restrict__ cosx, const float* __restrict__ semb,
                const uint8_t* __restrict__ img, const float* __restrict__ bh,
                const float* __restrict__ wo, float* __restrict__ qpart,
                float* __restrict__ h, float* __restrict__ part, int rows,
                int s, int nb, int d, int a, int per) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t base = smem_u32(smem);
  const uint32_t cos_s = (base + 1023) & ~1023u;  // [128 rows][128 B]
  const uint32_t ring_s = cos_s + kCosB;          // [kStages][kStageB]
  uint8_t* const ring_p = smem + (ring_s - base);
  // wo's half for a pass of the q epilogue, bf16 [kQT * 8][kWoS], and bh's.
  uint16_t* const wo_p =
      reinterpret_cast<uint16_t*>(ring_p + kStages * kStageB);
  float* const bh_p = reinterpret_cast<float*>(ring_p + kStages * kStageB +
                                               kWoB);
  const uint32_t bar_s = ring_s + kStages * kStageB + kWoB + kBhB;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wg = warp >> 2, wl = warp & 3;
  const int row0 = blockIdx.x * kM, half = blockIdx.y, h0 = half * kBH;
  const int nchunks = (d + kKC - 1) / kKC;
  const int c_begin = blockIdx.z * per;
  const int n = min(c_begin + per, nchunks) - c_begin;  // >= 1

  // Each warpgroup's stream: one for its 64 rows where they are one stream
  // (rows past the end share the last row's), and then its s_emb runs come
  // with the stages.
  int wst[2];
  bool one[2];
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    const int r0 = row0 + 64 * w;
    wst[w] = min(r0 / s, nb - 1);
    one[w] = wst[w] == min(min(r0 + 63, rows - 1) / s, nb - 1);
  }

  // Chunk k of this block's run into stage k % kStages: the wh half, we^T
  // and be of the image, and the one-stream warpgroups' s_emb runs (128
  // bytes in a last chunk of 32 rows).
  auto issue = [&](int k) {
    const int c = c_begin + k;
    const uint32_t st = ring_s + (k % kStages) * kStageB;
    const uint32_t bar = bar_s + 8 * (k % kStages);
    const uint8_t* src = img + (long long)c * kChunkB;
    const uint32_t sb = (uint32_t)min(kKC, d - kKC * c) * 4;
    uint32_t bytes = kWhHalfB + kWeB + kBeB;
    bytes += (one[0] ? sb : 0u) + (one[1] ? sb : 0u);
    mbar_expect_tx(bar, bytes);
    bulk_load(st, src + half * kWhHalfB, kWhHalfB, bar);
    bulk_load(st + kWhHalfB, src + 2 * kWhHalfB, kWeB + kBeB, bar);
#pragma unroll
    for (int w = 0; w < 2; ++w)
      if (one[w])
        bulk_load(st + kWhHalfB + kWeB + kBeB + w * kSembB,
                  semb + (long long)wst[w] * d + kKC * c, sb, bar);
  };

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(bar_s + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // The s_emb runs start zeroed: a last chunk of 32 rows leaves the upper
  // half of its run as it was, and te there is 0 (we^T and be are zero past
  // D), which must not meet a stale NaN.
  for (int i = tid; i < kStages * 2 * kKC; i += kThreads)
    reinterpret_cast<float*>(ring_p + (i / (2 * kKC)) * kStageB + kWhHalfB +
                             kWeB + kBeB)[i % (2 * kKC)] = 0.f;
  // The block's cosine rows, rounded to bf16, K-major and swizzled (rows
  // past the end zero).
  for (int i = tid; i < kM * 8; i += kThreads) {
    const int r = i >> 3, p = i & 7;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < rows) {
      const float4* src = reinterpret_cast<const float4*>(
          cosx + (long long)(row0 + r) * kL + 8 * p);
      const float4 x = __ldg(src), y = __ldg(src + 1);
      v = make_uint4(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w),
                     pack_bf16(y.x, y.y), pack_bf16(y.z, y.w));
    }
    *reinterpret_cast<uint4*>(smem + (cos_s - base) + swz(r, p)) = v;
  }
  // wo's half for outputs o0 .., rounded to bf16 and transposed (outputs
  // past A zero), for the epilogue's B fragments.
  auto stage_wo = [&](int o0) {
    for (int i = tid; i < kQT * 8 * kBH; i += kThreads) {
      const int col = i / (kQT * 8), o = i % (kQT * 8);
      const float w =
          o0 + o < a ? __ldg(wo + (long long)(h0 + col) * a + o0 + o) : 0.f;
      wo_p[o * kWoS + col] = __bfloat16_as_ushort(__float2bfloat16_rn(w));
    }
  };
  stage_wo(0);
  for (int i = tid; i < kBH; i += kThreads) bh_p[i] = __ldg(bh + h0 + i);
  fence_async_smem();
  __syncthreads();  // barriers initialised, zeros, cosine tile, wo and bh
                    // written
  if (tid == 0)
    for (int k = 0; k < min(kStages, n); ++k) issue(k);

  // This lane's rows of the warpgroup's te_pre, hi and h: r_a and r_b.
  const int r_a = row0 + 64 * wg + 16 * wl + g, r_b = r_a + 8;
  const float* se_a = semb + (long long)min(r_a / s, nb - 1) * d;
  const float* se_b = semb + (long long)min(r_b / s, nb - 1) * d;
  const bool my_one = one[wg];

  float tp[8][4];
  float acc[32][4];
#pragma unroll
  for (int j = 0; j < 32; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  uint32_t a0[4][4], a1[4][4];

  // te_pre(k) = cos rows @ we^T rows of chunk k: 4 k-steps over latent 64,
  // a k-step 32 bytes on within the 128-byte rows.
  auto te = [&](int k) {
    const uint32_t web = ring_s + (k % kStages) * kStageB + kWhHalfB;
    const uint32_t cb = cos_s + wg * (64 * 128);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_64_ss(tp, desc_sw128(cb + 32 * ks, 16, 1024),
                  desc_sw128(web + 32 * ks, 16, 1024), ks);
  };
  // h_pre += hi(k) @ wh chunk k: 4 k-steps of 16 rows (2048 bytes apart in
  // each column block of 64 rows x 128 bytes; blocks 8192 apart, atoms 1024).
  auto main_mma = [&](int k, uint32_t (&x)[4][4]) {
    const uint32_t whb = ring_s + (k % kStages) * kStageB;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_256(acc, x[kk], desc_sw128(whb + kk * 16 * 128, kKC * 128, 1024));
  };
  // hi(k) = relu(te_pre + be) * s_emb from tp, as 4 A fragments (column
  // tiles 2 kk and 2 kk + 1 are k-step kk's).
  auto form = [&](int k, uint32_t (&x)[4][4]) {
    const uint8_t* st = ring_p + (k % kStages) * kStageB;
    const float* bes = reinterpret_cast<const float*>(st + kWhHalfB + kWeB);
    const float* ses = bes + kKC + wg * kKC;
    const int c0 = kKC * (c_begin + k);
    float hv[8][4];
    // One branch a step, warpgroup-uniform: the one-stream loop has none.
    if (my_one) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 8 * j + 2 * t;
        const float2 b = *reinterpret_cast<const float2*>(bes + col);
        const float2 sv = *reinterpret_cast<const float2*>(ses + col);
        hv[j][0] = fmaxf(tp[j][0] + b.x, 0.f) * sv.x;
        hv[j][1] = fmaxf(tp[j][1] + b.y, 0.f) * sv.y;
        hv[j][2] = fmaxf(tp[j][2] + b.x, 0.f) * sv.x;
        hv[j][3] = fmaxf(tp[j][3] + b.y, 0.f) * sv.y;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 8 * j + 2 * t;
        const float2 b = *reinterpret_cast<const float2*>(bes + col);
        const bool in = c0 + col < d;
        const float2 sa =
            in ? __ldg(reinterpret_cast<const float2*>(se_a + c0 + col))
               : make_float2(0.f, 0.f);
        const float2 sb =
            in ? __ldg(reinterpret_cast<const float2*>(se_b + c0 + col))
               : make_float2(0.f, 0.f);
        hv[j][0] = fmaxf(tp[j][0] + b.x, 0.f) * sa.x;
        hv[j][1] = fmaxf(tp[j][1] + b.y, 0.f) * sa.y;
        hv[j][2] = fmaxf(tp[j][2] + b.x, 0.f) * sb.x;
        hv[j][3] = fmaxf(tp[j][3] + b.y, 0.f) * sb.y;
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      x[kk][0] = pack_bf16(hv[2 * kk][0], hv[2 * kk][1]);
      x[kk][1] = pack_bf16(hv[2 * kk][2], hv[2 * kk][3]);
      x[kk][2] = pack_bf16(hv[2 * kk + 1][0], hv[2 * kk + 1][1]);
      x[kk][3] = pack_bf16(hv[2 * kk + 1][2], hv[2 * kk + 1][3]);
    }
  };
  // Step k (hi(k) in `cur`): te_pre(k + 1) then h_pre(k) are issued, in
  // that order; the wait lets h_pre(k) run on while hi(k + 1) is formed
  // into `nxt`. kNext is false for the last step.
  auto step = [&](auto next_tag, int k, uint32_t (&cur)[4][4],
                  uint32_t (&nxt)[4][4]) {
    constexpr bool kNext = decltype(next_tag)::value;
    if constexpr (kNext)
      mbar_wait(bar_s + 8 * ((k + 1) % kStages), ((k + 1) / kStages) & 1);
    pin(acc);
    pin(tp);
    wgmma_fence();
    if constexpr (kNext) {
      te(k + 1);
      wgmma_commit();
    }
    main_mma(k, cur);
    wgmma_commit();
    if constexpr (kNext)
      wgmma_wait<1>();  // te_pre(k + 1) and h_pre(k - 1) are done
    else
      wgmma_wait<0>();
    pin(acc);
    pin(tp);
    __syncthreads();  // both warpgroups have left chunk k - 1
    if (tid == 0 && k >= 1 && k - 1 + kStages < n) issue(k - 1 + kStages);
    if constexpr (kNext) form(k + 1, nxt);
  };

  mbar_wait(bar_s, 0);
  wgmma_fence();
  te(0);
  wgmma_commit();
  wgmma_wait<0>();
  pin(tp);
  form(0, a0);
  int k = 0;
  for (; k + 2 < n; k += 2) {
    step(std::true_type{}, k, a0, a1);
    step(std::true_type{}, k + 1, a1, a0);
  }
  if (n - k == 2) {
    step(std::true_type{}, k, a0, a1);
    step(std::false_type{}, k + 1, a1, a0);
  } else {
    step(std::false_type{}, k, a0, a1);
  }
  wgmma_wait<0>();
  pin(acc);

  // This lane's accumulator (j, e) is row r_a (e < 2) or r_b and column
  // h0 + 8 j + 2 t + (e & 1).
  const int col0 = h0 + 2 * t;
  if (gridDim.z > 1) {  // raw partial of split z; the second kernel ends it
    float* pp = part + (long long)blockIdx.z * rows * kH;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = hh ? r_b : r_a;
      if (r < rows)
#pragma unroll
        for (int j = 0; j < 32; ++j)
          *reinterpret_cast<float2*>(pp + (long long)r * kH + col0 + 8 * j) =
              make_float2(acc[j][2 * hh], acc[j][2 * hh + 1]);
    }
    return;
  }

  // h = relu(h_pre + bh), stored unrounded when asked for.
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const float2 bb =
        *reinterpret_cast<const float2*>(bh_p + 8 * j + 2 * t);
    acc[j][0] = fmaxf(acc[j][0] + bb.x, 0.f);
    acc[j][1] = fmaxf(acc[j][1] + bb.y, 0.f);
    acc[j][2] = fmaxf(acc[j][2] + bb.x, 0.f);
    acc[j][3] = fmaxf(acc[j][3] + bb.y, 0.f);
  }
  if (kResiduals) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = hh ? r_b : r_a;
      if (r < rows)
#pragma unroll
        for (int j = 0; j < 32; ++j)
          *reinterpret_cast<float2*>(h + (long long)r * kH + col0 + 8 * j) =
              make_float2(acc[j][2 * hh], acc[j][2 * hh + 1]);
    }
  }

  // The half's q = bf16(h) @ bf16(wo[h0 .. h0 + 255]): k-step kk takes
  // columns 16 kk .. + 15 (accumulator tiles 2 kk and 2 kk + 1, an A
  // fragment), 16 k-steps in order, kQT tiles of 8 outputs a pass.
  uint32_t hf[16][4];
#pragma unroll
  for (int kk = 0; kk < 16; ++kk) {
    hf[kk][0] = pack_bf16(acc[2 * kk][0], acc[2 * kk][1]);
    hf[kk][1] = pack_bf16(acc[2 * kk][2], acc[2 * kk][3]);
    hf[kk][2] = pack_bf16(acc[2 * kk + 1][0], acc[2 * kk + 1][1]);
    hf[kk][3] = pack_bf16(acc[2 * kk + 1][2], acc[2 * kk + 1][3]);
  }
  float* qp = qpart + (long long)half * rows * a;
  for (int o0 = 0; o0 < a; o0 += 8 * kQT) {
    if (o0 > 0) {  // the next outputs' wo (both warpgroups are here)
      __syncthreads();
      stage_wo(o0);
      __syncthreads();
    }
    float qa[kQT][4] = {};
#pragma unroll
    for (int nt = 0; nt < kQT; ++nt) {
      if (o0 + 8 * nt >= a) break;
      // B: output 8 nt + g, columns 16 kk + 2 t (+ 1) and + 8 (+ 9).
      const uint16_t* wr = wo_p + (8 * nt + g) * kWoS + 2 * t;
#pragma unroll
      for (int kk = 0; kk < 16; ++kk)
        mma_bf16(qa[nt], hf[kk],
                 *reinterpret_cast<const uint32_t*>(wr + 16 * kk),
                 *reinterpret_cast<const uint32_t*>(wr + 16 * kk + 8));
    }
#pragma unroll
    for (int nt = 0; nt < kQT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e < 2 ? r_a : r_b;
        const int o = o0 + 8 * nt + 2 * t + (e & 1);
        if (r < rows && o < a) qp[(long long)r * a + o] = qa[nt][e];
      }
  }
}

// q = (qpart[0] + qpart[1]) + bo, one element a thread.
__global__ void q_halves_kernel(const float* __restrict__ qpart,
                                const float* __restrict__ bo,
                                float* __restrict__ q, long long n, int a) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) q[i] = (qpart[i] + qpart[n + i]) + __ldg(bo + i % a);
}

// One block per row: h = relu(sum of the splits' partials in split order +
// bh), h stored when asked for, q = bf16(h) @ bf16(wo) + bo by a shuffle
// tree over each warp and the 4 warps in order.
template <bool kResiduals>
__global__ void __launch_bounds__(kFinThreads)
finish_bf16_kernel(const float* __restrict__ part, const float* __restrict__ bh,
                   const float* __restrict__ wo, const float* __restrict__ bo,
                   float* __restrict__ q, float* __restrict__ h, int rows,
                   int a, int splits) {
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
  v = make_float4(round_bf16(v.x), round_bf16(v.y), round_bf16(v.z),
                  round_bf16(v.w));
  auto wv = [&](const float* p) { return round_bf16(__ldg(p)); };
  for (int o0 = 0; o0 < a; o0 += kFinQA) {
    const int na = min(kFinQA, a - o0);
    for (int o = 0; o < na; ++o) {
      const float* wp = wo + (long long)col * a + o0 + o;
      float p = v.x * wv(wp);
      p = fmaf(v.y, wv(wp + a), p);
      p = fmaf(v.z, wv(wp + 2 * a), p);
      p = fmaf(v.w, wv(wp + 3 * a), p);
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
cudaError_t launch(const void* cos, const void* semb, const void* img,
                   const void* bh, const void* wo, const void* bo, void* q,
                   void* h, void* part, void* qpart, int b, int s, int d,
                   int a, int splits, int per, cudaStream_t st) {
  static bool smem_set[kMaxDevices];  // per device, once
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(fwd_bf16_kernel<kResiduals>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmem);
    if (err != cudaSuccess) return err;
    smem_set[dev] = true;
  }
  const int rows = b * s;
  const int tiles = (rows + kM - 1) / kM;
  fwd_bf16_kernel<kResiduals>
      <<<dim3(tiles, kH / kBH, splits), kThreads, kSmem, st>>>(
      (const float*)cos, (const float*)semb, (const uint8_t*)img,
      (const float*)bh, (const float*)wo, (float*)qpart, (float*)h,
      (float*)part, rows, s, b, d, a, per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (splits > 1) {
    finish_bf16_kernel<kResiduals><<<rows, kFinThreads, 0, st>>>(
        (const float*)part, (const float*)bh, (const float*)wo,
        (const float*)bo, (float*)q, (float*)h, rows, a, splits);
  } else {
    const long long n = (long long)rows * a;
    q_halves_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
        (const float*)qpart, (const float*)bo, (float*)q, n, a);
  }
  return cudaGetLastError();
}

}  // namespace

// we (64, d), be (d), wh (d, 512), f32 -> img: ceil(d / 64) chunks of
// kChunkB bytes (dz_iqn_head_fwd_bf16_sizes), the layout the kernel's
// stages hold. d a multiple of 32. Returns cudaGetLastError().
extern "C" int dz_iqn_head_stage_fwd_bf16(const void* we, const void* be,
                                          const void* wh, void* img, int d,
                                          void* cuda_stream) {
  const int nchunks = (d + kKC - 1) / kKC;
  const long long pieces = (long long)nchunks * (kChunkB / 16);
  const long long blocks = (pieces + kStageThreads - 1) / kStageThreads;
  stage_fwd_bf16_kernel<<<(int)(blocks < 2048 ? blocks : 2048), kStageThreads,
                          0, (cudaStream_t)cuda_stream>>>(
      (const float*)we, (const float*)be, (const float*)wh, (uint8_t*)img, d,
      nchunks);
  return (int)cudaGetLastError();
}

// cos (b*s, 64), semb (b, d), the staged img, bh (512), wo (512, a), bo (a)
// -> q (b*s, a) and, when residuals != 0, h (b*s, 512). d a multiple of 32.
// D is cut into `splits` runs of `per` chunks of 64 rows (the last may be
// shorter, none empty); with splits > 1, part is scratch of (splits, b*s,
// 512) floats, else qpart is scratch of (2, b*s, a) floats. Returns
// cudaGetLastError().
extern "C" int dz_iqn_head_fwd_bf16(const void* cos, const void* semb,
                                    const void* img, const void* bh,
                                    const void* wo, const void* bo, void* q,
                                    void* h, void* part, void* qpart, int b,
                                    int s, int d, int a, int residuals,
                                    int splits, int per, void* cuda_stream) {
  cudaStream_t st = (cudaStream_t)cuda_stream;
  if (b * s <= 0) return (int)cudaGetLastError();
  const int nchunks = (d + kKC - 1) / kKC;
  if (d % 32 || splits < 1 || per < 1 || (splits - 1) * per >= nchunks ||
      splits * per < nchunks || (splits > 1 && part == nullptr) ||
      (splits == 1 && qpart == nullptr))
    return (int)cudaErrorInvalidValue;
  return (int)(residuals
                   ? launch<true>(cos, semb, img, bh, wo, bo, q, h, part,
                                  qpart, b, s, d, a, splits, per, st)
                   : launch<false>(cos, semb, img, bh, wo, bo, q, h, part,
                                   qpart, b, s, d, a, splits, per, st));
}

// Bytes of a staged chunk (what = 0), rows of D a chunk (1) and bytes of
// dynamic shared memory a block of the kernel takes (2), for the wrapper's
// checks and the build report beside `-Xptxas -v`'s static counts.
extern "C" int dz_iqn_head_fwd_bf16_sizes(int what) {
  return what == 0 ? kChunkB : what == 1 ? kKC : kSmem;
}
