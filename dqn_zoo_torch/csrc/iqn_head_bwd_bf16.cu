// K4b and K4c in bf16 mode: the backward kernels of the fused IQN per-tau
// head with bf16 operands (mm = bfloat16), and the staging pass that feeds
// them.
//
// Replace the TPU kernels of dqn_zoo_tpu/nets/iqn_head.py with mm = bfloat16:
//   K4b `_bwd_w_call` -> `_bwd_w_kernel`   dwh            (bwd_w_bf16_kernel)
//   K4c `_bwd_d_call` -> `_bwd_d_kernel`   dwe, dbe, ds_emb, dcos
//                                                         (bwd_d_bf16_kernel)
// They compute what csrc/iqn_head_bwd.cu computes (its notes give the
// arithmetic), with the operands of cos @ we, hi^T @ dh, dh @ wh^T,
// cos^T @ dte and dte @ we^T rounded to bf16 (to nearest even, as XLA's
// convert rounds) and every product accumulated in f32; dbh, dbe, ds_emb
// and the s_emb factors stay f32. Like the TPU kernels, the (rows, D)
// tensors te, hi, dhi and dte never reach device memory.
//
// The staging pass (stage_bf16_kernel) replaces no TPU kernel. It is the
// rounding of the reference's `_dot` (dqn_zoo_tpu/nets/iqn_head.py) done
// once for both kernels: it reads dh (rows, 512), cos (rows, 64), we
// (64, D) and wh (D, 512) in f32 and writes their bf16 copies (we
// transposed to (D, 64)), and sums dbh = sum_rows dh in f32 in a fixed
// order (block partials of 128 rows, then added in block order). Its bound
// is bytes: at the learn shape ~0.24 GB, ~0.07 ms at 3.35 TB/s.
//
// Bound on the H100: operations. At the learn shape (B = 1024, S = 64) K4b
// is 237 GFLOP and K4c (without dcos) 263 GFLOP, 0.24 and 0.27 ms at the
// 989 TFLOP/s bf16 rate. Their products take bf16 operands from swizzled
// shared memory that holds bf16 (loaded by cp.async from the staged
// copies: no rounding in the loops, half the bytes of f32) and accumulate
// in f32 on the tensor cores at the bf16 rate, twice TF32's: K4b's dwh
// and K4c's te_pre and dhi by `wgmma` (sm_90a), the small rest by
// `mma.sync.m16n8k16` fed by `ldmatrix`.
// Every tile keeps its 16-byte piece p of row r at p ^ (r & 7) (rows of
// 128 bytes or a multiple), so the 8 rows an `ldmatrix` phase reads fall on
// 8 different bank groups; for 128-byte rows from a 1024-byte boundary
// that is also wgmma's 128-byte swizzle.
//
// Rows are walked in chunks of 64 (kRC). A block owns a tile of D (128
// columns) and walks the rows of one group; the groups' partial sums are
// added in group order by a second kernel of the same launch, so every sum
// is taken in a fixed order: no atomics, results repeat bit for bit. The
// wrapper picks the number of groups from the shape alone (iqn_head.py,
// `bf16_groups_w`, `bf16_groups_d`): of the counts that give each of the
// 132 SMs a block, the one of least cost in waves x chunks a group.
//
// K4b. A block owns a 128 (D) x 256 (H) tile of dwh (grid: 25 x 2 x groups
// at D = 3136), two warpgroups of 64 rows each; its chunks of 64 rows of dh
// (bf16, 256 columns as 4 blocks of 64 rows x 128 bytes) and of cos arrive
// through a ring of 4 cp.async stages. Per chunk:
//   te_pre^T = we_tile^T @ cos_chunk^T  warp w takes D rows 16 w .. + 15
//                                       (mma.sync): 4 k-steps over latent
//                                       64, 8 column tiles of rows. The
//                                       accumulators of two neighbouring
//                                       column tiles are exactly one A
//                                       fragment of hi^T @ dh (rows 16 q ..
//                                       + 15 as its k), and the warp's 16
//                                       rows of its warpgroup's wgmma A
//                                       operand have that layout: so hi =
//                                       relu(te_pre) * s_emb[r / S] is formed
//                                       and rounded to bf16 in registers and
//                                       never stored;
//   dwh += hi^T @ dh_chunk             4 wgmma m64n256k16 a warpgroup, A
//                                       from those registers, B (dh) from
//                                       the stage, MN-major; 128
//                                       accumulators a lane.
// The two are pipelined: step k starts chunk k's products and, while they
// run, forms chunk k + 1's hi, waiting for them only before it hands the
// registers on; one block barrier a chunk.
// The group's sum over its k-steps goes straight into the accumulators: at
// most 205 chunks (820 k-steps) a group at the learn shape, over which the
// tensor cores' truncating adds keep dwh within 5e-6 relative Frobenius
// (tests/test_torch_kernel_plans.py emulates it), a twentieth of the check.
// Shared memory: 4 x (32 + 8) KB ring + we^T 16 KB + 1 KB to align = 177
// KB.
//
// K4c. A block owns 128 columns of D with their rows of wh resident in
// bf16 (128 KB, as 8 blocks of 64 k) and walks its group's rows (a group
// holds whole streams); dh arrives in chunks of 64 rows x 128 deep (2
// blocks of 64 k) through a ring of 3 cp.async stages, one block barrier
// a chunk. Warpgroup wg owns columns 64 wg .. + 63 of the tile for all 64
// rows of a row chunk, warp w its row slice 16 (w & 3) .. + 15. Per row
// chunk:
//   te_pre = cos_chunk @ we_tile   4 wgmma m64n64k16, and
//   dhi = dh_chunk @ wh_tile^T     32 (8 a dh chunk), both operands K-major
//                                  from shared memory, into accumulators of
//                                  one layout, so dte, g = dhi * te and the
//                                  te_mask bits are formed in registers;
//                                  dte goes to shared memory in bf16 (the B
//                                  operand below), and each lane adds its
//                                  rows' dte to its dbe;
//   ds_emb                         where the chunk is one stream (S >= 64
//                                  on stream boundaries: the learn shape),
//                                  each slice sums its rows (a lane's 2 in
//                                  order, then a butterfly across lanes),
//                                  and after the barrier one thread a
//                                  column adds the 4 slices' sums in slice
//                                  order to the one handed on from the
//                                  last chunk; else the slices go one after
//                                  another on named barriers, each stream
//                                  running on past a slice handing its sum
//                                  on: every sum runs in row order;
//   dwe += cos_chunk^T @ dte       mma.sync, 4 k-steps over the chunk's
//                                  rows, ldmatrix.trans of both; warp
//                                  (wm, wn) owns 32 x 32 of the (64, 128)
//                                  tile for the whole walk;
//   dcos part = dte @ we_tile^T    only when asked for (mma.sync): 8
//                                  k-steps over the tile's columns, one
//                                  partial a tile, added in tile order by
//                                  the second kernel.
// Shared memory: wh 128 KB + ring 3 x 16 KB + cos 2 x 8 KB + we^T 16 KB +
// dte 16 KB + 2 KB + 1 KB to align = 227 KB, one block per SM (232,448
// bytes, the most a block can take).
//
// ReLU branch: te_pre is summed in another order than a library product
// sums it, so an entry within rounding of 0 may take the other branch; K4c
// writes its own branch bits (te_pre > 0) to a (rows, D) byte mask when
// asked, as the f32 kernel does.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kL = 64;   // cosine features per tau sample
constexpr int kH = 512;  // hidden width
constexpr int kRC = 64;  // rows per chunk
constexpr int kMaxDevices = 64;

// K4b: columns of D and of H per block, ring stages, and the bytes of one
// stage's dh rows, of one stage's cosine rows and of the we^T tile (and
// 1024 to align the stages).
constexpr int kBD = 128;
constexpr int kBH = 256;
constexpr int kWStages = 4;
constexpr int kDhRowB = kBH * 2;
constexpr int kDhStageB = kRC * kDhRowB;
constexpr int kCosRowB = kL * 2;
constexpr int kCosStageB = kRC * kCosRowB;
constexpr int kWeTB = kBD * kCosRowB;
constexpr int kSmemW = 1024 + kWStages * (kDhStageB + kCosStageB) + kWeTB;
static_assert(kSmemW <= 232448, "K4b's shared memory exceeds the H100's");

// K4c: columns of D per block, ring stages, depth of a dh chunk, and the
// bytes of the wh tile, of a ring stage and of the dte tile (and 1024 to
// align the tiles, and the ds_emb hand-on sums).
constexpr int kCD = 128;
constexpr int kDStages = 3;
constexpr int kKC = 128;
constexpr int kKChunks = kH / kKC;
constexpr int kWhRowB = kH * 2;
constexpr int kWhB = kCD * kWhRowB;
constexpr int kRingRowB = kKC * 2;
constexpr int kRingB = kRC * kRingRowB;
constexpr int kDteRowB = kCD * 2;
constexpr int kDteB = kRC * kDteRowB;
constexpr int kSmemD = 1024 + kWhB + kDStages * kRingB + 2 * kCosStageB +
                       kWeTB + kDteB + 4 * kCD * 4;
static_assert(kSmemD <= 232448, "K4c's shared memory exceeds the H100's");
static_assert(kBD == kCD, "both kernels stage the same we^T tile");

// The staging pass: rows of dh a block sums.
constexpr int kStageRows = 128;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Copies `bytes` (0 or 16) bytes and zero-fills the rest of 16.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(n) : "memory");
}

// Four 8x8 b16 matrices; lanes 8 i .. 8 i + 7 give the row addresses of
// matrix i, and lane (g, t) = (lane / 4, lane % 4) receives row g, columns
// 2t and 2t + 1 of each (with .trans: rows 2t and 2t + 1, column g).
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr) : "memory");
}

__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr) : "memory");
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

// Two floats rounded to bf16 (to nearest even), x in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The warpgroup's asynchronous products (wgmma, sm_90a). A fence before a
// batch (the A registers and accumulators were written by other
// instructions), a commit after it, and a wait before the registers or the
// shared memory it reads are touched again.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most n of the warpgroup's committed batches are pending.
template <int n>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(n) : "memory");
}

// Orders this thread's generic-proxy writes to shared memory (cp.async's)
// before the async proxy's reads (wgmma's).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A barrier of the two warps (64 threads) of a producer and a consumer:
// the producer arrives once its writes are done, the consumer waits.
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 64;\n" :: "r"(id) : "memory");
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 64;\n" :: "r"(id) : "memory");
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
// layout, MN-major: 8 rows (along K) of 128 bytes (64 values along MN) an
// atom, each row's 16-byte piece p at p ^ (row & 7); atoms `lbo` bytes
// apart along MN and `sbo` apart along K. `addr` is 1024-byte aligned but
// for whole rows.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// d += a @ b for the warpgroup's 64 x 256 x 16 step: a (this warp's 16
// rows, laid out as mma.sync's A fragment) from registers, b (16 x 256)
// from shared memory through `desc`, MN-major (transposed); d at (row g
// (+ 8), column 8 j + 2 t (+ 1)) of the warp's rows as d[j][0..3], as
// mma.sync's C fragments of 32 column tiles.
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

// d = a @ b (accumulate: d += a @ b) for the warpgroup's 64 x 64 x 16
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

// Byte offset of 16-byte piece p of row r in a tile of `row_bytes` rows.
__device__ __forceinline__ int swz(int r, int p, int row_bytes) {
  return r * row_bytes + ((p ^ (r & 7)) << 4);
}

// First unit of group g when n units are cut into `groups` consecutive
// groups (group_begin(groups, ...) = n).
__device__ __forceinline__ int group_begin(int g, int groups, int n) {
  return (int)((long long)g * n / groups);
}

// ---------------------------------------------------------- staging ------

// Blocks [0, dh_blocks): 128 rows of dh each, 128 threads of 4 columns x 2
// halves of 64 rows: the bf16 copy, and the block's column sums (its first
// half's rows in order, plus its second half's) as partial `blockIdx.x`.
// The other blocks: the bf16 copies of cos and wh and the transposed one of
// we, over a grid-stride loop.
__global__ void __launch_bounds__(kThreads)
stage_bf16_kernel(const float* __restrict__ dh, const float* __restrict__ cosx,
                  const float* __restrict__ we, const float* __restrict__ wh,
                  __nv_bfloat16* __restrict__ dh16,
                  __nv_bfloat16* __restrict__ cos16,
                  __nv_bfloat16* __restrict__ wet16,
                  __nv_bfloat16* __restrict__ wh16,
                  float* __restrict__ dbh_part, int rows, int d,
                  int dh_blocks) {
  if ((int)blockIdx.x < dh_blocks) {
    __shared__ float4 upper[kH / 4];
    const int ct = threadIdx.x & (kH / 4 - 1), half = threadIdx.x >> 7;
    const int r0 = blockIdx.x * kStageRows + half * (kStageRows / 2);
    const int n = min(kStageRows / 2, rows - r0);
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int i = 0; i < n; ++i) {
      const long long at = (long long)(r0 + i) * kH + 4 * ct;
      const float4 v = __ldg(reinterpret_cast<const float4*>(dh + at));
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
      *reinterpret_cast<uint2*>(dh16 + at) =
          make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
    }
    if (half == 1) upper[ct] = sum;
    __syncthreads();
    if (half == 0) {
      const float4 u = upper[ct];
      sum.x += u.x;
      sum.y += u.y;
      sum.z += u.z;
      sum.w += u.w;
      reinterpret_cast<float4*>(dbh_part + (long long)blockIdx.x * kH)[ct] =
          sum;
    }
    return;
  }
  const long long n_cos = (long long)rows * (kL / 4);
  const long long n_wh = wh != nullptr ? (long long)d * (kH / 4) : 0;
  const long long n_all = n_cos + n_wh + (long long)d * (kL / 4);
  const long long stride = (long long)(gridDim.x - dh_blocks) * kThreads;
  for (long long i = (long long)(blockIdx.x - dh_blocks) * kThreads +
                     threadIdx.x;
       i < n_all; i += stride) {
    if (i < n_cos || i < n_cos + n_wh) {
      const bool is_cos = i < n_cos;
      const long long j = is_cos ? i : i - n_cos;
      const float4 v = __ldg(reinterpret_cast<const float4*>(
                                 is_cos ? cosx : wh) + j);
      *reinterpret_cast<uint2*>((is_cos ? cos16 : wh16) + 4 * j) =
          make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
    } else {
      // we^T row c, latent 4 l4 .. 4 l4 + 3.
      const long long j = i - n_cos - n_wh;
      const int c = (int)(j >> 4), l = 4 * (int)(j & 15);
      const float* p = we + (long long)l * d + c;
      *reinterpret_cast<uint2*>(wet16 + (long long)c * kL + l) = make_uint2(
          pack_bf16(__ldg(p), __ldg(p + d)),
          pack_bf16(__ldg(p + 2 * d), __ldg(p + 3 * d)));
    }
  }
}

// out (kH floats) = the nparts partials of kH floats added in a fixed order:
// warp c takes the 4 columns 4c .. 4c + 3, lane i the partials i, i + 32,
// ... in order, then a butterfly over the lanes.
__global__ void __launch_bounds__(kThreads)
column_sum_kernel(const float4* __restrict__ part, float4* __restrict__ out,
                  int nparts) {
  const int c = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int p = lane; p < nparts; p += 32) {
    const float4 v = part[(long long)p * (kH / 4) + c];
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
    acc.x += __shfl_xor_sync(0xffffffffu, acc.x, m);
    acc.y += __shfl_xor_sync(0xffffffffu, acc.y, m);
    acc.z += __shfl_xor_sync(0xffffffffu, acc.z, m);
    acc.w += __shfl_xor_sync(0xffffffffu, acc.w, m);
  }
  if (lane == 0) out[c] = acc;
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
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  out[i] = acc;
}

cudaError_t sum_partials(const void* part, void* out, long long n, int nparts,
                         cudaStream_t st) {
  const long long n4 = n / 4;
  sum_partials_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0, st>>>(
      (const float4*)part, (float4*)out, n4, nparts);
  return cudaGetLastError();
}

// The block's 128 rows of we^T (d0 .. d0 + 127; rows past d zero-filled),
// 8 pieces a row, swizzled.
__device__ __forceinline__ void copy_wet(uint32_t dst,
                                         const __nv_bfloat16* wet16, int d0,
                                         int d) {
  for (int i = threadIdx.x; i < kBD * 8; i += kThreads) {
    const int r = i >> 3, p = i & 7;
    const bool in = d0 + r < d;
    cp_async16(dst + swz(r, p, kCosRowB),
               in ? (const void*)(wet16 + (long long)(d0 + r) * kL + 8 * p)
                  : (const void*)wet16,
               in ? 16 : 0);
  }
}

// Cosine rows r0 .. r0 + 63 (rows at or past `end` zero-filled).
__device__ __forceinline__ void copy_cos(uint32_t dst,
                                         const __nv_bfloat16* cos16, int r0,
                                         int end) {
  for (int i = threadIdx.x; i < kRC * 8; i += kThreads) {
    const int r = i >> 3, p = i & 7;
    const bool in = r0 + r < end;
    cp_async16(dst + swz(r, p, kCosRowB),
               in ? (const void*)(cos16 + (long long)(r0 + r) * kL + 8 * p)
                  : (const void*)cos16,
               in ? 16 : 0);
  }
}

// ---------------------------------------------------------------- K4b ------

__global__ void __launch_bounds__(kThreads, 1)
bwd_w_bf16_kernel(const __nv_bfloat16* __restrict__ cos16,
                  const float* __restrict__ semb,
                  const __nv_bfloat16* __restrict__ dh16,
                  const __nv_bfloat16* __restrict__ wet16,
                  const float* __restrict__ be,
                  float* __restrict__ out,  // [groups][d][512]
                  int s, int nb, int d) {
  extern __shared__ __align__(1024) uint8_t smem[];
  // The dh stages start on a 1024-byte boundary, as the swizzle wants.
  const uint32_t ring_s = (smem_u32(smem) + 1023) & ~1023u;
  // dh: [stage][4 blocks of 64 columns][64 rows][128 B], swizzled.
  const uint32_t cos_s = ring_s + kWStages * kDhStageB;  // [stage][64][128 B]
  const uint32_t wet_s = cos_s + kWStages * kCosStageB;  // [128][128 B]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int d0 = blockIdx.x * kBD, h0 = blockIdx.y * kBH;
  const int rows = nb * s;
  const int nchunks = (rows + kRC - 1) / kRC;
  const int c_lo = group_begin(blockIdx.z, gridDim.z, nchunks);
  const int nsteps = group_begin(blockIdx.z + 1, gridDim.z, nchunks) - c_lo;

  // Chunk k of the group (rows (c_lo + k) * 64 ..) into stage k % 3: the dh
  // rows' 256 columns of this block (32 pieces a row, 8 a column block) and
  // the cosine rows.
  auto load_chunk = [&](int k) {
    const int stage = k % kWStages, r0 = (c_lo + k) * kRC;
    const uint32_t dst = ring_s + stage * kDhStageB;
    for (int i = tid; i < kRC * 32; i += kThreads) {
      const int r = i >> 5, p = i & 31;
      const bool in = r0 + r < rows;
      cp_async16(dst + (p >> 3) * (kRC * 128) + swz(r, p & 7, 128),
                 in ? (const void*)(dh16 + (long long)(r0 + r) * kH + h0 +
                                    8 * p)
                    : (const void*)dh16,
                 in ? 16 : 0);
    }
    copy_cos(cos_s + stage * kCosStageB, cos16, r0, rows);
  };
  copy_wet(wet_s, wet16, d0, d);
  for (int k = 0; k < kWStages - 1; ++k) {
    if (k < nsteps) load_chunk(k);
    cp_async_commit();
  }

  // te_pre^T's rows: D columns d0 + 16 warp + g and + 8, the rows of dwh
  // this warp holds in its warpgroup's products.
  const int da = d0 + 16 * warp + g, db = da + 8;
  const float bias_a = da < d ? __ldg(be + da) : 0.f;
  const float bias_b = db < d ? __ldg(be + db) : 0.f;

  // hi^T of D rows 16 warp .. + 15 over chunk k's 64 rows, in registers as
  // the A operand of dwh's 4 k-steps (rows 16 q .. + 15).
  auto te = [&](int k, uint32_t (&a)[4][4]) {
    const int r0 = (c_lo + k) * kRC;
    const uint32_t cosb = cos_s + (k % kWStages) * kCosStageB;
    uint32_t afr[4][4];  // we^T: rows 16 warp + (lane & 15), k-step ks
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      ldsm4(afr[ks], wet_s + swz(16 * warp + (lane & 15),
                                 2 * ks + (lane >> 4), kCosRowB));
    // s_emb at the lane's rows: one stream for the whole chunk (S >= 64
    // with chunks on stream boundaries, the learn shape), else row by row.
    const int st0 = min(r0 / s, nb - 1);
    const bool one = st0 == min((r0 + kRC - 1) / s, nb - 1);
    const float se_a0 =
        one && da < d ? __ldg(semb + (long long)st0 * d + da) : 0.f;
    const float se_b0 =
        one && db < d ? __ldg(semb + (long long)st0 * d + db) : 0.f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float tp[4][4] = {};  // column tiles of rows 32 half + 8 n ..
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int pp = 0; pp < 2; ++pp) {
          // B (k = latent, n = row) from the cosine rows [row][latent]:
          // matrices (rows +0..7, k 0..7), (+0..7, 8..15), (+8..15, 0..7),
          // (+8..15, 8..15).
          uint32_t b[4];
          ldsm4(b, cosb + swz(32 * half + 16 * pp + (lane & 7) +
                                  ((lane >> 4) << 3),
                              2 * ks + ((lane >> 3) & 1), kCosRowB));
          mma_bf16(tp[2 * pp], afr[ks], b[0], b[1]);
          mma_bf16(tp[2 * pp + 1], afr[ks], b[2], b[3]);
        }
      float hv[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float se;
          if (one) {
            se = e < 2 ? se_a0 : se_b0;
          } else {
            const int row = r0 + 32 * half + 8 * n + 2 * t + (e & 1);
            const int st = min(row / s, nb - 1);
            const int dd = e < 2 ? da : db;
            se = dd < d ? __ldg(semb + (long long)st * d + dd) : 0.f;
          }
          hv[n][e] = fmaxf(tp[n][e] + (e < 2 ? bias_a : bias_b), 0.f) * se;
        }
      // Column tiles 2q and 2q + 1 are k-step 2 half + q's A fragment.
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        uint32_t* f = a[2 * half + q];
        f[0] = pack_bf16(hv[2 * q][0], hv[2 * q][1]);
        f[1] = pack_bf16(hv[2 * q][2], hv[2 * q][3]);
        f[2] = pack_bf16(hv[2 * q + 1][0], hv[2 * q + 1][1]);
        f[3] = pack_bf16(hv[2 * q + 1][2], hv[2 * q + 1][3]);
      }
    }
  };

  // Pipelined: step k starts the warpgroup's products of chunk k (hi from
  // registers, dh from its stage), then, while they run, forms chunk k +
  // 1's hi, and waits for them only before it hands those registers on.
  float acc[32][4] = {};  // dwh rows da, db x the block's 256 columns
  uint32_t a[4][4];
  cp_async_wait<kWStages - 2>();
  fence_async_smem();
  __syncthreads();  // chunk 0 has landed
  te(0, a);
  for (int k = 0; k < nsteps; ++k) {
    // dwh += hi^T @ dh_chunk: the warpgroup's 64 rows x 256 columns, 4
    // k-steps of 16 rows (2048 bytes apart in each column block of 64 rows
    // x 128 bytes; column blocks 8192 bytes apart, 8-row atoms 1024).
    const uint32_t dhb = ring_s + (k % kWStages) * kDhStageB;
    pin(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_256(acc, a[kk], desc_sw128(dhb + kk * 16 * 128, kRC * 128, 1024));
    wgmma_commit();
    pin(acc);
    cp_async_wait<kWStages - 3>();
    fence_async_smem();
    __syncthreads();  // chunk k + 1 has landed; every warp has left chunk
                      // k - 1 (its products included)
    if (k + kWStages - 1 < nsteps) load_chunk(k + kWStages - 1);
    cp_async_commit();
    uint32_t next[4][4];
    if (k + 1 < nsteps) te(k + 1, next);
    wgmma_wait<0>();
    pin(acc);
    if (k + 1 < nsteps)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) a[kk][e] = next[kk][e];
  }

  float* dwh = out + (long long)blockIdx.z * d * kH;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = (h ? db : da);
    if (row >= d) continue;
    float* p = dwh + (long long)row * kH + h0 + 2 * t;
#pragma unroll
    for (int j = 0; j < 32; ++j)
      *reinterpret_cast<float2*>(p + 8 * j) =
          make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
  }
}

// ---------------------------------------------------------------- K4c ------

__global__ void __launch_bounds__(kThreads, 1)
bwd_d_bf16_kernel(const __nv_bfloat16* __restrict__ cos16,
                  const float* __restrict__ semb,
                  const __nv_bfloat16* __restrict__ dh16,
                  const __nv_bfloat16* __restrict__ wet16,
                  const float* __restrict__ be,
                  const __nv_bfloat16* __restrict__ wh16,
                  float* __restrict__ out,  // [groups][64 * d + d]
                  float* __restrict__ dsemb,
                  float* __restrict__ dcos_part,  // null: no dcos
                  uint8_t* __restrict__ te_mask,  // null: not written
                  int s, int nb, int d) {
  extern __shared__ __align__(1024) uint8_t smem[];
  // The wgmma operands start on a 1024-byte boundary, as the swizzle wants.
  const uint32_t base = smem_u32(smem);
  const uint32_t wh_s = (base + 1023) & ~1023u;  // [8 k blocks][128][128 B]
  const uint32_t ring_s = wh_s + kWhB;  // [stage][2 k blocks][64][128 B]
  const uint32_t cos_s = ring_s + kDStages * kRingB;  // [2][64][128 B]
  const uint32_t wet_s = cos_s + 2 * kCosStageB;      // [128][128 B]
  const uint32_t dte_s = wet_s + kWeTB;               // [64][256 B]
  uint8_t* const dte_p = smem + (dte_s - base);
  // Hand-on sums of ds_emb: [0] from the last row slice of a chunk to the
  // first of the next, [1 + i] from slice i to slice i + 1.
  float* const hand_s = reinterpret_cast<float*>(dte_p + kDteB);  // [4][kCD]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int d0 = blockIdx.x * kCD;
  // This block's group of streams, and its rows [row_lo, end).
  const int row_lo = group_begin(blockIdx.y, gridDim.y, nb) * s;
  const int end = group_begin(blockIdx.y + 1, gridDim.y, nb) * s;
  const int nsteps = (end - row_lo + kRC - 1) / kRC;
  const int nq = nsteps * kKChunks;

  // wh rows d0 .. d0 + 127 (64 pieces a row, 8 a k block; rows past d
  // zero-filled).
  for (int i = tid; i < kCD * 64; i += kThreads) {
    const int r = i >> 6, p = i & 63;
    const bool in = d0 + r < d;
    cp_async16(wh_s + (p >> 3) * (kCD * 128) + swz(r, p & 7, 128),
               in ? (const void*)(wh16 + (long long)(d0 + r) * kH + 8 * p)
                  : (const void*)wh16,
               in ? 16 : 0);
  }
  copy_wet(wet_s, wet16, d0, d);
  // dh chunk q: rows of row chunk q / 4, depth 128 (q % 4) .. + 127 as two
  // k blocks of 64, into ring stage q % 3; the cosine rows of a row chunk
  // come with its first.
  auto copy_dh = [&](int q) {
    const int r0 = row_lo + (q / kKChunks) * kRC, k0 = kKC * (q % kKChunks);
    const uint32_t dst = ring_s + (q % kDStages) * kRingB;
    for (int i = tid; i < kRC * (kKC / 8); i += kThreads) {
      const int r = i / (kKC / 8), p = i % (kKC / 8);
      const bool in = r0 + r < end;
      cp_async16(dst + (p >> 3) * (kRC * 128) + swz(r, p & 7, 128),
                 in ? (const void*)(dh16 + (long long)(r0 + r) * kH + k0 +
                                    8 * p)
                    : (const void*)dh16,
                 in ? 16 : 0);
    }
    if (q % kKChunks == 0)
      copy_cos(cos_s + ((q / kKChunks) & 1) * kCosStageB, cos16, r0, end);
  };
  for (int q = 0; q < kDStages - 1; ++q) {  // nq >= 4 > 2
    copy_dh(q);
    cp_async_commit();
  }

  // te_pre and dhi: warpgroup wg takes the tile's columns 64 wg .. + 63 of
  // all 64 rows of a chunk; warp w its row slice sl = w & 3: accumulator
  // (j, e) is row 16 sl + g + 8 (e >> 1), column 64 wg + 8 j + 2 t + (e & 1).
  const int wg = warp >> 2, sl = warp & 3;
  const int cw = 64 * wg;  // the warpgroup's first column in the tile
  float2 bias[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    bias[j] = d0 + cw + 8 * j < d  // d is a multiple of 32
                  ? __ldg(reinterpret_cast<const float2*>(be + d0 + cw +
                                                          8 * j + 2 * t))
                  : make_float2(0.f, 0.f);
  // dwe (mma.sync): warp (wm, wn) owns its rows 32 wm + 16 i (+ g, + 8) at
  // columns 32 wn + 8 j + 2 t (+ 1), for the whole walk; dbe: the lane's
  // sum of dte over its rows at its te_pre columns.
  const int wm = warp >> 2, wn = warp & 3;
  float dwe_acc[2][4][4] = {};
  float dbe_acc[8][2] = {};

  for (int c = 0; c < nsteps; ++c) {
    const int r0 = row_lo + c * kRC;
    const uint32_t cosb = cos_s + (c & 1) * kCosStageB;
    float tp[8][4];
    float acc[8][4];
#pragma unroll 1
    for (int kc = 0; kc < kKChunks; ++kc) {
      const int q = c * kKChunks + kc;
      cp_async_wait<kDStages - 2>();
      fence_async_smem();
      __syncthreads();  // chunk q (and at kc = 0 the cosine rows) landed;
                        // every warp has left chunk q - 1
      if (q + kDStages - 1 < nq) copy_dh(q + kDStages - 1);
      cp_async_commit();
      pin(tp);
      pin(acc);
      wgmma_fence();
      if (kc == 0)  // te_pre = cos_chunk @ we_tile, both K-major
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma_64_ss(tp, desc_sw128(cosb + 32 * ks, 16, 1024),
                      desc_sw128(wet_s + cw * 128 + 32 * ks, 16, 1024), ks);
      // dhi += dh_chunk @ wh_tile^T over depth 128 kc .. + 127: 8 k-steps,
      // A (dh rows) and B (wh rows) K-major, a k-step 32 bytes on in its k
      // block of 64.
      const uint32_t ab = ring_s + (q % kDStages) * kRingB;
#pragma unroll
      for (int ks = 0; ks < kKC / 16; ++ks)
        wgmma_64_ss(acc,
                    desc_sw128(ab + (ks >> 2) * (kRC * 128) + 32 * (ks & 3),
                               16, 1024),
                    desc_sw128(wh_s + (2 * kc + (ks >> 2)) * (kCD * 128) +
                                   cw * 128 + 32 * (ks & 3),
                               16, 1024),
                    kc + ks);
      wgmma_commit();
      wgmma_wait<0>();
      pin(tp);
      pin(acc);
    }

    // Elementwise, in registers: dte, g = dhi * te and the branch bits.
    const int st0 = min(r0 / s, nb - 1);
    const bool one = st0 == min((r0 + kRC - 1) / s, nb - 1);
    float2 se1[8];  // s_emb at the lane's columns when one stream
#pragma unroll
    for (int j = 0; j < 8; ++j)
      se1[j] = one && d0 + cw + 8 * j < d
                   ? __ldg(reinterpret_cast<const float2*>(
                         semb + (long long)st0 * d + d0 + cw + 8 * j + 2 * t))
                   : make_float2(0.f, 0.f);
    float gv[2][8][2];  // [h][j][e]: g of row 16 sl + g + 8 h
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rl = 16 * sl + g + 8 * h;  // row in the chunk
      const int row = r0 + rl;
      const int st = min(row / s, nb - 1);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = cw + 8 * j + 2 * t;
        const bool cin = d0 + cw + 8 * j < d;
        const float2 se =
            one ? se1[j]
                : (cin ? __ldg(reinterpret_cast<const float2*>(
                             semb + (long long)st * d + d0 + col))
                       : make_float2(0.f, 0.f));
        const float t0 = tp[j][2 * h] + bias[j].x;
        const float t1 = tp[j][2 * h + 1] + bias[j].y;
        const float x0 = acc[j][2 * h], x1 = acc[j][2 * h + 1];
        const bool p0 = t0 > 0.f, p1 = t1 > 0.f;
        const float e0 = p0 ? x0 * se.x : 0.f, e1 = p1 ? x1 * se.y : 0.f;
        dbe_acc[j][0] += e0;
        dbe_acc[j][1] += e1;
        gv[h][j][0] = x0 * fmaxf(t0, 0.f);
        gv[h][j][1] = x1 * fmaxf(t1, 0.f);
        *reinterpret_cast<uint32_t*>(dte_p + swz(rl, col >> 3, kDteRowB) +
                                     2 * (col & 7)) = pack_bf16(e0, e1);
        if (te_mask != nullptr && row < end && cin)
          *reinterpret_cast<uint16_t*>(te_mask + (long long)row * d + d0 +
                                       col) =
              (uint16_t)((p0 ? 1u : 0u) | (p1 ? 256u : 0u));
      }
    }

    // ds_emb. Where the chunk is one stream (S >= 64 with chunks on stream
    // boundaries: the learn shape), each slice sums its 16 rows (a lane's 2
    // in row order, then a butterfly over g: every lane ends with the same
    // bits) into hand_s[slice], slice 0 after the sum handed on from the
    // last chunk, and after the barrier the column's thread adds the four
    // in slice order. Else the slices of a warpgroup run one after the
    // other, each waiting on a named barrier for the one before, stream by
    // stream over their rows [w0, w1): a stream begun before w0 starts from
    // the sum handed on by the slice before (the last slice of the last
    // chunk for slice 0), one running on past w1 hands its sum on.
    const int w0 = r0 + 16 * sl, w1 = min(w0 + 16, end);
    auto slice_sums = [&](int a, int e, float (&v)[8][2]) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          float sum = 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = w0 + 8 * h + g;
            if (row >= a && row < e && row < end) sum += gv[h][j][u];
          }
          sum += __shfl_xor_sync(0xffffffffu, sum, 4);
          sum += __shfl_xor_sync(0xffffffffu, sum, 8);
          sum += __shfl_xor_sync(0xffffffffu, sum, 16);
          v[j][u] = sum;
        }
    };
    if (one) {
      float v[8][2];
      slice_sums(st0 * s, st0 * s + s, v);
      if (g == 0)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int col = cw + 8 * j + 2 * t + u;
            float x = v[j][u];
            if (sl == 0 && st0 * s < r0) x = hand_s[col] + x;
            hand_s[sl * kCD + col] = x;
          }
    } else {
      if (sl > 0) named_sync(1 + 3 * wg + sl - 1);
      float* const from = hand_s + (sl == 0 ? 0 : sl) * kCD;
      float* const to = hand_s + (sl == 3 ? 0 : sl + 1) * kCD;
      for (int st = w0 / s; w0 < w1 && st <= (w1 - 1) / s; ++st) {
        const int a = st * s, e = a + s;  // the stream's rows [a, e)
        float v[8][2];
        slice_sums(a, e, v);
        if (g == 0)
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const int col = cw + 8 * j + 2 * t + u;
              if (d0 + cw + 8 * j >= d) continue;
              float x = v[j][u];
              if (a < w0) x = from[col] + x;
              if (e > w1)
                to[col] = x;
              else
                dsemb[(long long)st * d + d0 + col] = x;
            }
      }
      if (sl < 3) named_arrive(1 + 3 * wg + sl);
    }
    __syncthreads();  // dte and the slices' sums are in
    if (one && tid < kCD && d0 + tid < d) {
      const float x = ((hand_s[tid] + hand_s[kCD + tid]) +
                       hand_s[2 * kCD + tid]) + hand_s[3 * kCD + tid];
      if ((st0 + 1) * s > r0 + kRC)
        hand_s[tid] = x;  // the stream runs on into the next chunk
      else
        dsemb[(long long)st0 * d + d0 + tid] = x;
    }

    // dwe += cos_chunk^T @ dte: A (m = latent, k = row) from the cosine
    // rows [row][latent] transposed: matrices (m +0..7, k 0..7), (+8..15,
    // 0..7), (+0..7, 8..15), (+8..15, 8..15); B (k = row, n = column) from
    // dte [row][column] transposed.
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t a[2][4], b[2][4];
      const int mi = lane >> 3;
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm4_t(a[i], cosb + swz(16 * ks + (lane & 7) + ((mi >> 1) << 3),
                                 4 * wm + 2 * i + (mi & 1), kCosRowB));
#pragma unroll
      for (int p = 0; p < 2; ++p)
        ldsm4_t(b[p], dte_s + swz(16 * ks + (lane & 7) +
                                      (((lane >> 3) & 1) << 3),
                                  4 * wn + 2 * p + (lane >> 4), kDteRowB));
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          mma_bf16(dwe_acc[i][2 * p], a[i], b[p][0], b[p][1]);
          mma_bf16(dwe_acc[i][2 * p + 1], a[i], b[p][2], b[p][3]);
        }
    }

    if (dcos_part != nullptr) {
      // This tile's share of dcos = dte @ we^T: warp w takes rows 16 (w & 3)
      // .. + 15 of the chunk and latent 32 (w >> 2) .. + 31, 8 k-steps over
      // the tile's columns. A from dte [row][column]; B (k = column, n =
      // latent) from we^T [column][latent] transposed.
      const int mr = 16 * (warp & 3), nl = 32 * (warp >> 2);
      float cc[4][4] = {};
#pragma unroll
      for (int ks = 0; ks < kCD / 16; ++ks) {
        uint32_t a[4], b[2][4];
        ldsm4(a, dte_s + swz(mr + (lane & 15), 2 * ks + (lane >> 4),
                             kDteRowB));
#pragma unroll
        for (int p = 0; p < 2; ++p)
          ldsm4_t(b[p], wet_s + swz(16 * ks + (lane & 7) +
                                        (((lane >> 3) & 1) << 3),
                                    (nl >> 3) + 2 * p + (lane >> 4),
                                    kCosRowB));
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          mma_bf16(cc[2 * p], a, b[p][0], b[p][1]);
          mma_bf16(cc[2 * p + 1], a, b[p][2], b[p][3]);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + mr + g + 8 * h;
        if (row >= end) continue;
        float* o = dcos_part +
                   ((long long)blockIdx.x * nb * s + row) * kL + nl + 2 * t;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<float2*>(o + 8 * j) =
              make_float2(cc[j][2 * h], cc[j][2 * h + 1]);
      }
    }
  }

  float* dwe = out + (long long)blockIdx.y * ((long long)kL * d + d);
  if (d0 + 32 * wn < d)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<float2*>(
              dwe + (long long)(32 * wm + 16 * i + g + 8 * h) * d + d0 +
              32 * wn + 8 * j + 2 * t) =
              make_float2(dwe_acc[i][j][2 * h], dwe_acc[i][j][2 * h + 1]);
  // dbe: the lanes' sums over g (a butterfly), then the row slices' in
  // slice order through shared memory (over dte, which everyone has left
  // once the barrier below is passed).
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float v = dbe_acc[j][u];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      dbe_acc[j][u] = v;
    }
  float* const red = reinterpret_cast<float*>(dte_p);  // [4 slices][kCD]
  __syncthreads();
  if (g == 0)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float2*>(red + sl * kCD + cw + 8 * j + 2 * t) =
          make_float2(dbe_acc[j][0], dbe_acc[j][1]);
  __syncthreads();
  if (tid < kCD && d0 + tid < d)
    dwe[(long long)kL * d + d0 + tid] =
        ((red[tid] + red[kCD + tid]) + red[2 * kCD + tid]) +
        red[3 * kCD + tid];
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

}  // namespace

// dh (rows, 512), cos (rows, 64), we (64, d), wh (d, 512) or null, all f32
// -> dh16, cos16, wet16 (d, 64: we transposed), wh16 (when wh is given), all
// bf16 rounded to nearest even, and dbh (512) = sum_rows dh in f32, through
// dbh_part, a scratch buffer of ceil(rows / 128) x 512 floats. d a multiple
// of 32. Returns cudaGetLastError().
extern "C" int dz_iqn_head_stage_bf16(const void* dh, const void* cos,
                                      const void* we, const void* wh,
                                      void* dh16, void* cos16, void* wet16,
                                      void* wh16, void* dbh_part, void* dbh,
                                      int rows, int d, void* cuda_stream) {
  cudaStream_t st = (cudaStream_t)cuda_stream;
  const int dh_blocks = (rows + kStageRows - 1) / kStageRows;
  const long long rest = (long long)rows * (kL / 4) +
                         (wh ? (long long)d * (kH / 4) : 0) +
                         (long long)d * (kL / 4);
  const long long rest_blocks = (rest + kThreads - 1) / kThreads;
  stage_bf16_kernel<<<dh_blocks + (int)(rest_blocks < 1056 ? rest_blocks
                                                           : 1056),
                      kThreads, 0, st>>>(
      (const float*)dh, (const float*)cos, (const float*)we,
      (const float*)wh, (__nv_bfloat16*)dh16, (__nv_bfloat16*)cos16,
      (__nv_bfloat16*)wet16, (__nv_bfloat16*)wh16, (float*)dbh_part, rows, d,
      dh_blocks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  column_sum_kernel<<<kH / 4 / (kThreads / 32), kThreads, 0, st>>>(
      (const float4*)dbh_part, (float4*)dbh, dh_blocks);
  return (int)cudaGetLastError();
}

// The staged cos16 (b*s, 64), dh16 (b*s, 512), wet16 (d, 64) and f32 semb
// (b, d), be (d) -> dwh (d, 512) in `out`. With groups > 1 (at most
// ceil(b*s / 64)) the rows are cut into that many groups of whole 64-row
// chunks and `part` is a scratch buffer of groups x d x 512 floats; with
// groups == 1 it is not read. d a multiple of 32, b*s >= 1. Returns
// cudaGetLastError().
extern "C" int dz_iqn_head_bwd_w_bf16(const void* cos16, const void* semb,
                                      const void* dh16, const void* wet16,
                                      const void* be, void* out, void* part,
                                      int b, int s, int d, int groups,
                                      void* cuda_stream) {
  cudaStream_t st = (cudaStream_t)cuda_stream;
  static bool smem_set[kMaxDevices];
  cudaError_t err = allow_smem(bwd_w_bf16_kernel, kSmemW, smem_set);
  if (err != cudaSuccess) return (int)err;
  bwd_w_bf16_kernel<<<dim3((d + kBD - 1) / kBD, kH / kBH, groups), kThreads,
                      kSmemW, st>>>(
      (const __nv_bfloat16*)cos16, (const float*)semb,
      (const __nv_bfloat16*)dh16, (const __nv_bfloat16*)wet16,
      (const float*)be, (float*)(groups > 1 ? part : out), s, b, d);
  err = cudaGetLastError();
  if (err == cudaSuccess && groups > 1)
    err = sum_partials(part, out, (long long)d * kH, groups, st);
  return (int)err;
}

// As above plus wh16 (d, 512) -> out, one run of 64 * d + d floats: dwe
// (64, d) then dbe (d), with `part` (groups x (64 * d + d) floats) and
// `groups` (at most b, groups of whole streams) as above; dsemb (b, d);
// and, when dcos is not null, dcos (b*s, 64) through dcos_part, a scratch
// buffer of (ceil(d / 128), b*s, 64) floats. te_mask, when not null, gets
// (b*s, d) bytes: 1 where te_pre > 0. Returns cudaGetLastError().
extern "C" int dz_iqn_head_bwd_d_bf16(const void* cos16, const void* semb,
                                      const void* dh16, const void* wet16,
                                      const void* be, const void* wh16,
                                      void* out, void* part, void* dsemb,
                                      void* dcos, void* dcos_part,
                                      void* te_mask, int b, int s, int d,
                                      int groups, void* cuda_stream) {
  cudaStream_t st = (cudaStream_t)cuda_stream;
  static bool smem_set[kMaxDevices];
  cudaError_t err = allow_smem(bwd_d_bf16_kernel, kSmemD, smem_set);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (d + kCD - 1) / kCD;
  bwd_d_bf16_kernel<<<dim3(tiles, groups), kThreads, kSmemD, st>>>(
      (const __nv_bfloat16*)cos16, (const float*)semb,
      (const __nv_bfloat16*)dh16, (const __nv_bfloat16*)wet16,
      (const float*)be, (const __nv_bfloat16*)wh16,
      (float*)(groups > 1 ? part : out), (float*)dsemb,
      dcos ? (float*)dcos_part : nullptr, (uint8_t*)te_mask, s, b, d);
  err = cudaGetLastError();
  if (err == cudaSuccess && groups > 1)
    err = sum_partials(part, out, (long long)kL * d + d, groups, st);
  if (err == cudaSuccess && dcos != nullptr)
    err = sum_partials(dcos_part, dcos, (long long)b * s * kL, tiles, st);
  return (int)err;
}

// Bytes of dynamic shared memory a block of K4b (kernel 0) or K4c (1) in
// bf16 mode takes, for the build report beside `-Xptxas -v`'s static counts.
extern "C" int dz_iqn_head_bwd_bf16_smem(int kernel) {
  return kernel ? kSmemD : kSmemW;
}
