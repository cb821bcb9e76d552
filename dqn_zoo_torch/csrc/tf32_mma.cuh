// Device helpers shared by the IQN head's kernels (iqn_head.cu, K4a, and
// iqn_head_bwd.cu, K4c): cp.async copies and f32-accurate products on the
// TF32 tensor cores (3xTF32).
//
// 3xTF32: each f32 operand x is split into big = rna_tf32(x) and small =
// rna_tf32(x - big), and big*big + big*small + small*big is accumulated in
// f32, which keeps a product within f32 rounding. The tensor cores add in f32
// with truncation, so a long sum folds each k-step's three products into the
// accumulator with an f32 add that rounds to nearest (`mma_3xtf32_rn`).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(gmem) : "memory");
}

// As cp_async16, but copies `bytes` (0 or 16) bytes and zero-fills the rest.
__device__ __forceinline__ void cp_async16_zfill(float* smem,
                                                 const float* gmem,
                                                 int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Waits until at most n of this thread's newest copy groups are in flight.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(n) : "memory");
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from 0,
// as cvt.rna.tf32.f32 rounds it: half a TF32 ulp added to the magnitude, the
// 13 lower bits dropped.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// c += a @ b for one 16 x 8 x 8 tile, TF32 operands, f32 accumulator.
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 3xTF32: c += a_small b_big + a_big b_small + a_big b_big.
__device__ __forceinline__ void mma_3xtf32(float* c, const uint32_t* ab,
                                           const uint32_t* as,
                                           const uint32_t* bb,
                                           const uint32_t* bs) {
  mma_tf32(c, as, bb);
  mma_tf32(c, ab, bs);
  mma_tf32(c, ab, bb);
}

// The same three products into a zeroed tile, then added to c in f32 with
// rounding to nearest.
__device__ __forceinline__ void mma_3xtf32_rn(float* c, const uint32_t* ab,
                                              const uint32_t* as,
                                              const uint32_t* bb,
                                              const uint32_t* bs) {
  float p[4] = {0.f, 0.f, 0.f, 0.f};
  mma_3xtf32(p, ab, as, bb, bs);
  c[0] += p[0];
  c[1] += p[1];
  c[2] += p[2];
  c[3] += p[3];
}

// A tiles stored in the mma's fragment order (K4a's cosine tile and hi
// chunks: 64 rows x ksteps * 8 columns): for row tile i and k-step ks, lane
// (g, t) finds its four values a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
// a3 (g + 8, t + 4) at [((i * ksteps + ks) * 32 + lane) * 4 ..+3], one
// conflict-free 16-byte load straight into the mma's operand registers.
// Where element (row m, column k) of such a tile is stored:
template <int kSteps>
__device__ __forceinline__ int frag_at(int m, int k) {
  const int lane = ((m & 7) << 2) | (k & 3);
  const int r = ((m >> 3) & 1) | (((k >> 2) & 1) << 1);
  return ((((m >> 4) * kSteps + (k >> 3)) * 32 + lane) << 2) | r;
}

__device__ __forceinline__ void load_a(uint32_t* f, const float* tile,
                                       int kstep, int lane) {
  const uint4 v = *reinterpret_cast<const uint4*>(tile + (kstep * 32 + lane) * 4);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}

// The split B fragment at column n, k-step ks, of a row-major (k, n) tile:
// b0 (k = t, n = g), b1 (k = t + 4, n = g); `p` points at (8 ks + t, n).
__device__ __forceinline__ void load_b(uint32_t* bb, uint32_t* bs,
                                       const float* p, int stride) {
  split_tf32(p[0], bb[0], bs[0]);
  split_tf32(p[4 * stride], bb[1], bs[1]);
}

// Stores x's split parts.
__device__ __forceinline__ void store_split(float* big, float* small, int i,
                                            float x) {
  uint32_t b, s;
  split_tf32(x, b, s);
  big[i] = __uint_as_float(b);
  small[i] = __uint_as_float(s);
}

}  // namespace
