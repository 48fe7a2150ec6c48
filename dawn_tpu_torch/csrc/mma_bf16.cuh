// Warp-level bf16 tensor-core building blocks shared by the hand-written
// attention kernels (local_attention.cu, local_attention_tiled_bwd.cu):
// 16-byte cp.async staging of (rows, 32) bf16 tiles into padded shared
// memory, ldmatrix fragment loads, and mma.sync m16n8k16 (bf16 in, f32
// accumulate).
//
// Fragment layouts of mma.sync.m16n8k16.row.col (g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major), 4 regs of 2 bf16: a0 (row g, cols 2t, 2t+1),
//     a1 (row g+8, cols 2t..), a2 (row g, cols 2t+8..), a3 (row g+8, 2t+8..)
//   B (16 x 8, k x n), 2 regs: b0 (k 2t, 2t+1; col g), b1 (k 2t+8, 2t+9; col g)
//   C (16 x 8, f32), 4 regs: c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8)
// so the C fragments of two neighbouring n8 tiles, packed to bf16, are the A
// fragment of one k16 step of the next product (P of S, dS of dP).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace dawn_mma {

constexpr int kDim = 32;        // head width the kernels are built for
constexpr int kLd = kDim + 8;   // shared row stride in bf16: 80 B, so the 8 rows
                                // one ldmatrix reads fall in distinct banks
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Rows [r0, r0 + rows) of a (sequence, head)'s (T, 32) bf16 matrix, row i at
// src + i * ld, into shared memory at stride kLd, 16 B a thread at a time;
// rows outside [lo, hi] are zeros (unwritten shared memory may hold bf16
// Inf or NaN, and 0 * Inf in an mma is NaN).
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* __restrict__ src,
                                           size_t ld, int r0, int rows, int lo, int hi) {
  constexpr int kChunks = kDim / 8;
  for (int e = threadIdx.x; e < rows * kChunks; e += blockDim.x) {
    const int r = e / kChunks, c = (e % kChunks) * 8, row = r0 + r;
    __nv_bfloat16* d = dst + r * kLd + c;
    if (row >= lo && row <= hi)
      cp_async16(d, src + (size_t)row * ld + c);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i,
// register i receives it (row lane/4, cols 2(lane%4), +1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The same, transposed: register i receives (rows 2(lane%4), +1; col lane/4).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a b, one m16n8k16 product in f32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 -> one register of two bf16, lo in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of rows [row0, row0 + 16) x cols [col0, col0 + 16) of a
// shared (rows, kLd) tile.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* tile, int row0,
                                       int col0, int lane) {
  ldmatrix_x4(a, tile + (row0 + (lane & 15)) * kLd + col0 + (lane >> 4) * 8);
}

// B fragments of the product X . Y^T over d: Y's rows [row0, row0 + 8) as the
// n8 columns; r[0], r[1] for d in [0, 16), r[2], r[3] for [16, 32).
__device__ __forceinline__ void load_bt(uint32_t (&r)[4], const __nv_bfloat16* tile, int row0,
                                        int lane) {
  ldmatrix_x4(r, tile + (row0 + (lane & 7)) * kLd + (lane >> 3) * 8);
}

// B fragments of the product P . Y over rows: Y's rows [row0, row0 + 16) as
// the k16 step, cols [col0, col0 + 16) as two n8 tiles; r[0], r[1] for the
// first tile, r[2], r[3] for the second.
__device__ __forceinline__ void load_b(uint32_t (&r)[4], const __nv_bfloat16* tile, int row0,
                                       int col0, int lane) {
  ldmatrix_x4_trans(r, tile + (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd + col0 +
                           (lane >> 4) * 8);
}

// acc (16 x 32) += P (16 x 16, an A fragment) . Y's rows [row0, row0 + 16)
__device__ __forceinline__ void mma_rows(float (&acc)[4][4], const uint32_t (&p)[4],
                                         const __nv_bfloat16* tile, int row0, int lane) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    uint32_t b[4];
    load_b(b, tile, row0, 16 * half, lane);
    mma_bf16(acc[2 * half], p, b[0], b[1]);
    mma_bf16(acc[2 * half + 1], p, b[2], b[3]);
  }
}

// s (16 x 8) = X (two A fragments over d) . Y's rows [row0, row0 + 8)^T
__device__ __forceinline__ void mma_dot(float (&s)[4], const uint32_t (&x)[2][4],
                                        const __nv_bfloat16* tile, int row0, int lane) {
  uint32_t b[4];
  load_bt(b, tile, row0, lane);
  s[0] = s[1] = s[2] = s[3] = 0.f;
  mma_bf16(s, x[0], b[0], b[1]);
  mma_bf16(s, x[1], b[2], b[3]);
}

// C fragments of n8 tiles 2i and 2i+1 as the A fragment of k16 step i
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&lo)[4],
                                       const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// A warp's 16 x 32 f32 accumulator to global rows [row0, row0 + nrows) (the
// rest dropped) in bf16, through its own 16 rows of a shared tile: 16-byte
// stores, neighbouring lanes on neighbouring addresses.
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ dst, size_t ld,
                                           int row0, int nrows, const float (&acc)[4][4],
                                           __nv_bfloat16* tile, int lane) {
  const int g = lane >> 2, t = lane & 3;
  __syncwarp();
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<uint32_t*>(tile + (g + 8 * hh) * kLd + 8 * n + 2 * t) =
          pack_bf16(acc[n][2 * hh], acc[n][2 * hh + 1]);
  __syncwarp();
  for (int e = lane; e < 16 * (kDim / 8); e += 32) {
    const int r = e / (kDim / 8), c = (e % (kDim / 8)) * 8;
    if (r < nrows)
      *reinterpret_cast<uint4*>(dst + (size_t)(row0 + r) * ld + c) =
          *reinterpret_cast<const uint4*>(tile + r * kLd + c);
  }
}

// the max, then the sum, of a value over the 4 lanes of a quad (one row)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// shared rows a warp's band covers: 16 rows and w on each side, in k16 steps
__host__ __device__ constexpr int band_rows(int window) {
  return (16 + 2 * window + 15) / 16 * 16;
}
// shared rows a 4-warp block of 64 rows stages: warp i reads [16i, 16i + band)
__host__ __device__ constexpr int staged_rows(int window) { return 48 + band_rows(window); }

}  // namespace dawn_mma
