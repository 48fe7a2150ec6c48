// K1, K3 and K5: windowed temporal attention, forward.
//
// K1 replaces dawn_tpu/ops/local_attention.py::_local_attn_packed_kernel (the
// Pallas TPU body launched by local_attention_packed) on the packed (N, T,
// H*D) layout, T <= 256. K3 replaces _local_attn_tile_kernel (the body
// launched by local_attention_pallas) on the (N, H, T, D) layout, any T. For
// every sequence n, head h and query i both compute
//     out[n, i, h] = sum_j softmax_j(q_i . k_j + bias[h, j - i + w]) v_j
// over the keys j with |j - i| <= w and 0 <= j < T. q is pre-scaled by
// dh^-0.5 and rotary-rotated by the caller. The TPU kernels give the keys
// outside that band a -1e9 additive bias (K3: also the keys of clamped edge
// tiles and those past T); in f32 their weight is exactly 0, so visiting
// only the in-range band here computes the same function.
//
// What bounds it on an H100: memory. K1 at the top 128^2 UNet level (N=1024,
// T=200, H*dh=256, bf16): q, k, v and out come to 4*1024*200*256*2 B = 419
// MB, about 125 us at the H100 SXM's 3.35 TB/s; the in-band work is
// 4*N*H*T*(2w+1)*dh ~ 17 GFLOP, about 17 us at the 989 TFLOP/s bf16 peak. K3
// at the same level of a 400-frame video: 839 MB, 0.250 ms; 32 GFLOP.
//
// f32 (K1, K3, K5) runs the CUDA-core body, local_attn_fwd_kernel: a block
// owns one (sequence, head, tile of kQueryTile queries); it stages only the
// key/value rows the tile's band touches, [q0-w, q1-1+w] cut to [0, T), in
// shared memory as f32, builds the bias from the (H, 2w+1) vector in shared
// memory, and writes no score, probability or bias tensor to device memory.
// One thread owns one query row: scores, the row max and the row sum in f32,
// p.v accumulated in f32 registers, divided by the row sum once at the end.
// Unlike the TPU's K3 (left, center and right key tiles of bq >= w rows
// each, masked), the staged rows are exactly the band's, so any w that fits
// shared memory works ((2*(128+2w)*33 + 2w+1)*4 B <= 227 KB: w <= 370 at
// long T; the wrapper asks dawn_local_attn_max_window and raises past it).
// (N*H, tiles) go on gridDim.x and y. One shared-memory load per FMA: this
// body holds the f32 checks, not the speed.
//
// K5 replaces the body launched by local_attention_packed_stripe (K1's
// Pallas body on a rectangular block) in the packed layout: the t_loc
// queries of one rank's frames against its t_loc + 2w haloed keys. Query row
// i of the stripe sees the haloed key rows j in [i, i + 2w], at offset
// j - w - i. The TPU kernel reads a caller-built (H, tq, tk) bias; the only
// biases the system builds (dawn_tpu/ops/local_attention.py:690-717) are
// the T5 vector in the band plus -1e9 on the left halo (j < w) at the first
// rank and on the right halo (j >= w + t_loc) at the last, so K5 takes the
// (H, 2w+1) vector and two flags and skips the masked keys, whose weight is
// exactly 0 in f32. At the 2-rank split of the 128^2 top level (N=1024,
// t_loc=100, 8 x 32, w=40, bf16) it moves q, out (52.4 MB each) and the
// haloed k, v (94.4 MB each): 293.6 MB, about 88 us at 3.35 TB/s (rank 0
// reads no masked halo row: 251.7 MB, 75 us).
//
// Both bodies take one key range: a query row i sees the key rows j in
// [i + key_off - w, i + key_off + w] cut to [kmin, kmax], with the bias
// entry j - key_off - i + w. K1 and K3: key_off 0, keys [0, T). K5: key_off
// w, keys [w or 0, w + t_loc - 1 or t_loc + 2w - 1] by the edge flags.
//
// bf16 (K1, K3, K5) runs the tensor-core body, attn_fwd_mma_kernel, built
// for both layouts; the C entries dispatch on is_bf16. K1 and K3 clamp the
// band to the keys that exist: with w_eff = min(w, T - 1), [i - w_eff, i +
// w_eff] cut to [0, T) holds the same keys as [i - w, i + w], and the kernel
// reads the bias entries [w - w_eff, w + w_eff] of each head's row (bias_ld
// = 2w + 1 apart), so stage 1's w = 20 at T = 20 walks 19 keys a side.
// What bounds it: bytes, as above. The CUDA-core body cannot get near them:
// one thread a query row, every score computed twice, one shared load per
// FMA (bf16 K3 on it took 4.22 ms at T = 400, 17x its bound).
// What the design does about it: a block owns one (sequence, head, tile of
// 64 query rows), 4 warps of 16 rows. It stages with 16-byte cp.async, in
// bf16, the query tile and the key/value rows of the tile's band, zeros
// past [kmin, kmax]; a warp's band is 16 + 2w keys in k16 steps (96 at w =
// 40). (Walking only the steps that meet [kmin, kmax], as the backward
// passes do, took 11 more registers and measured 1-4 % slower here except
// at T = 20.) S = Q K^T
// and O = P V run on mma.sync m16n8k16 with ldmatrix fragments
// (mma_bf16.cuh); S's C fragments, packed to bf16, are P V's A fragments, so
// P never leaves registers. The T5 bias is added by diagonal from shared
// memory, out-of-band and masked keys get -inf (weight exactly 0). The
// softmax is online over chunks of 32 keys, so registers do not grow with w.
// P is rounded to bf16 before P V where the TPU kernel rounds it:
//   - K1 and K5 (p.astype(v.dtype) of the unnormalised p, dawn_tpu/ops/
//     local_attention.py:339-346): one walk, exp(s - running max) rounded,
//     the f32 row sum dividing the output once;
//   - K3 (p / p.sum, then the cast, :149-152): the normalised p, so two
//     walks (kRoundP). Walk 1 computes S and the online row max m and sum l,
//     no P V; walk 2 recomputes S, rounds p = exp(s - m) / l to bf16 and
//     accumulates P V, with no division at the end. K and V stay in shared
//     memory, so walk 2 costs one more Q K^T a chunk and no bytes.
// Blocks are numbered tile-fastest, so the tiles of one (sequence, head),
// whose bands share 2w key rows, run side by side and meet those rows in L2.
// mma.sync and not wgmma: the kernel is bytes-bound with tensor throughput
// to spare, and wgmma's 64-row tiles would make a warpgroup cover a
// 64 + 2w = 144-key band where four 16-row warps need 96 keys each.
// Any w with (64 + 2 * staged_rows(w, 4)) * 80 B + (2w + 1) * 4 B <= 227 KB
// works: w <= 656 for K5 and for K3 past 657 frames, any w for K1. Rows that
// all fit in 32 (stage 1's T = 20) take blocks of 2 warps (tile_warps), so
// no warp idles and twice as many blocks fit an SM.
//
// C interface (bound with ctypes):
//   int dawn_local_attn_packed_fwd(q, k, v, bias, out, n, t, heads, dim_head,
//                                  window, is_bf16, stream)      K1, (N, T, H*D)
//   int dawn_local_attn_tiled_fwd(q, k, v, bias, out, n, t, heads, dim_head,
//                                 window, is_bf16, stream)       K3, (N, H, T, D)
//   int dawn_local_attn_stripe_fwd(q, k, v, bias, out, n, t_loc, heads,
//                                  dim_head, window, left_edge, right_edge,
//                                  is_bf16, stream)             K5, q (N, t_loc, H*D),
//                                                               k, v (N, t_loc + 2w, H*D)
// each returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a shape it was not built for;
//   int dawn_local_attn_max_window(kernel, t, is_bf16, with_bias_grad)
// returns the largest window that kernel 1, 3 or 5 takes at T = t (K5: t_loc)
// on the current device, INT_MAX for no limit, -1 for another kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "mma_bf16.cuh"
#include "smem_limit.cuh"

namespace {

constexpr int kQueryTile = 128;  // query rows per block of the CUDA-core body, one thread each

// The key rows a block reads: seq_k rows of which [kmin, kmax] are valid,
// query row i's band centred on key row i + key_off.
struct KeyRange {
  int seq_k, key_off, kmin, kmax;
};

// The CUDA-core body, f32. kPacked: the (N, T, H*D) layout, grid (N, H,
// tiles); else (N, H, T, D), grid (N*H, tiles).
template <int D, bool kPacked>
__global__ void __launch_bounds__(kQueryTile)
local_attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ bias,
                      float* __restrict__ out, int seq_q, KeyRange kr, int heads, int window) {
  extern __shared__ float smem[];
  // rows padded to D+1 floats: the threads of a warp read consecutive key
  // rows at the same column, and the padding puts them in distinct banks
  constexpr int kStride = D + 1;
  const int h = kPacked ? blockIdx.y : blockIdx.x % heads;
  const int q0 = (kPacked ? blockIdx.z : blockIdx.y) * kQueryTile;
  const int q1 = min(q0 + kQueryTile, seq_q);                   // exclusive
  const int k0 = max(q0 + kr.key_off - window, kr.kmin);
  const int k1 = min(q1 - 1 + kr.key_off + window, kr.kmax);   // inclusive
  const int rows = k1 - k0 + 1;
  const int nbias = 2 * window + 1;
  float* ks = smem;
  float* vs = ks + rows * kStride;
  float* bs = vs + rows * kStride;

  // element (row r, column d) of this (sequence, head) is at base + r*hd + d
  const int hd = kPacked ? heads * D : D;
  const size_t head_off = kPacked ? (size_t)h * D : 0;
  const size_t q_base = (size_t)blockIdx.x * seq_q * hd + head_off;
  const size_t k_base = (size_t)blockIdx.x * kr.seq_k * hd + head_off;
  for (int e = threadIdx.x; e < rows * D; e += blockDim.x) {
    const int r = e / D, d = e % D;
    const size_t g = k_base + (size_t)(k0 + r) * hd + d;
    ks[r * kStride + d] = k[g];
    vs[r * kStride + d] = v[g];
  }
  for (int e = threadIdx.x; e < nbias; e += blockDim.x)
    bs[e] = bias != nullptr ? bias[(size_t)h * nbias + e] : 0.f;
  __syncthreads();

  const int i = q0 + threadIdx.x;
  if (i >= q1) return;
  const size_t row = q_base + (size_t)i * hd;
  float qr[D];
#pragma unroll
  for (int d = 0; d < D; ++d) qr[d] = q[row + d];
  const int c = i + kr.key_off;    // the key row at offset 0
  const int j0 = max(c - window, kr.kmin), j1 = min(c + window, kr.kmax);
  auto score = [&](int j) {
    const float* krow = ks + (j - k0) * kStride;
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) s = fmaf(qr[d], krow[d], s);
    return s + bs[j - c + window];
  };
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  // pass 1: the row max of the in-band scores
  float m = -INFINITY;
  for (int j = j0; j <= j1; ++j) m = fmaxf(m, score(j));
  // pass 2: exp, row sum and p.v
  float l = 0.f;
  for (int j = j0; j <= j1; ++j) {
    const float p = expf(score(j) - m);
    const float* vrow = vs + (j - k0) * kStride;
    l += p;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] = fmaf(p, vrow[d], acc[d]);
  }
  const float inv = 1.f / l;
#pragma unroll
  for (int d = 0; d < D; ++d) out[row + d] = acc[d] * inv;
}

// Dynamic shared memory of a CUDA-core launch over seq_k key rows: the key
// and value rows one tile's band touches, as f32, and the bias row.
template <int D>
size_t fwd_smem(int seq_k, int window) {
  const size_t rows = min(seq_k, kQueryTile + 2 * window);
  return (2 * rows * (D + 1) + (2 * (size_t)window + 1)) * sizeof(float);
}

template <int D, bool kPacked>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias, void* out,
                   int n, int seq_q, KeyRange kr, int heads, int window,
                   cudaStream_t stream) {
  const size_t smem = fwd_smem<D>(kr.seq_k, window);
  auto kernel = local_attn_fwd_kernel<D, kPacked>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles = (seq_q + kQueryTile - 1) / kQueryTile;
  const dim3 grid = kPacked ? dim3(n, heads, tiles) : dim3(n * heads, tiles);
  kernel<<<grid, kQueryTile, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(bias), static_cast<float*>(out), seq_q, kr, heads, window);
  return cudaGetLastError();
}

using bf16 = __nv_bfloat16;
using dawn_mma::KeyBand;

// One walk (K1, K5), one chunk: the online max and sum, then P V with the
// unnormalised P rounded to bf16. m: the row max (the same in the 4 lanes
// of a row), l: this lane's share of the row sum.
template <int NT>
__device__ __forceinline__ void fwd_chunk(float (&o)[4][4], float (&m)[2], float (&l)[2],
                                          const uint32_t (&qa)[2][4], const KeyBand& b, int c0,
                                          int lane) {
  using namespace dawn_mma;
  float s[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) band_scores(s[j], qa, b, c0 + 8 * j, lane);
  float base[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < NT; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * hh], s[j][2 * hh + 1]));
    const float m_new = fmaxf(m[hh], quad_max(mx));
    base[hh] = exp_base(m_new);
    const float corr = exp2f((m[hh] - base[hh]) * kLog2e);
    m[hh] = m_new;
    l[hh] *= corr;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      o[n][2 * hh] *= corr;
      o[n][2 * hh + 1] *= corr;
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      s[j][r] = exp2f((s[j][r] - base[r >> 1]) * kLog2e);
      l[r >> 1] += s[j][r];
    }
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) {
    uint32_t pa[4];
    pack_a(pa, s[2 * i], s[2 * i + 1]);   // P rounded to bf16
    mma_rows(o, pa, b.vs, b.r0 + c0 + 16 * i, lane);
  }
}

// K3's walk 1, one chunk: the online row max m and sum l, no P V.
template <int NT>
__device__ __forceinline__ void max_sum_chunk(float (&m)[2], float (&l)[2],
                                              const uint32_t (&qa)[2][4], const KeyBand& b,
                                              int c0, int lane) {
  using namespace dawn_mma;
  float s[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) band_scores(s[j], qa, b, c0 + 8 * j, lane);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < NT; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * hh], s[j][2 * hh + 1]));
    const float m_new = fmaxf(m[hh], quad_max(mx)), base = exp_base(m_new);
    l[hh] *= exp2f((m[hh] - base) * kLog2e);
#pragma unroll
    for (int j = 0; j < NT; ++j)
      l[hh] += exp2f((s[j][2 * hh] - base) * kLog2e) + exp2f((s[j][2 * hh + 1] - base) * kLog2e);
    m[hh] = m_new;
  }
}

// K3's walk 2, one chunk: p = exp(s - m) / l (inv = 1 / l) rounded to bf16,
// then P V.
template <int NT>
__device__ __forceinline__ void norm_pv_chunk(float (&o)[4][4], const float (&base)[2],
                                              const float (&inv)[2], const uint32_t (&qa)[2][4],
                                              const KeyBand& b, int c0, int lane) {
  using namespace dawn_mma;
  float s[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) band_scores(s[j], qa, b, c0 + 8 * j, lane);
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) s[j][r] = exp2f((s[j][r] - base[r >> 1]) * kLog2e) * inv[r >> 1];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) {
    uint32_t pa[4];
    pack_a(pa, s[2 * i], s[2 * i + 1]);   // the normalised P rounded to bf16
    mma_rows(o, pa, b.vs, b.r0 + c0 + 16 * i, lane);
  }
}

// The tensor-core body, bf16: one block of kWarps warps per (sequence,
// head, 64-row query tile), numbered tile-fastest (kWarps = 2 when seq_q <=
// 32). kPacked: the (N, T, H*D) layout, else (N, H, T, D). kRoundP: K3's
// two walks, rounding the normalised P; else one walk rounding the
// unnormalised P. Head h's 2w+1 bias entries start at bias + h * bias_ld.
template <bool kPacked, int kWarps, bool kRoundP>
__global__ void __launch_bounds__(32 * kWarps)
attn_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const float* __restrict__ bias, int bias_ld,
                    bf16* __restrict__ out, int seq_q, KeyRange kr, int heads, int window,
                    int tiles) {
  using namespace dawn_mma;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int rows_q = 16 * kWarps;
  const int staged = staged_rows(window, kWarps), nbias = 2 * window + 1;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // rows_q x kLd
  bf16* ks = qs + rows_q * kLd;                    // staged x kLd
  bf16* vs = ks + staged * kLd;
  float* bs = reinterpret_cast<float*>(vs + staged * kLd);

  const int nh = blockIdx.x / tiles, tile = blockIdx.x % tiles, h = nh % heads;
  const int q0 = tile * 64, nq = min(64, seq_q - q0);
  const int kb = q0 + kr.key_off - window;          // the key row at shared row 0
  const size_t ld = row_stride<kDim, kPacked>(heads);
  const size_t q_base = head_base<kDim, kPacked>(nh, heads, seq_q);
  const size_t k_base = head_base<kDim, kPacked>(nh, heads, kr.seq_k);
  stage_rows(qs, q + q_base, ld, q0, rows_q, q0, q0 + nq - 1);
  const int k_lo = max(kb, kr.kmin), k_hi = min(q0 + nq - 1 + kr.key_off + window, kr.kmax);
  stage_rows(ks, k + k_base, ld, kb, staged, k_lo, k_hi);
  stage_rows(vs, v + k_base, ld, kb, staged, k_lo, k_hi);
  for (int e = threadIdx.x; e < nbias; e += blockDim.x)
    bs[e] = bias != nullptr ? bias[(size_t)h * bias_ld + e] : 0.f;
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (16 * warp >= nq) return;
  uint32_t qa[2][4];
  load_a(qa[0], qs, 16 * warp, 0, lane);
  load_a(qa[1], qs, 16 * warp, 16, lane);
  const int key_w = kb + 16 * warp;                 // band offset 0 of this warp
  const KeyBand b{ks, vs, bs, 16 * warp, key_w, kr.kmin, kr.kmax, nbias};
  const int nk = band_rows(window);

  // the whole band in chunks of 32 keys and a last one of 16 (nk is a
  // multiple of 16)
  float o[4][4] = {}, m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  int c0;
  if (kRoundP) {
    for (c0 = 0; c0 + 32 <= nk; c0 += 32) max_sum_chunk<4>(m, l, qa, b, c0, lane);
    if (c0 < nk) max_sum_chunk<2>(m, l, qa, b, c0, lane);
    float base[2], inv[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float lsum = quad_sum(l[hh]);
      base[hh] = exp_base(m[hh]);
      inv[hh] = lsum > 0.f ? 1.f / lsum : 0.f;    // 0: a padding row with no key
    }
    for (c0 = 0; c0 + 32 <= nk; c0 += 32) norm_pv_chunk<4>(o, base, inv, qa, b, c0, lane);
    if (c0 < nk) norm_pv_chunk<2>(o, base, inv, qa, b, c0, lane);
  } else {
    for (c0 = 0; c0 + 32 <= nk; c0 += 32) fwd_chunk<4>(o, m, l, qa, b, c0, lane);
    if (c0 < nk) fwd_chunk<2>(o, m, l, qa, b, c0, lane);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float inv = 1.f / quad_sum(l[hh]);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        o[n][2 * hh] *= inv;
        o[n][2 * hh + 1] *= inv;
      }
    }
  }
  store_rows(out + q_base, ld, q0 + 16 * warp, nq - 16 * warp, o, qs + 16 * warp * kLd, lane);
}

// Dynamic shared memory of a tensor-core launch of `warps` warps: the query
// tile, the band's key and value rows in bf16, and the bias row.
size_t mma_smem(int window, int warps) {
  return (16 * warps + 2 * (size_t)dawn_mma::staged_rows(window, warps)) * dawn_mma::kLd *
             sizeof(bf16) +
         (2 * (size_t)window + 1) * sizeof(float);
}

template <bool kPacked, bool kRoundP>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const float* bias,
                       int bias_ld, void* out, int n, int seq_q, KeyRange kr, int heads,
                       int window, cudaStream_t stream) {
  const int warps = dawn_mma::tile_warps(seq_q);
  const size_t smem = mma_smem(window, warps);
  auto kernel = warps == 2 ? attn_fwd_mma_kernel<kPacked, 2, kRoundP>
                           : attn_fwd_mma_kernel<kPacked, 4, kRoundP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles = (seq_q + 63) / 64;
  const long long blocks = (long long)n * heads * tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, 32 * warps, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      bias, bias_ld, static_cast<bf16*>(out), seq_q, kr, heads, window, tiles);
  return cudaGetLastError();
}

// K1 and K3 in bf16: the band clamped to w_eff = min(w, T - 1) (the same
// keys), reading the bias entries [w - w_eff, w + w_eff] of each head's row.
template <bool kPacked, bool kRoundP>
cudaError_t launch_clamped(const void* q, const void* k, const void* v, const void* bias,
                           void* out, int n, int t, int heads, int window,
                           cudaStream_t stream) {
  const int w_eff = min(window, t - 1);
  const float* b = bias != nullptr ? static_cast<const float*>(bias) + (window - w_eff) : nullptr;
  return launch_mma<kPacked, kRoundP>(q, k, v, b, 2 * window + 1, out, n, t,
                                      KeyRange{t, 0, 0, t - 1}, heads, w_eff, stream);
}

}  // namespace

extern "C" int dawn_local_attn_packed_fwd(const void* q, const void* k, const void* v,
                                          const void* bias, void* out, int n, int t,
                                          int heads, int dim_head, int window,
                                          int is_bf16, void* stream) {
  if (dim_head != 32 || window < 0 || t < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16)
    return (int)launch<32, true>(q, k, v, bias, out, n, t, KeyRange{t, 0, 0, t - 1}, heads,
                                 window, s);
  return (int)launch_clamped<true, false>(q, k, v, bias, out, n, t, heads, window, s);
}

extern "C" int dawn_local_attn_tiled_fwd(const void* q, const void* k, const void* v,
                                         const void* bias, void* out, int n, int t,
                                         int heads, int dim_head, int window,
                                         int is_bf16, void* stream) {
  if (dim_head != 32 || window < 0 || t < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16)
    return (int)launch<32, false>(q, k, v, bias, out, n, t, KeyRange{t, 0, 0, t - 1}, heads,
                                  window, s);
  return (int)launch_clamped<false, true>(q, k, v, bias, out, n, t, heads, window, s);
}

extern "C" int dawn_local_attn_stripe_fwd(const void* q, const void* k, const void* v,
                                          const void* bias, void* out, int n, int t_loc,
                                          int heads, int dim_head, int window,
                                          int left_edge, int right_edge, int is_bf16,
                                          void* stream) {
  if (dim_head != 32 || window < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int seq_k = t_loc + 2 * window;
  const KeyRange kr{seq_k, window, left_edge ? window : 0,
                    right_edge ? window + t_loc - 1 : seq_k - 1};
  if (!is_bf16)
    return (int)launch<32, true>(q, k, v, bias, out, n, t_loc, kr, heads, window, s);
  return (int)launch_mma<true, false>(q, k, v, static_cast<const float*>(bias),
                                      2 * window + 1, out, n, t_loc, kr, heads, window, s);
}

extern "C" int dawn_local_attn_max_window(int kernel, int t, int is_bf16, int with_bias_grad) {
  (void)with_bias_grad;   // a forward computes no bias gradient
  using dawn_limits::max_window;
  if (t < 1) return -1;
  switch (kernel) {
    case 1:
    case 3:   // bf16: the band clamped to T - 1
      return is_bf16 ? max_window([t](int w) {
                         return mma_smem(min(w, t - 1), dawn_mma::tile_warps(t));
                       })
                     : max_window([t](int w) { return fwd_smem<32>(t, w); });
    case 5:
      return is_bf16 ? max_window([t](int w) { return mma_smem(w, dawn_mma::tile_warps(t)); })
                     : max_window([t](int w) { return fwd_smem<32>(t + 2 * w, w); });
    default:
      return -1;
  }
}
