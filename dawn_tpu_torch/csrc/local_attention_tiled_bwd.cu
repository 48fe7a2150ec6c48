// K2, K4 and K6: windowed temporal attention, backward, tiled.
//
// K4 replaces dawn_tpu/ops/local_attention.py::_local_attn_tile_bwd_kernel
// (the Pallas TPU body launched by _tiled_bwd_pallas, the VJP of
// _local_attention_tpu), the backward of K3, on the (N, H, T, D) layout, any
// T. K2 replaces _local_attn_packed_bwd_kernel (launched by
// _packed_bwd_pallas, the VJP of local_attention_packed_tpu), the backward
// of K1: the same function on the packed (N, T, H*D) layout, T <= 256. K6
// replaces the stripe backward (_stripe_bwd_pallas, K2's Pallas body on the
// rectangular block of local_attention_packed_stripe, the VJP of
// local_attention_packed_stripe_tpu), the backward of K5, on the packed
// layout: the t_loc queries of one rank against its t_loc + 2w haloed keys.
// With p the softmax rows of the forward,
//     p[i, j] = softmax_j(q_i . k_j + bias[h, j - i + w]) over the band,
// and g the gradient of the output, all three compute for every (sequence,
// head)
//     dv_j = sum_i p_ij g_i
//     ds_ij = p_ij (g_i . v_j - delta_i),  delta_i = sum_j p_ij (g_i . v_j)
//     dq_i = sum_j ds_ij k_j,   dk_j = sum_i ds_ij q_i
// and the gradient of the (H, 2w+1) bias vector, dbias[h, r] = the sum over
// sequences and queries of ds[i, i + r - w]. Keys outside the band or
// outside the valid key rows have p = 0 and so ds = 0; they are not visited.
//
// One key range covers all three, as in the forward bodies
// (local_attention.cu): query row i sees the key rows j in [i + key_off - w,
// i + key_off + w] cut to [kmin, kmax], with the bias entry j - key_off - i
// + w. K2, K4: key_off 0, keys [0, T). K6: key_off w, keys [w or 0, w +
// t_loc - 1 or t_loc + 2w - 1] by the global-edge flags of K5; the masked
// key rows get dk = dv = 0. The TPU's K6 returns the raw (H, tq, tk) dS tile
// and leaves its reduction to the autodiff of the bias construction; the
// edge masks are constants and masked keys have p = 0, so reducing dS to
// diagonals here gives the same T5-vector gradient. K2 clamps the band to
// the keys that exist, as bf16 K1 does: with w_eff = min(w, T - 1) it walks
// the same keys and reads the bias entries [w - w_eff, w + w_eff] of each
// head's row (bias_ld = 2w + 1 apart), and its bias partials have 2 w_eff +
// 1 columns, the caller placing their sum in the middle of the (H, 2w+1)
// gradient (the entries past T - 1 get none). So K2 takes every w at T <=
// 256. The layouts differ only in where row r of a (sequence, head) sits
// (dawn_mma::head_base).
//
// What bounds it on an H100: memory. K4 at the top UNet level of a 128^2
// 400-frame video (N*H = 1024*8 sequence-heads, T = 400, D = 32, w = 40,
// bf16) reads q, k, v, g and writes dq, dk, dv: 7 x 210 MB = 1.47 GB, about
// 0.44 ms at the H100 SXM's 3.35 TB/s; the five products over the band's
// 30,760 (query, key) pairs a sequence-head come to 81 GFLOP, 0.08 ms at the
// 989 TFLOP/s bf16 peak. K2 at the stage-1 top level (N = 4096, T = 20, 8 x
// 32, w = 20): 7 x 41.9 MB = 294 MB, 0.088 ms; 4.2 GFLOP. K6 at the stage-2
// stripe (N = 1024, t_loc = 20, 60 keys, w = 20, bf16, left edge) moves q,
// g, dq (10.5 MB each), the k, v rows the edge leaves and dk, dv over every
// haloed row: 136 MB, 0.041 ms.
// What the design does about it: no sequence is held whole in shared memory
// (the TPU K2's design, which caps a sequence or stripe at 256 keys). The
// rows are tiled instead, in two launches on the caller's stream, kTile = 64
// rows a block:
//   A. query tiles: a block stages the key/value rows its queries' bands
//      touch. It finds each row's log-sum-exp and delta_i (online
//      rescaling), then walks the band again for dS and dq_i. It writes dq,
//      the two row statistics (lse, delta) to a (2, N*H, TQ) f32 scratch,
//      and its f32 dS rows into shared memory, whose columns the block sums
//      in query order into one (2w+1) bias partial per (sequence, head,
//      tile).
//   B. key tiles: a block stages the query and gradient rows whose bands
//      touch its keys, with their row statistics from A, and recomputes p =
//      exp(s - lse) and ds to sum dk_j and dv_j. One block owns each key
//      row, so no atomics: the gradients of a key row that several query
//      tiles see are summed in one place.
// The caller sums the bias partials over sequences and tiles in a fixed
// order, so the result does not change from run to run. The TPU kernel's
// per-tile left/center/right dk/dv buffers and shifted adds are not needed.
//
// f32 runs on the CUDA cores: one thread a row, the band walked twice in A
// and once in B, one shared load per FMA. bf16 runs on the tensor cores, the
// same two passes with 4 warps of 16 rows a block (2 when all of a pass's
// rows fit in 32, as stage 1's 20 frames do): q, g (A) or k, v (B) tiles and
// the band's rows staged in bf16 with 16-byte cp.async, zeros outside the
// valid rows; every product on mma.sync m16n8k16 with ldmatrix fragments
// (mma_bf16.cuh). A warp walks only the k16 steps of its band that meet the
// valid rows (valid_steps), and a block stages only the rows those steps
// read (staged_span): at most the valid rows plus 15 a side, so a T <= 256
// sequence stages no more than 286 rows whatever w, and K2 at w_eff = 255
// fits shared memory with its (64, 511) f32 dS rows. A: S = Q K^T and dP =
// dO V^T over the band in chunks of 32 keys with an online max, sum and sum
// of p dp (so registers do not grow with w); then again for P = exp(S -
// lse), dS = P (dP - delta), dQ = dS K, with dS rounded to bf16 for the
// product (JAX's dsk) and the f32 dS written to the bias rows (JAX sums the
// f32 ds; the diagonals of skipped steps are written as zeros). B: S^T = K
// Q^T, P^T = exp(S^T + bias - lse), dV = P^T dO with P rounded to bf16
// (JAX's pk), dP^T = V dO^T, dS^T = P^T (dP^T - delta), dK = dS^T Q with dS
// rounded to bf16. The C fragments of one product, packed to bf16, are the
// A fragments of the next, so P and dS never leave registers. Blocks are
// numbered tile-fastest, so the tiles of one (sequence, head), whose bands
// share 2w rows, run side by side and meet those rows in L2. The C entries
// dispatch on is_bf16; each kernel is built for both layouts (kPacked).
//
// C interface (bound with ctypes):
//   int dawn_local_attn_packed_bwd(q, k, v, g, bias, dq, dk, dv, dbias_partial,
//                                  stats, n, t, heads, dim_head, window, is_bf16,
//                                  stream)                    K2, (N, T, H*D)
//   int dawn_local_attn_tiled_bwd(q, k, v, g, bias, dq, dk, dv, dbias_partial,
//                                 stats, n, t, heads, dim_head, window, is_bf16,
//                                 stream)                     K4, (N, H, T, D)
//   int dawn_local_attn_stripe_bwd(q, k, v, g, bias, dq, dk, dv, dbias_partial,
//                                  stats, n, t_loc, heads, dim_head, window,
//                                  left_edge, right_edge, is_bf16, stream)  K6,
//        q, g, dq (N, t_loc, H*D); k, v, dk, dv (N, t_loc + 2w, H*D)
// bias may be null (no bias: zeros) and dbias_partial may be null (no bias
// gradient wanted); otherwise dbias_partial is (N*H, ceil(TQ/kTile), 2b+1)
// f32, TQ the query rows (T or t_loc), b the band (K2: min(w, T - 1), else
// w), with kTile as dawn_local_attn_tiled_bwd_tile() returns it. stats is
// (2, N*H, TQ) f32 scratch. Each returns cudaGetLastError() after the
// launches (0 on success), or cudaErrorInvalidValue for a shape it was not
// built for.
//   int dawn_local_attn_max_window(kernel, t, is_bf16, with_bias_grad)
// returns the largest window kernel 2, 4 (T = t) or 6 (t_loc = t) takes on
// the current device, INT_MAX for none, -1 for another kernel: with a bias
// partial, bf16 K4 takes (128 + 2 * staged_rows(w, 4, T)) * 80 B + 65 *
// (2w + 1) * 4 B <= 227 KB (w <= 249 at long T), f32 w <= 205; K2 has no
// limit at T <= 256 in either dtype.

#include <algorithm>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "mma_bf16.cuh"
#include "smem_limit.cuh"

namespace {

constexpr int kTile = 64;  // rows per block in both passes (f32: one thread a row)

// The key rows a (sequence, head) has: seq_k rows of which [kmin, kmax] are
// valid, query row i's band centred on key row i + key_off.
struct KeyRange {
  int seq_k, key_off, kmin, kmax;
};

using dawn_mma::head_base;
using dawn_mma::KeyBand;
using dawn_mma::row_stride;

template <int D>
__device__ __forceinline__ float dot(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) s = fmaf(a[d], b[d], s);
  return s;
}

// Rows [r0, r0 + rows) of one (sequence, head), row i at src + i * ld, into
// shared memory padded to D+1 floats: the threads of a warp read different
// rows at the same column, and the padding puts them in distinct banks.
template <int D>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, size_t ld,
                                      int r0, int rows) {
  for (int e = threadIdx.x; e < rows * D; e += blockDim.x)
    dst[(e / D) * (D + 1) + e % D] = src[(size_t)(r0 + e / D) * ld + e % D];
}

// Pass A in f32: one block per (sequence-head, query tile).
template <int D, bool kPacked>
__global__ void __launch_bounds__(kTile)
tiled_bwd_query_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ g,
                       const float* __restrict__ bias, int bias_ld, float* __restrict__ dq,
                       float* __restrict__ dbias_partial, float* __restrict__ stats,
                       int seq_q, KeyRange kr, int heads, int window) {
  extern __shared__ float smem[];
  constexpr int kStride = D + 1;
  const int nbias = 2 * window + 1;
  const int nh = blockIdx.x, h = nh % heads;
  const int q0 = blockIdx.y * kTile, q1 = min(q0 + kTile, seq_q);  // q1 exclusive
  const int k0 = max(q0 + kr.key_off - window, kr.kmin);
  const int k1 = min(q1 - 1 + kr.key_off + window, kr.kmax);
  const int rows = k1 - k0 + 1;
  float* ks = smem;
  float* vs = ks + rows * kStride;
  float* bs = vs + rows * kStride;
  float* ds_rows = bs + nbias;  // (kTile, 2w+1) when a bias partial is wanted

  const size_t ld = row_stride<D, kPacked>(heads);
  const size_t q_base = head_base<D, kPacked>(nh, heads, seq_q);
  const size_t k_base = head_base<D, kPacked>(nh, heads, kr.seq_k);
  stage<D>(ks, k + k_base, ld, k0, rows);
  stage<D>(vs, v + k_base, ld, k0, rows);
  for (int e = threadIdx.x; e < nbias; e += blockDim.x)
    bs[e] = bias != nullptr ? bias[(size_t)h * bias_ld + e] : 0.f;
  __syncthreads();

  const int i = q0 + threadIdx.x;
  if (i < q1) {
    const size_t row = q_base + (size_t)i * ld;
    float qi[D], gi[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      qi[d] = q[row + d];
      gi[d] = g[row + d];
    }
    const int c = i + kr.key_off;    // the key row at offset 0: bias entry j - c + w
    const int j0 = max(c - window, kr.kmin), j1 = min(c + window, kr.kmax);
    // walk 1: row max m, row sum l and sum_j p_ij (g_i . v_j), rescaled
    // whenever the max grows
    float m = -INFINITY, l = 0.f, pdp = 0.f;
    for (int j = j0; j <= j1; ++j) {
      const float s = dot<D>(qi, ks + (j - k0) * kStride) + bs[j - c + window];
      const float dp = dot<D>(gi, vs + (j - k0) * kStride);
      const float m_new = fmaxf(m, s);
      const float corr = expf(m - m_new), p = expf(s - m_new);
      l = fmaf(l, corr, p);
      pdp = fmaf(pdp, corr, p * dp);
      m = m_new;
    }
    const float delta = pdp / l, lse = m + logf(l);
    // walk 2: dS and dq
    float* ds_row = dbias_partial != nullptr ? ds_rows + threadIdx.x * nbias : nullptr;
    if (ds_row != nullptr)
      for (int r = 0; r < nbias; ++r) ds_row[r] = 0.f;
    float acc[D];
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] = 0.f;
    for (int j = j0; j <= j1; ++j) {
      const float* kj = ks + (j - k0) * kStride;
      const float s = dot<D>(qi, kj) + bs[j - c + window];
      const float p = expf(s - lse);
      const float ds = p * (dot<D>(gi, vs + (j - k0) * kStride) - delta);
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(ds, kj[d], acc[d]);
      if (ds_row != nullptr) ds_row[j - c + window] = ds;
    }
#pragma unroll
    for (int d = 0; d < D; ++d) dq[row + d] = acc[d];
    const size_t plane = (size_t)gridDim.x * seq_q, at = (size_t)nh * seq_q + i;
    stats[at] = lse;
    stats[plane + at] = delta;
  }

  if (dbias_partial == nullptr) return;
  __syncthreads();
  // this tile's share of the bias gradient: column sums of the dS rows, in
  // query order
  const int nq = q1 - q0;
  for (int r = threadIdx.x; r < nbias; r += blockDim.x) {
    float acc = 0.f;
    for (int a = 0; a < nq; ++a) acc += ds_rows[a * nbias + r];
    dbias_partial[((size_t)nh * gridDim.y + blockIdx.y) * nbias + r] = acc;
  }
}

// Pass B in f32: one block per (sequence-head, key tile), after pass A.
template <int D, bool kPacked>
__global__ void __launch_bounds__(kTile)
tiled_bwd_key_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ g,
                     const float* __restrict__ bias, int bias_ld,
                     const float* __restrict__ stats, float* __restrict__ dk,
                     float* __restrict__ dv, int seq_q, KeyRange kr, int heads, int window) {
  extern __shared__ float smem[];
  constexpr int kStride = D + 1;
  const int nbias = 2 * window + 1;
  const int nh = blockIdx.x, h = nh % heads;
  const int k0 = blockIdx.y * kTile, k1 = min(k0 + kTile, kr.seq_k);  // k1 exclusive
  const int i0 = max(k0 - kr.key_off - window, 0);
  const int i1 = min(k1 - 1 - kr.key_off + window, seq_q - 1);
  const int rows = i1 - i0 + 1;
  float* qs = smem;
  float* gs = qs + rows * kStride;
  float* row_lse = gs + rows * kStride;
  float* row_delta = row_lse + rows;
  float* bs = row_delta + rows;

  const size_t ld = row_stride<D, kPacked>(heads);
  const size_t q_base = head_base<D, kPacked>(nh, heads, seq_q);
  const size_t k_base = head_base<D, kPacked>(nh, heads, kr.seq_k);
  stage<D>(qs, q + q_base, ld, i0, rows);
  stage<D>(gs, g + q_base, ld, i0, rows);
  const size_t plane = (size_t)gridDim.x * seq_q, at = (size_t)nh * seq_q + i0;
  for (int e = threadIdx.x; e < rows; e += blockDim.x) {
    row_lse[e] = stats[at + e];
    row_delta[e] = stats[plane + at + e];
  }
  for (int e = threadIdx.x; e < nbias; e += blockDim.x)
    bs[e] = bias != nullptr ? bias[(size_t)h * bias_ld + e] : 0.f;
  __syncthreads();

  const int j = k0 + threadIdx.x;
  if (j >= k1) return;
  const size_t row = k_base + (size_t)j * ld;
  float kj[D], vj[D], dk_acc[D], dv_acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    kj[d] = k[row + d];
    vj[d] = v[row + d];
    dk_acc[d] = dv_acc[d] = 0.f;
  }
  // the queries whose band holds key row j (none for a masked row)
  const bool valid = j >= kr.kmin && j <= kr.kmax;
  const int ia = valid ? max(j - kr.key_off - window, 0) : 0;
  const int ib = valid ? min(j - kr.key_off + window, seq_q - 1) : -1;
  for (int i = ia; i <= ib; ++i) {
    const int r = i - i0;
    const float* qi = qs + r * kStride;
    const float* gi = gs + r * kStride;
    const float s = dot<D>(qi, kj) + bs[j - kr.key_off - i + window];
    const float p = expf(s - row_lse[r]);
    const float ds = p * (dot<D>(gi, vj) - row_delta[r]);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      dk_acc[d] = fmaf(ds, qi[d], dk_acc[d]);
      dv_acc[d] = fmaf(p, gi[d], dv_acc[d]);
    }
  }
#pragma unroll
  for (int d = 0; d < D; ++d) {
    dk[row + d] = dk_acc[d];
    dv[row + d] = dv_acc[d];
  }
}

// Dynamic shared memory of the f32 passes: A stages the key/value rows of a
// query tile's bands (at most seq_k), B the query/gradient rows and their
// statistics of a key tile's (at most seq_q).
template <int D>
size_t f32_smem_a(int seq_k, int window, bool bias_grad) {
  const size_t rows = min(seq_k, kTile + 2 * window), nbias = 2 * (size_t)window + 1;
  return (2 * rows * (D + 1) + nbias + (bias_grad ? kTile * nbias : 0)) * sizeof(float);
}
template <int D>
size_t f32_smem_b(int seq_q, int window) {
  const size_t rows = min(seq_q, kTile + 2 * window), nbias = 2 * (size_t)window + 1;
  return (2 * rows * (D + 1) + 2 * rows + nbias) * sizeof(float);
}

template <int D, bool kPacked>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const void* g,
                       const float* bias, int bias_ld, void* dq, void* dk, void* dv,
                       void* dbias_partial, void* stats, int n, int seq_q, KeyRange kr,
                       int heads, int window, cudaStream_t stream) {
  const size_t smem_a = f32_smem_a<D>(kr.seq_k, window, dbias_partial != nullptr);
  const size_t smem_b = f32_smem_b<D>(seq_q, window);
  auto kernel_a = tiled_bwd_query_kernel<D, kPacked>;
  auto kernel_b = tiled_bwd_key_kernel<D, kPacked>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel_a, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_a);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel_b, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_b);
  if (err != cudaSuccess) return err;
  const dim3 grid_a(n * heads, (seq_q + kTile - 1) / kTile);
  const dim3 grid_b(n * heads, (kr.seq_k + kTile - 1) / kTile);
  kernel_a<<<grid_a, kTile, smem_a, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(g), bias, bias_ld,
      static_cast<float*>(dq), static_cast<float*>(dbias_partial), static_cast<float*>(stats),
      seq_q, kr, heads, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kernel_b<<<grid_b, kTile, smem_b, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(g), bias, bias_ld,
      static_cast<const float*>(stats), static_cast<float*>(dk), static_cast<float*>(dv), seq_q,
      kr, heads, window);
  return cudaGetLastError();
}

using bf16 = __nv_bfloat16;

// The k16 steps [lo, end) of a warp's band [0, nk) (nk a multiple of 16)
// that meet the valid rows, band offsets [first, last] (either may lie
// outside the band): every other step holds only rows of weight exactly 0,
// so a walk skips it. lo >= end when no step does.
struct Steps {
  int lo, end;
};
__device__ __forceinline__ Steps valid_steps(int nk, int first, int last) {
  first = max(first, 0);
  last = min(last, nk - 1);
  return first > last ? Steps{0, 0} : Steps{first & ~15, (last + 16) & ~15};
}

// The rows a block that walks only valid_steps stages: its warps' bands,
// [b0, b0 + staged_rows(window, warps)), cut to the valid rows [lo, hi]
// widened by the 15 rows a side that a k16 step can reach past them.
struct Span {
  int first, count;
};
__device__ __forceinline__ Span staged_span(int b0, int window, int warps, int lo, int hi) {
  const int first = max(b0, lo - 15);
  return {first, max(0, min(b0 + dawn_mma::staged_rows(window, warps), hi + 16) - first)};
}
// ... at most this many when the valid rows number `valid`: a sequence of
// T <= 256 rows needs no more than T + 30, whatever the window
__host__ __device__ constexpr int staged_rows(int window, int warps, int valid) {
  using dawn_mma::staged_rows;
  return staged_rows(window, warps) < valid + 30 ? staged_rows(window, warps) : valid + 30;
}

// The masked scores (band_scores) and dP = g . v of one chunk of NT n8 key
// tiles at band offset c0 of a warp in pass A.
template <int NT>
__device__ __forceinline__ void scores_and_dp(float (&s)[NT][4], float (&dp)[NT][4],
                                              const uint32_t (&qa)[2][4],
                                              const uint32_t (&ga)[2][4], const KeyBand& b,
                                              int c0, int lane) {
  using namespace dawn_mma;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    band_scores(s[j], qa, b, c0 + 8 * j, lane);
    mma_dot(dp[j], ga, b.vs, b.r0 + c0 + 8 * j, lane);
  }
}

// Pass A, walk 1 over one chunk: the online row max m, row sum l and
// sum_j p_ij dp_ij (this lane's share of l and of that sum).
template <int NT>
__device__ __forceinline__ void stats_chunk(float (&m)[2], float (&l)[2], float (&pdp)[2],
                                            const uint32_t (&qa)[2][4],
                                            const uint32_t (&ga)[2][4], const KeyBand& b,
                                            int c0, int lane) {
  using namespace dawn_mma;
  float s[NT][4], dp[NT][4];
  scores_and_dp<NT>(s, dp, qa, ga, b, c0, lane);
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
    pdp[hh] *= corr;
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float p = exp2f((s[j][r] - base[r >> 1]) * kLog2e);
      l[r >> 1] += p;
      pdp[r >> 1] = fmaf(p, dp[j][r], pdp[r >> 1]);
    }
}

// Pass A, walk 2 over one chunk: p = exp(s - lse), ds = p (dp - delta),
// dq += ds k with ds rounded to bf16; the f32 ds into the warp's rows of the
// bias-gradient tile ds_rows (row-major, 2w+1 wide) when it is not null.
template <int NT>
__device__ __forceinline__ void dq_chunk(float (&dq)[4][4], const float (&lse)[2],
                                         const float (&delta)[2], float* ds_rows,
                                         const uint32_t (&qa)[2][4],
                                         const uint32_t (&ga)[2][4], const KeyBand& b, int c0,
                                         int lane) {
  using namespace dawn_mma;
  const int g = lane >> 2, tq = lane & 3;
  float s[NT][4], dp[NT][4];
  scores_and_dp<NT>(s, dp, qa, ga, b, c0, lane);
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int hh = r >> 1;
      const float p = exp2f((s[j][r] - lse[hh]) * kLog2e);
      s[j][r] = p * (dp[j][r] - delta[hh]);
      const int idx = c0 + 8 * j + 2 * tq + (r & 1) - g - 8 * hh;
      if (ds_rows != nullptr && idx >= 0 && idx < b.nbias)
        ds_rows[(g + 8 * hh) * b.nbias + idx] = s[j][r];
    }
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) {
    uint32_t da[4];
    pack_a(da, s[2 * i], s[2 * i + 1]);
    mma_rows(dq, da, b.ks, b.r0 + c0 + 16 * i, lane);
  }
}

// Pass A on tensor cores (bf16): one block per (sequence-head, 64-row query
// tile), numbered tile-fastest, kWarps warps of 16 query rows (2 when
// seq_q <= 32). The block stages its warps' bands cut to the valid keys
// (staged_span), and each warp walks only the k16 steps of its band that
// meet them (valid_steps).
template <bool kPacked, int kWarps>
__global__ void __launch_bounds__(32 * kWarps)
bwd_query_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ g,
                     const float* __restrict__ bias, int bias_ld, bf16* __restrict__ dq,
                     float* __restrict__ dbias_partial, float* __restrict__ stats,
                     int seq_q, KeyRange kr, int heads, int window, int tiles) {
  using namespace dawn_mma;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int rows_q = 16 * kWarps;
  const int nbias = 2 * window + 1, cap = staged_rows(window, kWarps, kr.seq_k);
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // rows_q x kLd
  bf16* gs = qs + rows_q * kLd;                    // rows_q x kLd
  bf16* ks = gs + rows_q * kLd;                    // cap x kLd
  bf16* vs = ks + cap * kLd;
  float* bs = reinterpret_cast<float*>(vs + cap * kLd);
  float* ds_rows = bs + nbias;   // (rows_q, 2w+1) when a bias partial is wanted

  const int nh = blockIdx.x / tiles, tile = blockIdx.x % tiles, h = nh % heads;
  const int q0 = tile * kTile, nq = min(kTile, seq_q - q0);
  const int kb = q0 + kr.key_off - window;        // band offset 0 of warp 0
  const Span sp = staged_span(kb, window, kWarps, kr.kmin, kr.kmax);
  const size_t ld = row_stride<kDim, kPacked>(heads);
  const size_t q_base = head_base<kDim, kPacked>(nh, heads, seq_q);
  const size_t k_base = head_base<kDim, kPacked>(nh, heads, kr.seq_k);
  stage_rows(qs, q + q_base, ld, q0, rows_q, q0, q0 + nq - 1);
  stage_rows(gs, g + q_base, ld, q0, rows_q, q0, q0 + nq - 1);
  const int k_lo = max(kb, kr.kmin), k_hi = min(q0 + nq - 1 + kr.key_off + window, kr.kmax);
  stage_rows(ks, k + k_base, ld, sp.first, sp.count, k_lo, k_hi);
  stage_rows(vs, v + k_base, ld, sp.first, sp.count, k_lo, k_hi);
  for (int e = threadIdx.x; e < nbias; e += blockDim.x)
    bs[e] = bias != nullptr ? bias[(size_t)h * bias_ld + e] : 0.f;
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (16 * warp < nq) {
    uint32_t qa[2][4], ga[2][4];
    load_a(qa[0], qs, 16 * warp, 0, lane);
    load_a(qa[1], qs, 16 * warp, 16, lane);
    load_a(ga[0], gs, 16 * warp, 0, lane);
    load_a(ga[1], gs, 16 * warp, 16, lane);
    const int key_w = kb + 16 * warp, nk = band_rows(window);
    const KeyBand b{ks, vs, bs, key_w - sp.first, key_w, kr.kmin, kr.kmax, nbias};
    const Steps st = valid_steps(nk, kr.kmin - key_w, kr.kmax - key_w);

    // the steps [st.lo, st.end) in chunks of 32 keys and a last one of 16
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, pdp[2] = {0.f, 0.f};
    int c0;
    for (c0 = st.lo; c0 + 32 <= st.end; c0 += 32) stats_chunk<4>(m, l, pdp, qa, ga, b, c0, lane);
    if (c0 < st.end) stats_chunk<2>(m, l, pdp, qa, ga, b, c0, lane);
    float lse[2], delta[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float lsum = quad_sum(l[hh]), psum = quad_sum(pdp[hh]);
      // a padding row with no key in range: p = 0 everywhere
      lse[hh] = lsum > 0.f ? m[hh] + logf(lsum) : INFINITY;
      delta[hh] = lsum > 0.f ? psum / lsum : 0.f;
    }

    float acc[4][4] = {};
    float* ds_warp = dbias_partial != nullptr ? ds_rows + 16 * warp * nbias : nullptr;
    for (c0 = st.lo; c0 + 32 <= st.end; c0 += 32)
      dq_chunk<4>(acc, lse, delta, ds_warp, qa, ga, b, c0, lane);
    if (c0 < st.end) dq_chunk<2>(acc, lse, delta, ds_warp, qa, ga, b, c0, lane);
    if (ds_warp != nullptr) {
      // the diagonals the walk skipped, band offsets [0, st.lo) and
      // [st.end, nk): keys of weight 0, so ds = 0
      const int n_skip = st.lo + nk - st.end;
      for (int e = lane; e < 16 * n_skip; e += 32) {
        const int r = e & 15, i = e >> 4, off = i < st.lo ? i : st.end + i - st.lo;
        if (off - r >= 0 && off - r < nbias) ds_warp[r * nbias + off - r] = 0.f;
      }
    }
    store_rows(dq + q_base, ld, q0 + 16 * warp, nq - 16 * warp, acc, qs + 16 * warp * kLd,
               lane);
    if ((lane & 3) == 0) {
      const size_t plane = (size_t)gridDim.x / tiles * seq_q;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = 16 * warp + (lane >> 2) + 8 * hh;
        if (r < nq) {
          stats[(size_t)nh * seq_q + q0 + r] = lse[hh];
          stats[plane + (size_t)nh * seq_q + q0 + r] = delta[hh];
        }
      }
    }
  }

  if (dbias_partial == nullptr) return;
  __syncthreads();
  // this tile's share of the bias gradient: column sums of the dS rows, in
  // query order
  for (int r = threadIdx.x; r < nbias; r += blockDim.x) {
    float acc = 0.f;
    for (int a = 0; a < nq; ++a) acc += ds_rows[a * nbias + r];
    dbias_partial[((size_t)nh * tiles + tile) * nbias + r] = acc;
  }
}

// Where a warp of pass B reads: the shared query and gradient rows and
// their statistics (band offset 0 at shared row r0, as in KeyBand), and the
// bias row.
struct QueryBand {
  const bf16 *qs, *gs;
  const float *lse, *delta, *bs;
  int r0;
};

// Pass B on tensor cores, one chunk of NT n8 query tiles at band offset c0
// of a warp's 16 key rows (key_ok: whether this lane's key rows g and g + 8
// are valid): p^T = exp(k . q + bias - lse), ds^T = p^T (v . g - delta),
// dv += p^T g and dk += ds^T q with p and ds rounded to bf16.
template <int NT>
__device__ __forceinline__ void dkv_chunk(float (&dk)[4][4], float (&dv)[4][4],
                                          const uint32_t (&ka)[2][4],
                                          const uint32_t (&va)[2][4], const QueryBand& b,
                                          const bool (&key_ok)[2], int c0, int window,
                                          int lane) {
  using namespace dawn_mma;
  const int g = lane >> 2, tq = lane & 3, nbias = 2 * window + 1;
  float p[NT][4], ds[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    mma_dot(p[j], ka, b.qs, b.r0 + c0 + 8 * j, lane);
    mma_dot(ds[j], va, b.gs, b.r0 + c0 + 8 * j, lane);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      // key row g + 8 (r / 2), query at band offset off: bias entry
      // key - query + w
      const int off = c0 + 8 * j + 2 * tq + (r & 1), idx = g + 8 * (r >> 1) - off + 2 * window;
      const bool ok = key_ok[r >> 1] && idx >= 0 && idx < nbias;
      const float pr =
          ok ? exp2f((p[j][r] + b.bs[ok ? idx : 0] - b.lse[b.r0 + off]) * kLog2e) : 0.f;
      ds[j][r] = pr * (ds[j][r] - b.delta[b.r0 + off]);
      p[j][r] = pr;
    }
  }
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) {
    uint32_t pa[4], da[4];
    pack_a(pa, p[2 * i], p[2 * i + 1]);
    pack_a(da, ds[2 * i], ds[2 * i + 1]);
    mma_rows(dv, pa, b.gs, b.r0 + c0 + 16 * i, lane);
    mma_rows(dk, da, b.qs, b.r0 + c0 + 16 * i, lane);
  }
}

// Pass B on tensor cores (bf16): one block per (sequence-head, 64-row key
// tile), numbered tile-fastest, kWarps warps of 16 key rows (2 when seq_k
// <= 32); after pass A. Staging and walks as in pass A, over query rows.
template <bool kPacked, int kWarps>
__global__ void __launch_bounds__(32 * kWarps)
bwd_key_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ g,
                   const float* __restrict__ bias, int bias_ld,
                   const float* __restrict__ stats, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, int seq_q, KeyRange kr, int heads, int window,
                   int tiles) {
  using namespace dawn_mma;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int rows_k = 16 * kWarps;
  const int nbias = 2 * window + 1, cap = staged_rows(window, kWarps, seq_q);
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);   // rows_k x kLd
  bf16* vs = ks + rows_k * kLd;                    // rows_k x kLd
  bf16* qs = vs + rows_k * kLd;                    // cap x kLd
  bf16* gs = qs + cap * kLd;
  float* lse = reinterpret_cast<float*>(gs + cap * kLd);
  float* delta = lse + cap;
  float* bs = delta + cap;

  const int nh = blockIdx.x / tiles, tile = blockIdx.x % tiles, h = nh % heads;
  const int k0 = tile * kTile, nkr = min(kTile, kr.seq_k - k0);
  const int ib = k0 - kr.key_off - window;        // band offset 0 of warp 0: a query row
  const Span sp = staged_span(ib, window, kWarps, 0, seq_q - 1);
  const size_t ld = row_stride<kDim, kPacked>(heads);
  const size_t q_base = head_base<kDim, kPacked>(nh, heads, seq_q);
  const size_t k_base = head_base<kDim, kPacked>(nh, heads, kr.seq_k);
  // masked key rows stay zeros: they are never read, and get dk = dv = 0
  const int kv_lo = max(k0, kr.kmin), kv_hi = min(k0 + nkr - 1, kr.kmax);
  stage_rows(ks, k + k_base, ld, k0, rows_k, kv_lo, kv_hi);
  stage_rows(vs, v + k_base, ld, k0, rows_k, kv_lo, kv_hi);
  const int i_lo = max(ib, 0), i_hi = min(k0 + nkr - 1 - kr.key_off + window, seq_q - 1);
  stage_rows(qs, q + q_base, ld, sp.first, sp.count, i_lo, i_hi);
  stage_rows(gs, g + q_base, ld, sp.first, sp.count, i_lo, i_hi);
  const size_t plane = (size_t)gridDim.x / tiles * seq_q;
  for (int e = threadIdx.x; e < sp.count; e += blockDim.x) {
    const int i = sp.first + e;
    const bool ok = i >= i_lo && i <= i_hi;        // else p = 0
    lse[e] = ok ? stats[(size_t)nh * seq_q + i] : INFINITY;
    delta[e] = ok ? stats[plane + (size_t)nh * seq_q + i] : 0.f;
  }
  for (int e = threadIdx.x; e < nbias; e += blockDim.x)
    bs[e] = bias != nullptr ? bias[(size_t)h * bias_ld + e] : 0.f;
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (16 * warp >= nkr) return;
  uint32_t ka[2][4], va[2][4];
  load_a(ka[0], ks, 16 * warp, 0, lane);
  load_a(ka[1], ks, 16 * warp, 16, lane);
  load_a(va[0], vs, 16 * warp, 0, lane);
  load_a(va[1], vs, 16 * warp, 16, lane);
  const int q_w = ib + 16 * warp;                  // band offset 0 of this warp
  const QueryBand b{qs, gs, lse, delta, bs, q_w - sp.first};
  const int key0 = k0 + 16 * warp + (lane >> 2);
  const bool key_ok[2] = {key0 >= kr.kmin && key0 <= kr.kmax,
                          key0 + 8 >= kr.kmin && key0 + 8 <= kr.kmax};
  // a warp whose 16 key rows are all masked adds exact zeros: it walks no step
  const bool any_key = k0 + 16 * warp <= kr.kmax && k0 + 16 * warp + 15 >= kr.kmin;
  const Steps st = any_key ? valid_steps(band_rows(window), i_lo - q_w, i_hi - q_w)
                           : Steps{0, 0};
  float dk_acc[4][4] = {}, dv_acc[4][4] = {};
  int c0;
  for (c0 = st.lo; c0 + 32 <= st.end; c0 += 32)
    dkv_chunk<4>(dk_acc, dv_acc, ka, va, b, key_ok, c0, window, lane);
  if (c0 < st.end) dkv_chunk<2>(dk_acc, dv_acc, ka, va, b, key_ok, c0, window, lane);
  store_rows(dk + k_base, ld, k0 + 16 * warp, nkr - 16 * warp, dk_acc, ks + 16 * warp * kLd,
             lane);
  store_rows(dv + k_base, ld, k0 + 16 * warp, nkr - 16 * warp, dv_acc, vs + 16 * warp * kLd,
             lane);
}

// Dynamic shared memory of the bf16 passes with `warps` warps, over seq_k
// key rows and seq_q query rows: two tiles of 16 * warps rows and the
// band's staged rows in bf16 (staged_rows: no more than the valid rows plus
// the steps' padding); A adds the bias row and, with a bias partial, the
// (16 * warps, 2w+1) f32 dS rows; B the bias row and the staged rows'
// statistics.
size_t mma_smem_a(int window, bool bias_grad, int warps, int seq_k) {
  const size_t staged = staged_rows(window, warps, seq_k);
  const size_t nbias = 2 * (size_t)window + 1;
  return (32 * (size_t)warps + 2 * staged) * dawn_mma::kLd * sizeof(bf16) +
         (nbias + (bias_grad ? 16 * warps * nbias : 0)) * sizeof(float);
}
size_t mma_smem_b(int window, int warps, int seq_q) {
  const size_t staged = staged_rows(window, warps, seq_q);
  const size_t nbias = 2 * (size_t)window + 1;
  return (32 * (size_t)warps + 2 * staged) * dawn_mma::kLd * sizeof(bf16) +
         (2 * staged + nbias) * sizeof(float);
}

template <bool kPacked>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const void* g,
                       const float* bias, int bias_ld, void* dq, void* dk, void* dv,
                       void* dbias_partial, void* stats, int n, int seq_q, KeyRange kr,
                       int heads, int window, cudaStream_t stream) {
  const int warps_a = dawn_mma::tile_warps(seq_q), warps_b = dawn_mma::tile_warps(kr.seq_k);
  const size_t smem_a = mma_smem_a(window, dbias_partial != nullptr, warps_a, kr.seq_k);
  const size_t smem_b = mma_smem_b(window, warps_b, seq_q);
  auto kernel_a =
      warps_a == 2 ? bwd_query_mma_kernel<kPacked, 2> : bwd_query_mma_kernel<kPacked, 4>;
  auto kernel_b = warps_b == 2 ? bwd_key_mma_kernel<kPacked, 2> : bwd_key_mma_kernel<kPacked, 4>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel_a, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_a);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel_b, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_b);
  if (err != cudaSuccess) return err;
  const int tiles_q = (seq_q + kTile - 1) / kTile, tiles_k = (kr.seq_k + kTile - 1) / kTile;
  const long long blocks_q = (long long)n * heads * tiles_q;
  const long long blocks_k = (long long)n * heads * tiles_k;
  if (blocks_q > 0x7fffffffLL || blocks_k > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel_a<<<(unsigned)blocks_q, 32 * warps_a, smem_a, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(g), bias, bias_ld, static_cast<bf16*>(dq),
      static_cast<float*>(dbias_partial), static_cast<float*>(stats), seq_q, kr, heads, window,
      tiles_q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kernel_b<<<(unsigned)blocks_k, 32 * warps_b, smem_b, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(g), bias, bias_ld, static_cast<const float*>(stats),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), seq_q, kr, heads, window, tiles_k);
  return cudaGetLastError();
}

// Both passes; head h's 2 * window + 1 bias entries start at bias + h * bias_ld.
template <bool kPacked>
int run(const void* q, const void* k, const void* v, const void* g, const float* bias,
        int bias_ld, void* dq, void* dk, void* dv, void* dbias_partial, void* stats, int n,
        int seq_q, KeyRange kr, int heads, int dim_head, int window, int is_bf16,
        void* stream) {
  if (dim_head != 32 || seq_q < 1 || window < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch_mma<kPacked>(q, k, v, g, bias, bias_ld, dq, dk, dv,
                                             dbias_partial, stats, n, seq_q, kr, heads, window,
                                             s)
                       : launch_f32<32, kPacked>(q, k, v, g, bias, bias_ld, dq, dk, dv,
                                                 dbias_partial, stats, n, seq_q, kr, heads,
                                                 window, s));
}

}  // namespace

extern "C" int dawn_local_attn_packed_bwd(const void* q, const void* k, const void* v,
                                          const void* g, const void* bias, void* dq,
                                          void* dk, void* dv, void* dbias_partial,
                                          void* stats, int n, int t, int heads,
                                          int dim_head, int window, int is_bf16,
                                          void* stream) {
  if (t < 1 || window < 0) return (int)cudaErrorInvalidValue;
  // the band clamped to the keys that exist: the bias entries [w - w_eff, w + w_eff]
  const int w_eff = std::min(window, t - 1);
  const float* b = bias != nullptr ? static_cast<const float*>(bias) + (window - w_eff) : nullptr;
  return run<true>(q, k, v, g, b, 2 * window + 1, dq, dk, dv, dbias_partial, stats, n, t,
                   KeyRange{t, 0, 0, t - 1}, heads, dim_head, w_eff, is_bf16, stream);
}

extern "C" int dawn_local_attn_tiled_bwd(const void* q, const void* k, const void* v,
                                         const void* g, const void* bias, void* dq,
                                         void* dk, void* dv, void* dbias_partial,
                                         void* stats, int n, int t, int heads,
                                         int dim_head, int window, int is_bf16,
                                         void* stream) {
  return run<false>(q, k, v, g, static_cast<const float*>(bias), 2 * window + 1, dq, dk, dv,
                    dbias_partial, stats, n, t, KeyRange{t, 0, 0, t - 1}, heads, dim_head,
                    window, is_bf16, stream);
}

extern "C" int dawn_local_attn_stripe_bwd(const void* q, const void* k, const void* v,
                                          const void* g, const void* bias, void* dq,
                                          void* dk, void* dv, void* dbias_partial,
                                          void* stats, int n, int t_loc, int heads,
                                          int dim_head, int window, int left_edge,
                                          int right_edge, int is_bf16, void* stream) {
  const int seq_k = t_loc + 2 * window;
  const KeyRange kr{seq_k, window, left_edge ? window : 0,
                    right_edge ? window + t_loc - 1 : seq_k - 1};
  return run<true>(q, k, v, g, static_cast<const float*>(bias), 2 * window + 1, dq, dk, dv,
                   dbias_partial, stats, n, t_loc, kr, heads, dim_head, window, is_bf16,
                   stream);
}

extern "C" int dawn_local_attn_tiled_bwd_tile() { return kTile; }

extern "C" int dawn_local_attn_max_window(int kernel, int t, int is_bf16, int with_bias_grad) {
  using dawn_limits::max_window;
  const bool grad = with_bias_grad != 0;
  if (t < 1 || (kernel != 2 && kernel != 4 && kernel != 6)) return -1;
  // K2 and K4: T query and key rows, K2's band clamped to T - 1; K6: t_loc
  // query rows over t_loc + 2w key rows
  return max_window([=](int w) {
    const int band = kernel == 2 ? std::min(w, t - 1) : w;
    const int seq_k = kernel == 6 ? t + 2 * w : t;
    if (is_bf16) {
      using dawn_mma::tile_warps;
      return std::max(mma_smem_a(band, grad, tile_warps(t), seq_k),
                      mma_smem_b(band, tile_warps(seq_k), t));
    }
    return std::max(f32_smem_a<32>(seq_k, band, grad), f32_smem_b<32>(t, band));
  });
}
