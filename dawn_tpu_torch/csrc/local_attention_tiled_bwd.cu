// K4: windowed temporal attention, backward, (N, H, T, D) layout, any T.
//
// Replaces dawn_tpu/ops/local_attention.py::_local_attn_tile_bwd_kernel (the
// Pallas TPU body launched by _tiled_bwd_pallas, the VJP of
// _local_attention_tpu), the backward of K3. With p the softmax rows of the
// forward,
//     p[i, j] = softmax_j(q_i . k_j + bias[h, j - i + w]) over |j - i| <= w,
// and g the gradient of the output, it computes for every (sequence, head)
//     dv_j = sum_i p_ij g_i
//     ds_ij = p_ij (g_i . v_j - delta_i),  delta_i = sum_j p_ij (g_i . v_j)
//     dq_i = sum_j ds_ij k_j,   dk_j = sum_i ds_ij q_i
// and the gradient of the (H, 2w+1) bias vector, dbias[h, r] = the sum over
// sequences and queries of ds[i, i + r - w]. Keys outside the band or
// outside [0, T) have p = 0 and so ds = 0; they are not visited.
//
// What bounds it on an H100: memory. At the top UNet level of a 128^2
// 400-frame video (N*H = 1024*8 sequence-heads, T = 400, D = 32, w = 40,
// bf16) it reads q, k, v, g and writes dq, dk, dv: 7 x 210 MB = 1.47 GB,
// about 0.44 ms at the H100 SXM's 3.35 TB/s; the five products over the
// band's 30,760 (query, key) pairs a sequence-head come to 81 GFLOP, 0.08 ms
// at the 989 TFLOP/s bf16 peak.
// What the design does about it: K2 keeps a whole sequence in shared memory,
// which at T = 400 (four f32 (T, 33) arrays, 211 KB) no longer fits beside
// anything else, and at T = 800 not at all. K4 tiles the sequence instead,
// in two launches on the caller's stream, kTile = 64 rows a block:
//   A. query tiles: a block stages the key/value rows its queries' bands
//      touch, [q0-w, q1-1+w] cut to [0, T). It finds each row's log-sum-exp
//      and delta_i (online rescaling), then walks the band again for dS and
//      dq_i. It writes dq, the two row statistics (lse, delta) to a (2, N*H,
//      T) f32 scratch, and its f32 dS rows into shared memory, whose columns
//      the block sums in query order into one (2w+1) bias partial per
//      (sequence, head, tile).
//   B. key tiles: a block stages the query and gradient rows whose bands
//      touch its keys, [k0-w, k1-1+w], with their row statistics from A, and
//      recomputes p = exp(s - lse) and ds to sum dk_j and dv_j. One block
//      owns each key row, so no atomics: the gradients of a key row that
//      several query tiles see are summed in one place.
// The caller sums the bias partials over sequences and tiles in a fixed
// order, so the result does not change from run to run. The TPU kernel's
// per-tile left/center/right dk/dv buffers and shifted adds are not needed.
//
// f32 runs on the CUDA cores: one thread a row, the band walked twice in A
// and once in B, one shared load per FMA (215 registers a thread in B).
// bf16 runs on the tensor cores, the same two passes with 4 warps of 16 rows
// a block: q, g (A) or k, v (B) tiles and the band's rows staged in bf16
// with 16-byte cp.async, zeros outside [0, T); every product on mma.sync
// m16n8k16 with ldmatrix fragments (mma_bf16.cuh). A: S = Q K^T and dP =
// dO V^T over the band in chunks of 32 keys with an online max, sum and
// sum of p dp (so registers do not grow with w); then again for P = exp(S -
// lse), dS = P (dP - delta), dQ = dS K, with dS rounded to bf16 for the
// product (JAX's dsk) and the f32 dS written to the bias rows (JAX sums the
// f32 ds). B: S^T = K Q^T, P^T = exp(S^T + bias - lse), dV = P^T dO with P
// rounded to bf16 (JAX's pk), dP^T = V dO^T, dS^T = P^T (dP^T - delta), dK =
// dS^T Q with dS rounded to bf16. The C fragments of one product, packed to
// bf16, are the A fragments of the next, so P and dS never leave registers.
// Blocks are numbered tile-fastest, so the tiles of one (sequence, head),
// whose bands share 2w rows, run side by side and meet those rows in L2.
// The C entry dispatches on is_bf16.
//
// C interface (bound with ctypes):
//   int dawn_local_attn_tiled_bwd(q, k, v, g, bias, dq, dk, dv, dbias_partial,
//                                 stats, n, t, heads, dim_head, window, is_bf16,
//                                 stream)
// bias may be null (no bias: zeros) and dbias_partial may be null (no bias
// gradient wanted); otherwise dbias_partial is (N*H, ceil(T/kTile), 2w+1)
// f32, with kTile as dawn_local_attn_tiled_bwd_tile() returns it. stats is
// (2, N*H, T) f32 scratch. With a bias partial, bf16 takes any w with
// (128 + 2 * staged_rows(w)) * 80 B + 65 * (2w + 1) * 4 B <= 227 KB (w <=
// 249), f32 any w <= 205. Returns cudaGetLastError() after the launches (0
// on success), or cudaErrorInvalidValue for a shape it was not built for.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kTile = 64;  // rows per block in both passes (f32: one thread a row)

template <int D>
__device__ __forceinline__ float dot(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) s = fmaf(a[d], b[d], s);
  return s;
}

// Rows [r0, r0 + rows) of one (sequence, head) into shared memory, padded to
// D+1 floats: the threads of a warp read different rows at the same column,
// and the padding puts them in distinct banks.
template <int D>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, int r0,
                                      int rows) {
  for (int e = threadIdx.x; e < rows * D; e += blockDim.x)
    dst[(e / D) * (D + 1) + e % D] = src[(size_t)r0 * D + e];
}

// Pass A in f32: one block per (sequence-head, query tile).
template <int D>
__global__ void __launch_bounds__(kTile)
tiled_bwd_query_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ g,
                       const float* __restrict__ bias, float* __restrict__ dq,
                       float* __restrict__ dbias_partial, float* __restrict__ stats,
                       int seq_len, int heads, int window) {
  extern __shared__ float smem[];
  constexpr int kStride = D + 1;
  const int t = seq_len, nbias = 2 * window + 1;
  const int nh = blockIdx.x, h = nh % heads;
  const int q0 = blockIdx.y * kTile, q1 = min(q0 + kTile, t);  // q1 exclusive
  const int k0 = max(q0 - window, 0), k1 = min(q1 - 1 + window, t - 1);
  const int rows = k1 - k0 + 1;
  float* ks = smem;
  float* vs = ks + rows * kStride;
  float* bs = vs + rows * kStride;
  float* ds_rows = bs + nbias;  // (kTile, 2w+1) when a bias partial is wanted

  const size_t base = (size_t)nh * t * D;
  stage<D>(ks, k + base, k0, rows);
  stage<D>(vs, v + base, k0, rows);
  for (int e = threadIdx.x; e < nbias; e += blockDim.x)
    bs[e] = bias != nullptr ? bias[(size_t)h * nbias + e] : 0.f;
  __syncthreads();

  const int i = q0 + threadIdx.x;
  if (i < q1) {
    const size_t row = base + (size_t)i * D;
    float qi[D], gi[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      qi[d] = q[row + d];
      gi[d] = g[row + d];
    }
    const int j0 = max(i - window, 0), j1 = min(i + window, t - 1);
    // walk 1: row max m, row sum l and sum_j p_ij (g_i . v_j), rescaled
    // whenever the max grows
    float m = -INFINITY, l = 0.f, pdp = 0.f;
    for (int j = j0; j <= j1; ++j) {
      const float s = dot<D>(qi, ks + (j - k0) * kStride) + bs[j - i + window];
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
      const float s = dot<D>(qi, kj) + bs[j - i + window];
      const float p = expf(s - lse);
      const float ds = p * (dot<D>(gi, vs + (j - k0) * kStride) - delta);
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(ds, kj[d], acc[d]);
      if (ds_row != nullptr) ds_row[j - i + window] = ds;
    }
#pragma unroll
    for (int d = 0; d < D; ++d) dq[row + d] = acc[d];
    const size_t plane = (size_t)gridDim.x * t, at = (size_t)nh * t + i;
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
template <int D>
__global__ void __launch_bounds__(kTile)
tiled_bwd_key_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ g,
                     const float* __restrict__ bias, const float* __restrict__ stats,
                     float* __restrict__ dk, float* __restrict__ dv, int seq_len, int heads,
                     int window) {
  extern __shared__ float smem[];
  constexpr int kStride = D + 1;
  const int t = seq_len, nbias = 2 * window + 1;
  const int nh = blockIdx.x, h = nh % heads;
  const int k0 = blockIdx.y * kTile, k1 = min(k0 + kTile, t);  // k1 exclusive
  const int i0 = max(k0 - window, 0), i1 = min(k1 - 1 + window, t - 1);
  const int rows = i1 - i0 + 1;
  float* qs = smem;
  float* gs = qs + rows * kStride;
  float* row_lse = gs + rows * kStride;
  float* row_delta = row_lse + rows;
  float* bs = row_delta + rows;

  const size_t base = (size_t)nh * t * D;
  stage<D>(qs, q + base, i0, rows);
  stage<D>(gs, g + base, i0, rows);
  const size_t plane = (size_t)gridDim.x * t, at = (size_t)nh * t + i0;
  for (int e = threadIdx.x; e < rows; e += blockDim.x) {
    row_lse[e] = stats[at + e];
    row_delta[e] = stats[plane + at + e];
  }
  for (int e = threadIdx.x; e < nbias; e += blockDim.x)
    bs[e] = bias != nullptr ? bias[(size_t)h * nbias + e] : 0.f;
  __syncthreads();

  const int j = k0 + threadIdx.x;
  if (j >= k1) return;
  const size_t row = base + (size_t)j * D;
  float kj[D], vj[D], dk_acc[D], dv_acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    kj[d] = k[row + d];
    vj[d] = v[row + d];
    dk_acc[d] = dv_acc[d] = 0.f;
  }
  const int ia = max(j - window, 0), ib = min(j + window, t - 1);
  for (int i = ia; i <= ib; ++i) {
    const int r = i - i0;
    const float* qi = qs + r * kStride;
    const float* gi = gs + r * kStride;
    const float s = dot<D>(qi, kj) + bs[j - i + window];
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

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const void* g,
                       const void* bias, void* dq, void* dk, void* dv, void* dbias_partial,
                       void* stats, int n, int t, int heads, int window,
                       cudaStream_t stream) {
  const size_t rows_max = min(t, kTile + 2 * window), nbias = 2 * (size_t)window + 1;
  const size_t smem_a = (2 * rows_max * (D + 1) + nbias +
                         (dbias_partial != nullptr ? kTile * nbias : 0)) * sizeof(float);
  const size_t smem_b = (2 * rows_max * (D + 1) + 2 * rows_max + nbias) * sizeof(float);
  auto kernel_a = tiled_bwd_query_kernel<D>;
  auto kernel_b = tiled_bwd_key_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel_a, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_a);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel_b, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_b);
  if (err != cudaSuccess) return err;
  const dim3 grid(n * heads, (t + kTile - 1) / kTile);
  kernel_a<<<grid, kTile, smem_a, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(g),
      static_cast<const float*>(bias), static_cast<float*>(dq),
      static_cast<float*>(dbias_partial), static_cast<float*>(stats), t, heads, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kernel_b<<<grid, kTile, smem_b, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(g),
      static_cast<const float*>(bias), static_cast<const float*>(stats),
      static_cast<float*>(dk), static_cast<float*>(dv), t, heads, window);
  return cudaGetLastError();
}

using bf16 = __nv_bfloat16;

// The masked scores and dP of one chunk of NT n8 key tiles at band offset
// c0 of a warp in pass A (band offset 0 at key row key_w): s = q . k + bias,
// -inf outside the band and outside [0, T); dp = g . v.
template <int NT>
__device__ __forceinline__ void band_scores(float (&s)[NT][4], float (&dp)[NT][4],
                                            const uint32_t (&qa)[2][4],
                                            const uint32_t (&ga)[2][4], const bf16* kw,
                                            const bf16* vw, const float* bs, int c0,
                                            int key_w, int t, int nbias, int lane) {
  using namespace dawn_mma;
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    mma_dot(s[j], qa, kw, c0 + 8 * j, lane);
    mma_dot(dp[j], ga, vw, c0 + 8 * j, lane);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      // row g + 8 (r / 2), band offset off: bias entry off - row
      const int off = c0 + 8 * j + 2 * tq + (r & 1), idx = off - g - 8 * (r >> 1);
      const int key = key_w + off;
      const bool ok = idx >= 0 && idx < nbias && key >= 0 && key < t;
      s[j][r] = ok ? s[j][r] + bs[ok ? idx : 0] : -INFINITY;
    }
  }
}

// Pass A, walk 1 over one chunk: the online row max m, row sum l and
// sum_j p_ij dp_ij (this lane's share of l and of that sum).
template <int NT>
__device__ __forceinline__ void stats_chunk(float (&m)[2], float (&l)[2], float (&pdp)[2],
                                            const uint32_t (&qa)[2][4],
                                            const uint32_t (&ga)[2][4], const bf16* kw,
                                            const bf16* vw, const float* bs, int c0,
                                            int key_w, int t, int nbias, int lane) {
  using namespace dawn_mma;
  float s[NT][4], dp[NT][4];
  band_scores<NT>(s, dp, qa, ga, kw, vw, bs, c0, key_w, t, nbias, lane);
  float base[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < NT; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * hh], s[j][2 * hh + 1]));
    const float m_new = fmaxf(m[hh], quad_max(mx));
    base[hh] = m_new == -INFINITY ? 0.f : m_new;   // a row with no key yet
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
                                         const uint32_t (&ga)[2][4], const bf16* kw,
                                         const bf16* vw, const float* bs, int c0, int key_w,
                                         int t, int nbias, int lane) {
  using namespace dawn_mma;
  const int g = lane >> 2, tq = lane & 3;
  float s[NT][4], dp[NT][4];
  band_scores<NT>(s, dp, qa, ga, kw, vw, bs, c0, key_w, t, nbias, lane);
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int hh = r >> 1;
      const float p = exp2f((s[j][r] - lse[hh]) * kLog2e);
      s[j][r] = p * (dp[j][r] - delta[hh]);
      const int idx = c0 + 8 * j + 2 * tq + (r & 1) - g - 8 * hh;
      if (ds_rows != nullptr && idx >= 0 && idx < nbias)
        ds_rows[(g + 8 * hh) * nbias + idx] = s[j][r];
    }
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) {
    uint32_t da[4];
    pack_a(da, s[2 * i], s[2 * i + 1]);
    mma_rows(dq, da, kw, c0 + 16 * i, lane);
  }
}

// Pass A on tensor cores (bf16): one block per (sequence-head, 64-row query
// tile), numbered tile-fastest, 4 warps of 16 query rows.
__global__ void __launch_bounds__(128)
bwd_query_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ g,
                     const float* __restrict__ bias, bf16* __restrict__ dq,
                     float* __restrict__ dbias_partial, float* __restrict__ stats,
                     int seq_len, int heads, int window, int tiles) {
  using namespace dawn_mma;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int t = seq_len, nbias = 2 * window + 1, staged = staged_rows(window);
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // 64 x kLd
  bf16* gs = qs + 64 * kLd;                        // 64 x kLd
  bf16* ks = gs + 64 * kLd;                        // staged x kLd
  bf16* vs = ks + staged * kLd;
  float* bs = reinterpret_cast<float*>(vs + staged * kLd);
  float* ds_rows = bs + nbias;   // (64, 2w+1) when a bias partial is wanted

  const int nh = blockIdx.x / tiles, tile = blockIdx.x % tiles, h = nh % heads;
  const int q0 = tile * kTile, nq = min(kTile, t - q0);
  const int kb = q0 - window;                      // the key row at shared row 0
  const size_t base = (size_t)nh * t * kDim;
  stage_rows(qs, q + base, kDim, q0, 64, q0, q0 + nq - 1);
  stage_rows(gs, g + base, kDim, q0, 64, q0, q0 + nq - 1);
  const int k_lo = max(kb, 0), k_hi = min(q0 + nq - 1 + window, t - 1);
  stage_rows(ks, k + base, kDim, kb, staged, k_lo, k_hi);
  stage_rows(vs, v + base, kDim, kb, staged, k_lo, k_hi);
  for (int e = threadIdx.x; e < nbias; e += blockDim.x)
    bs[e] = bias != nullptr ? bias[(size_t)h * nbias + e] : 0.f;
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (16 * warp < nq) {
    uint32_t qa[2][4], ga[2][4];
    load_a(qa[0], qs, 16 * warp, 0, lane);
    load_a(qa[1], qs, 16 * warp, 16, lane);
    load_a(ga[0], gs, 16 * warp, 0, lane);
    load_a(ga[1], gs, 16 * warp, 16, lane);
    const bf16* kw = ks + 16 * warp * kLd;         // the warp's band: rows [0, nk)
    const bf16* vw = vs + 16 * warp * kLd;
    const int key_w = kb + 16 * warp, nk = band_rows(window);

    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, pdp[2] = {0.f, 0.f};
    int c0 = 0;
    for (; c0 + 32 <= nk; c0 += 32)
      stats_chunk<4>(m, l, pdp, qa, ga, kw, vw, bs, c0, key_w, t, nbias, lane);
    if (c0 < nk)   // nk is a multiple of 16
      stats_chunk<2>(m, l, pdp, qa, ga, kw, vw, bs, c0, key_w, t, nbias, lane);
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
    for (c0 = 0; c0 + 32 <= nk; c0 += 32)
      dq_chunk<4>(acc, lse, delta, ds_warp, qa, ga, kw, vw, bs, c0, key_w, t, nbias, lane);
    if (c0 < nk)
      dq_chunk<2>(acc, lse, delta, ds_warp, qa, ga, kw, vw, bs, c0, key_w, t, nbias, lane);
    store_rows(dq + base, kDim, q0 + 16 * warp, nq - 16 * warp, acc, qs + 16 * warp * kLd,
               lane);
    if ((lane & 3) == 0) {
      const size_t plane = (size_t)gridDim.x / tiles * t;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = 16 * warp + (lane >> 2) + 8 * hh;
        if (r < nq) {
          stats[(size_t)nh * t + q0 + r] = lse[hh];
          stats[plane + (size_t)nh * t + q0 + r] = delta[hh];
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

// Pass B on tensor cores, one chunk of NT n8 query tiles at band offset c0
// of a warp's 16 key rows (band offset 0 at shared query row 0 of qw, gw,
// lse, delta): p^T = exp(k . q + bias - lse), ds^T = p^T (v . g - delta),
// dv += p^T g and dk += ds^T q with p and ds rounded to bf16.
template <int NT>
__device__ __forceinline__ void dkv_chunk(float (&dk)[4][4], float (&dv)[4][4],
                                          const uint32_t (&ka)[2][4],
                                          const uint32_t (&va)[2][4], const bf16* qw,
                                          const bf16* gw, const float* lse,
                                          const float* delta, const float* bs, int c0,
                                          int window, int lane) {
  using namespace dawn_mma;
  const int g = lane >> 2, tq = lane & 3, nbias = 2 * window + 1;
  float p[NT][4], ds[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    mma_dot(p[j], ka, qw, c0 + 8 * j, lane);
    mma_dot(ds[j], va, gw, c0 + 8 * j, lane);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      // key row g + 8 (r / 2), query at band offset off: bias entry
      // key - query + w
      const int off = c0 + 8 * j + 2 * tq + (r & 1), idx = g + 8 * (r >> 1) - off + 2 * window;
      const bool ok = idx >= 0 && idx < nbias;
      const float pr = ok ? exp2f((p[j][r] + bs[ok ? idx : 0] - lse[off]) * kLog2e) : 0.f;
      ds[j][r] = pr * (ds[j][r] - delta[off]);
      p[j][r] = pr;
    }
  }
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) {
    uint32_t pa[4], da[4];
    pack_a(pa, p[2 * i], p[2 * i + 1]);
    pack_a(da, ds[2 * i], ds[2 * i + 1]);
    mma_rows(dv, pa, gw, c0 + 16 * i, lane);
    mma_rows(dk, da, qw, c0 + 16 * i, lane);
  }
}

// Pass B on tensor cores (bf16): one block per (sequence-head, 64-row key
// tile), numbered tile-fastest, 4 warps of 16 key rows; after pass A.
__global__ void __launch_bounds__(128)
bwd_key_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ g,
                   const float* __restrict__ bias, const float* __restrict__ stats,
                   bf16* __restrict__ dk, bf16* __restrict__ dv, int seq_len, int heads,
                   int window, int tiles) {
  using namespace dawn_mma;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int t = seq_len, nbias = 2 * window + 1, staged = staged_rows(window);
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);   // 64 x kLd
  bf16* vs = ks + 64 * kLd;                        // 64 x kLd
  bf16* qs = vs + 64 * kLd;                        // staged x kLd
  bf16* gs = qs + staged * kLd;
  float* lse = reinterpret_cast<float*>(gs + staged * kLd);
  float* delta = lse + staged;
  float* bs = delta + staged;

  const int nh = blockIdx.x / tiles, tile = blockIdx.x % tiles, h = nh % heads;
  const int k0 = tile * kTile, nkr = min(kTile, t - k0);
  const int ib = k0 - window;                      // the query row at shared row 0
  const size_t base = (size_t)nh * t * kDim;
  stage_rows(ks, k + base, kDim, k0, 64, k0, k0 + nkr - 1);
  stage_rows(vs, v + base, kDim, k0, 64, k0, k0 + nkr - 1);
  const int i_lo = max(ib, 0), i_hi = min(k0 + nkr - 1 + window, t - 1);
  stage_rows(qs, q + base, kDim, ib, staged, i_lo, i_hi);
  stage_rows(gs, g + base, kDim, ib, staged, i_lo, i_hi);
  const size_t plane = (size_t)gridDim.x / tiles * t;
  for (int e = threadIdx.x; e < staged; e += blockDim.x) {
    const int i = ib + e;
    const bool ok = i >= i_lo && i <= i_hi;        // else p = 0
    lse[e] = ok ? stats[(size_t)nh * t + i] : INFINITY;
    delta[e] = ok ? stats[plane + (size_t)nh * t + i] : 0.f;
  }
  for (int e = threadIdx.x; e < nbias; e += blockDim.x)
    bs[e] = bias != nullptr ? bias[(size_t)h * nbias + e] : 0.f;
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (16 * warp >= nkr) return;
  uint32_t ka[2][4], va[2][4];
  load_a(ka[0], ks, 16 * warp, 0, lane);
  load_a(ka[1], ks, 16 * warp, 16, lane);
  load_a(va[0], vs, 16 * warp, 0, lane);
  load_a(va[1], vs, 16 * warp, 16, lane);
  const bf16* qw = qs + 16 * warp * kLd;           // the warp's band: rows [0, nb)
  const bf16* gw = gs + 16 * warp * kLd;
  const float* lw = lse + 16 * warp;
  const float* dw = delta + 16 * warp;
  const int nb = band_rows(window);
  float dk_acc[4][4] = {}, dv_acc[4][4] = {};
  int c0 = 0;
  for (; c0 + 32 <= nb; c0 += 32)
    dkv_chunk<4>(dk_acc, dv_acc, ka, va, qw, gw, lw, dw, bs, c0, window, lane);
  if (c0 < nb)   // nb is a multiple of 16
    dkv_chunk<2>(dk_acc, dv_acc, ka, va, qw, gw, lw, dw, bs, c0, window, lane);
  store_rows(dk + base, kDim, k0 + 16 * warp, nkr - 16 * warp, dk_acc, ks + 16 * warp * kLd,
             lane);
  store_rows(dv + base, kDim, k0 + 16 * warp, nkr - 16 * warp, dv_acc, vs + 16 * warp * kLd,
             lane);
}

cudaError_t launch_mma(const void* q, const void* k, const void* v, const void* g,
                       const void* bias, void* dq, void* dk, void* dv, void* dbias_partial,
                       void* stats, int n, int t, int heads, int window, cudaStream_t stream) {
  const size_t staged = dawn_mma::staged_rows(window), nbias = 2 * (size_t)window + 1;
  const size_t tiles_bytes = (2 * kTile + 2 * staged) * dawn_mma::kLd * sizeof(bf16);
  const size_t smem_a =
      tiles_bytes + (nbias + (dbias_partial != nullptr ? kTile * nbias : 0)) * sizeof(float);
  const size_t smem_b = tiles_bytes + (2 * staged + nbias) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_query_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_a);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(bwd_key_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_b);
  if (err != cudaSuccess) return err;
  const int tiles = (t + kTile - 1) / kTile;
  const long long blocks = (long long)n * heads * tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  bwd_query_mma_kernel<<<(unsigned)blocks, 128, smem_a, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(g), static_cast<const float*>(bias), static_cast<bf16*>(dq),
      static_cast<float*>(dbias_partial), static_cast<float*>(stats), t, heads, window, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_key_mma_kernel<<<(unsigned)blocks, 128, smem_b, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(g), static_cast<const float*>(bias),
      static_cast<const float*>(stats), static_cast<bf16*>(dk), static_cast<bf16*>(dv), t,
      heads, window, tiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" int dawn_local_attn_tiled_bwd(const void* q, const void* k, const void* v,
                                         const void* g, const void* bias, void* dq,
                                         void* dk, void* dv, void* dbias_partial,
                                         void* stats, int n, int t, int heads,
                                         int dim_head, int window, int is_bf16,
                                         void* stream) {
  if (dim_head != 32 || t < 1 || window < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch_mma(q, k, v, g, bias, dq, dk, dv, dbias_partial, stats, n,
                                    t, heads, window, s)
                       : launch_f32<32>(q, k, v, g, bias, dq, dk, dv, dbias_partial,
                                        stats, n, t, heads, window, s));
}

extern "C" int dawn_local_attn_tiled_bwd_tile() { return kTile; }
