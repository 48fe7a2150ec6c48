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
// in two launches on the caller's stream, kTile rows a block, one thread a
// row, blocks on (N*H, tiles) of gridDim.x and y:
//   A. query tiles: a block stages the key/value rows its queries' bands
//      touch, [q0-w, q1-1+w] cut to [0, T). Each thread walks its band once
//      for the row max, row sum and delta_i (online rescaling), then again
//      for dS and dq_i. It writes dq_i and the row statistics (max, 1/sum,
//      delta) to a (3, N*H, T) f32 scratch, and its dS row into shared
//      memory, whose columns the block sums into one (2w+1) bias partial per
//      (sequence, head, tile).
//   B. key tiles: a block stages the query and gradient rows whose bands
//      touch its keys, [k0-w, k1-1+w], with their row statistics from A.
//      Each thread owns one key row j and recomputes p and ds (bit for bit
//      as A did) to sum dk_j and dv_j. One thread owns each key row, so no
//      atomics: the gradients of a key row that several query tiles see are
//      summed in one place.
// The caller sums the bias partials over sequences and tiles in a fixed
// order, so the result does not change from run to run. Softmax and
// accumulation run in f32; dq, dk, dv are stored in the input dtype, the
// bias partials in f32. The TPU kernel's per-tile left/center/right dk/dv
// buffers and shifted adds are not needed. No tensor cores yet
// (mma/wgmma, TMA and pipelining are later work).
//
// C interface (bound with ctypes):
//   int dawn_local_attn_tiled_bwd(q, k, v, g, bias, dq, dk, dv, dbias_partial,
//                                 stats, n, t, heads, dim_head, window, is_bf16,
//                                 stream)
// bias may be null (no bias: zeros) and dbias_partial may be null (no bias
// gradient wanted); otherwise dbias_partial is (N*H, ceil(T/kTile), 2w+1)
// f32, with kTile as dawn_local_attn_tiled_bwd_tile() returns it. stats is
// (3, N*H, T) f32 scratch. Returns cudaGetLastError() after the launches (0
// on success), or cudaErrorInvalidValue for a shape it was not built for.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 64;  // rows per block in both passes, one thread each

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int D>
__device__ __forceinline__ float dot(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) s = fmaf(a[d], b[d], s);
  return s;
}

// Rows [r0, r0 + rows) of one (sequence, head) into shared memory as f32,
// padded to D+1 floats: the threads of a warp read different rows at the
// same column, and the padding puts them in distinct banks.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src, int r0,
                                      int rows) {
  for (int e = threadIdx.x; e < rows * D; e += blockDim.x)
    dst[(e / D) * (D + 1) + e % D] = to_f32(src[(size_t)r0 * D + e]);
}

// Pass A: one block per (sequence-head, query tile).
template <typename T, int D>
__global__ void __launch_bounds__(kTile)
tiled_bwd_query_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ g,
                       const float* __restrict__ bias, T* __restrict__ dq,
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
  stage<T, D>(ks, k + base, k0, rows);
  stage<T, D>(vs, v + base, k0, rows);
  for (int e = threadIdx.x; e < nbias; e += blockDim.x)
    bs[e] = bias != nullptr ? bias[(size_t)h * nbias + e] : 0.f;
  __syncthreads();

  const int i = q0 + threadIdx.x;
  if (i < q1) {
    const size_t row = base + (size_t)i * D;
    float qi[D], gi[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      qi[d] = to_f32(q[row + d]);
      gi[d] = to_f32(g[row + d]);
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
    const float inv = 1.f / l, delta = pdp * inv;
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
      const float p = expf(s - m) * inv;
      const float ds = p * (dot<D>(gi, vs + (j - k0) * kStride) - delta);
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(ds, kj[d], acc[d]);
      if (ds_row != nullptr) ds_row[j - i + window] = ds;
    }
#pragma unroll
    for (int d = 0; d < D; ++d) dq[row + d] = from_f32<T>(acc[d]);
    const size_t plane = (size_t)gridDim.x * t, at = (size_t)nh * t + i;
    stats[at] = m;
    stats[plane + at] = inv;
    stats[2 * plane + at] = delta;
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

// Pass B: one block per (sequence-head, key tile), after pass A.
template <typename T, int D>
__global__ void __launch_bounds__(kTile)
tiled_bwd_key_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ g,
                     const float* __restrict__ bias, const float* __restrict__ stats,
                     T* __restrict__ dk, T* __restrict__ dv, int seq_len, int heads,
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
  float* row_max = gs + rows * kStride;
  float* row_inv_sum = row_max + rows;
  float* row_delta = row_inv_sum + rows;
  float* bs = row_delta + rows;

  const size_t base = (size_t)nh * t * D;
  stage<T, D>(qs, q + base, i0, rows);
  stage<T, D>(gs, g + base, i0, rows);
  const size_t plane = (size_t)gridDim.x * t, at = (size_t)nh * t + i0;
  for (int e = threadIdx.x; e < rows; e += blockDim.x) {
    row_max[e] = stats[at + e];
    row_inv_sum[e] = stats[plane + at + e];
    row_delta[e] = stats[2 * plane + at + e];
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
    kj[d] = to_f32(k[row + d]);
    vj[d] = to_f32(v[row + d]);
    dk_acc[d] = dv_acc[d] = 0.f;
  }
  const int ia = max(j - window, 0), ib = min(j + window, t - 1);
  for (int i = ia; i <= ib; ++i) {
    const int r = i - i0;
    const float* qi = qs + r * kStride;
    const float* gi = gs + r * kStride;
    const float s = dot<D>(qi, kj) + bs[j - i + window];
    const float p = expf(s - row_max[r]) * row_inv_sum[r];
    const float ds = p * (dot<D>(gi, vj) - row_delta[r]);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      dk_acc[d] = fmaf(ds, qi[d], dk_acc[d]);
      dv_acc[d] = fmaf(p, gi[d], dv_acc[d]);
    }
  }
#pragma unroll
  for (int d = 0; d < D; ++d) {
    dk[row + d] = from_f32<T>(dk_acc[d]);
    dv[row + d] = from_f32<T>(dv_acc[d]);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* g,
                   const void* bias, void* dq, void* dk, void* dv, void* dbias_partial,
                   void* stats, int n, int t, int heads, int window, cudaStream_t stream) {
  const size_t rows_max = min(t, kTile + 2 * window), nbias = 2 * (size_t)window + 1;
  const size_t smem_a = (2 * rows_max * (D + 1) + nbias +
                         (dbias_partial != nullptr ? kTile * nbias : 0)) * sizeof(float);
  const size_t smem_b = (2 * rows_max * (D + 1) + 3 * rows_max + nbias) * sizeof(float);
  auto kernel_a = tiled_bwd_query_kernel<T, D>;
  auto kernel_b = tiled_bwd_key_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel_a, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_a);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel_b, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_b);
  if (err != cudaSuccess) return err;
  const dim3 grid(n * heads, (t + kTile - 1) / kTile);
  kernel_a<<<grid, kTile, smem_a, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), static_cast<const float*>(bias), static_cast<T*>(dq),
      static_cast<float*>(dbias_partial), static_cast<float*>(stats), t, heads, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kernel_b<<<grid, kTile, smem_b, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), static_cast<const float*>(bias),
      static_cast<const float*>(stats), static_cast<T*>(dk), static_cast<T*>(dv), t,
      heads, window);
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
  return (int)(is_bf16 ? launch<__nv_bfloat16, 32>(q, k, v, g, bias, dq, dk, dv,
                                                   dbias_partial, stats, n, t, heads,
                                                   window, s)
                       : launch<float, 32>(q, k, v, g, bias, dq, dk, dv, dbias_partial,
                                           stats, n, t, heads, window, s));
}

extern "C" int dawn_local_attn_tiled_bwd_tile() { return kTile; }
