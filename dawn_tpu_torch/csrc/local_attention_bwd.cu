// K2: windowed temporal attention, backward, packed (N, T, H*D) layout.
//
// Replaces dawn_tpu/ops/local_attention.py::_local_attn_packed_bwd_kernel
// (the Pallas TPU body launched by _packed_bwd_pallas, the VJP of
// local_attention_packed_tpu). With p the softmax rows of the forward (K1),
//     p[i, j] = softmax_j(q_i . k_j + bias[h, j - i + w]) over |j - i| <= w,
// and g the gradient of the output, it computes for every (sequence, head)
//     dv_j = sum_i p_ij g_i
//     ds_ij = p_ij (g_i . v_j - delta_i),  delta_i = sum_j p_ij (g_i . v_j)
//     dq_i = sum_j ds_ij k_j,   dk_j = sum_i ds_ij q_i
// and the gradient of the (H, 2w+1) bias vector, dbias[h, r] = the sum over
// sequences and queries of ds[i, i + r - w]. Keys outside the band have
// p = 0 and so ds = 0; they are skipped, as in K1.
//
// What bounds it on an H100: memory. At the stage-1 training shape (N = 4 x
// 32^2 = 4096 sequences, T = 20, H*dh = 8 x 32, w = 20, bf16) it reads q, k,
// v, g and writes dq, dk, dv: 7 x 41.9 MB = 294 MB, about 88 us at the H100
// SXM's 3.35 TB/s; the products in the band come to about 4.2 GFLOP, about
// 4 us at the 989 TFLOP/s bf16 peak.
// What the design does about it: one pass over the seven tensors. A block
// owns one (sequence, head); T <= 256, so the block stages the whole
// sequence's q, k, v and g rows in shared memory as f32 (at most 4 x 256 x
// 33 floats = 132 KB) and writes no score, probability or dS tensor to
// device memory. Three phases, each thread owning one row:
//   1. per query row i: the row max, the row sum and delta_i in f32 (two
//      walks over the band), then dq_i (a third walk); the row statistics go
//      to shared memory;
//   2. per key row j: dk_j and dv_j, recomputing p and ds from the row
//      statistics (no atomics: one thread owns each key row);
//   3. per bias offset r: the block's partial dbias[h, r], again recomputed;
//      the partials (N, H, 2w+1) are summed over N by the caller, in a fixed
//      order, so the result does not change from run to run.
// Softmax and accumulation run in f32; dq, dk, dv are stored in the input
// dtype, the bias partials in f32. In bf16 the TPU kernel rounds p and ds to
// bf16 before the products (pk, dsk: dawn_tpu/ops/local_attention.py:773-
// 774), so the bf16 body does too (the kRound flag): ds before the dq and dk
// FMAs, p before the dv FMA; the bias partials sum the f32 ds, as JAX does.
// No tensor cores yet (the redesign is queued).
//
// C interface (bound with ctypes):
//   int dawn_local_attn_packed_bwd(q, k, v, g, bias, dq, dk, dv, dbias_partial,
//                                  n, t, heads, dim_head, window, is_bf16,
//                                  stream)
// bias may be null (no bias: zeros) and dbias_partial may be null (no bias
// gradient wanted). Returns cudaGetLastError() after the launch (0 on
// success), or cudaErrorInvalidValue for a shape it was not built for.
//   int dawn_local_attn_max_window(kernel, t, is_bf16, with_bias_grad)
// returns the largest window kernel 2 takes at T = t on the current device,
// -1 for another kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "smem_limit.cuh"

namespace {

constexpr int kMaxT = 256;  // one thread per row, the whole sequence per block

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

// x rounded to T and back when kRound (the TPU kernel's cast of p and ds
// to the input dtype before a product), else x
template <typename T, bool kRound>
__device__ __forceinline__ float rounded(float x) {
  return kRound ? to_f32(from_f32<T>(x)) : x;
}

template <typename T, int D, bool kRound>
__global__ void __launch_bounds__(kMaxT)
local_attn_packed_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const T* __restrict__ g,
                             const float* __restrict__ bias, T* __restrict__ dq,
                             T* __restrict__ dk, T* __restrict__ dv,
                             float* __restrict__ dbias_partial, int t, int heads,
                             int window) {
  extern __shared__ float smem[];
  // rows padded to D+1 floats: the threads of a warp read different rows at
  // the same column, and the padding puts them in distinct banks
  constexpr int kStride = D + 1;
  const int n = blockIdx.x, h = blockIdx.y, nbias = 2 * window + 1;
  float* qs = smem;
  float* gs = qs + t * kStride;
  float* ks = gs + t * kStride;
  float* vs = ks + t * kStride;
  float* row_max = vs + t * kStride;
  float* row_inv_sum = row_max + t;
  float* row_delta = row_inv_sum + t;
  float* bs = row_delta + t;

  const int hd = heads * D;
  const size_t base = (size_t)n * t * hd + (size_t)h * D;
  for (int e = threadIdx.x; e < t * D; e += blockDim.x) {
    const int r = e / D, d = e % D;
    const size_t gi = base + (size_t)r * hd + d;
    qs[r * kStride + d] = to_f32(q[gi]);
    gs[r * kStride + d] = to_f32(g[gi]);
    ks[r * kStride + d] = to_f32(k[gi]);
    vs[r * kStride + d] = to_f32(v[gi]);
  }
  for (int e = threadIdx.x; e < nbias; e += blockDim.x)
    bs[e] = bias != nullptr ? bias[(size_t)h * nbias + e] : 0.f;
  __syncthreads();

  // phase 1: query rows -> row statistics and dq; key row j of query row i
  // has the bias entry j - i + w
  for (int i = threadIdx.x; i < t; i += blockDim.x) {
    const float* qi = qs + i * kStride;
    const float* gi = gs + i * kStride;
    const int j0 = max(i - window, 0), j1 = min(i + window, t - 1);
    float m = -INFINITY;
    for (int j = j0; j <= j1; ++j)
      m = fmaxf(m, dot<D>(qi, ks + j * kStride) + bs[j - i + window]);
    float l = 0.f, pdp = 0.f;
    for (int j = j0; j <= j1; ++j) {
      const float p = expf(dot<D>(qi, ks + j * kStride) + bs[j - i + window] - m);
      l += p;
      pdp = fmaf(p, dot<D>(gi, vs + j * kStride), pdp);
    }
    const float inv = 1.f / l, delta = pdp * inv;
    float acc[D];
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] = 0.f;
    for (int j = j0; j <= j1; ++j) {
      const float* kj = ks + j * kStride;
      const float p = expf(dot<D>(qi, kj) + bs[j - i + window] - m) * inv;
      const float ds = rounded<T, kRound>(p * (dot<D>(gi, vs + j * kStride) - delta));
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(ds, kj[d], acc[d]);
    }
    row_max[i] = m;
    row_inv_sum[i] = inv;
    row_delta[i] = delta;
    const size_t row = base + (size_t)i * hd;
#pragma unroll
    for (int d = 0; d < D; ++d) dq[row + d] = from_f32<T>(acc[d]);
  }
  __syncthreads();

  // phase 2: key rows -> dk and dv
  for (int j = threadIdx.x; j < t; j += blockDim.x) {
    const float* kj = ks + j * kStride;
    const float* vj = vs + j * kStride;
    const int i0 = max(j - window, 0), i1 = min(j + window, t - 1);
    float dk_acc[D], dv_acc[D];
#pragma unroll
    for (int d = 0; d < D; ++d) dk_acc[d] = dv_acc[d] = 0.f;
    for (int i = i0; i <= i1; ++i) {
      const float* qi = qs + i * kStride;
      const float* gi = gs + i * kStride;
      const float p = expf(dot<D>(qi, kj) + bs[j - i + window] - row_max[i]) *
                      row_inv_sum[i];
      const float ds = rounded<T, kRound>(p * (dot<D>(gi, vj) - row_delta[i]));
      const float pr = rounded<T, kRound>(p);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dk_acc[d] = fmaf(ds, qi[d], dk_acc[d]);
        dv_acc[d] = fmaf(pr, gi[d], dv_acc[d]);
      }
    }
    const size_t row = base + (size_t)j * hd;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      dk[row + d] = from_f32<T>(dk_acc[d]);
      dv[row + d] = from_f32<T>(dv_acc[d]);
    }
  }

  // phase 3: this block's share of the bias-vector gradient, one diagonal
  // (key row i + r - w) per thread, from the f32 ds
  if (dbias_partial == nullptr) return;
  for (int r = threadIdx.x; r < nbias; r += blockDim.x) {
    const int off = r - window;
    const int i0 = max(0, -off), i1 = min(t - 1, t - 1 - off);
    float acc = 0.f;
    for (int i = i0; i <= i1; ++i) {
      const float* qi = qs + i * kStride;
      const float* gi = gs + i * kStride;
      const int j = i + off;
      const float p = expf(dot<D>(qi, ks + j * kStride) + bs[r] - row_max[i]) * row_inv_sum[i];
      acc = fmaf(p, dot<D>(gi, vs + j * kStride) - row_delta[i], acc);
    }
    dbias_partial[((size_t)n * heads + h) * nbias + r] = acc;
  }
}

// Dynamic shared memory of a launch: q, g, k, v of the whole sequence as
// f32, three row statistics and the bias row.
template <int D>
size_t bwd_smem(int t, int window) {
  return (4 * (size_t)t * (D + 1) + 3 * (size_t)t + (2 * (size_t)window + 1)) * sizeof(float);
}

template <typename T, int D, bool kRound>
cudaError_t launch(const void* q, const void* k, const void* v, const void* g,
                   const void* bias, void* dq, void* dk, void* dv, void* dbias_partial,
                   int n, int t, int heads, int window, cudaStream_t stream) {
  const size_t smem = bwd_smem<D>(t, window);
  auto kernel = local_attn_packed_bwd_kernel<T, D, kRound>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int threads = min(kMaxT, (t + 31) / 32 * 32);
  const dim3 grid(n, heads);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), static_cast<const float*>(bias), static_cast<T*>(dq),
      static_cast<T*>(dk), static_cast<T*>(dv), static_cast<float*>(dbias_partial), t, heads,
      window);
  return cudaGetLastError();
}

}  // namespace

extern "C" int dawn_local_attn_packed_bwd(const void* q, const void* k, const void* v,
                                          const void* g, const void* bias, void* dq,
                                          void* dk, void* dv, void* dbias_partial, int n,
                                          int t, int heads, int dim_head, int window,
                                          int is_bf16, void* stream) {
  if (dim_head != 32 || t < 1 || t > kMaxT || window < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch<__nv_bfloat16, 32, true>(q, k, v, g, bias, dq, dk, dv,
                                                         dbias_partial, n, t, heads, window, s)
                       : launch<float, 32, false>(q, k, v, g, bias, dq, dk, dv,
                                                  dbias_partial, n, t, heads, window, s));
}

extern "C" int dawn_local_attn_max_window(int kernel, int t, int is_bf16, int with_bias_grad) {
  (void)is_bf16;          // both stage f32 rows
  (void)with_bias_grad;   // the partials live in device memory
  if (kernel != 2 || t < 1 || t > kMaxT) return -1;
  return dawn_limits::max_window([t](int w) { return bwd_smem<32>(t, w); });
}
