// K1, K3 and K5: windowed temporal attention, forward.
//
// K1 replaces dawn_tpu/ops/local_attention.py::_local_attn_packed_kernel (the
// Pallas TPU body launched by local_attention_packed) on the packed (N, T,
// H*D) layout, T <= 256. K3 replaces _local_attn_tile_kernel (the body
// launched by local_attention_pallas) on the (N, H, T, D) layout, any T. Both
// run the one body below, templated on the layout: for every sequence n,
// head h and query i it computes
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
// What the design does about it: one pass over q, k, v and out. A block
// owns one (sequence, head, tile of kQueryTile queries); it stages only the
// key/value rows the tile's band touches, [q0-w, q1-1+w] cut to [0, T), in
// shared memory as f32, builds the bias from the (H, 2w+1) vector in shared
// memory, and writes no score, probability or bias tensor to device memory.
// One thread owns one query row: scores, the row max and the row sum in f32,
// p.v accumulated in f32 registers, divided by the row sum once at the end,
// stored in the input dtype. Unlike the TPU's K3 (left, center and right key
// tiles of bq >= w rows each, masked), the staged rows are exactly the band's,
// so any w that fits shared memory works (2*(128+2w)*33*4 B <= 227 KB: w <=
// 376). (N*H, tiles) go on gridDim.x and y: 256^2 at T=400 has 32768 (n, h)
// pairs. No tensor cores yet (mma/wgmma, TMA and pipelining are later work).
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
// haloed k, v (94.4 MB each): 293.6 MB, about 88 us at 3.35 TB/s.
//
// All three run one body: a query row i sees the key rows j in
// [i + key_off - w, i + key_off + w] cut to [kmin, kmax], with the bias
// entry j - key_off - i + w. K1 and K3: key_off 0, keys [0, T). K5: key_off
// w, keys [w or 0, w + t_loc - 1 or t_loc + 2w - 1] by the edge flags.
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
// cudaErrorInvalidValue for a dim_head it was not built for.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kQueryTile = 128;  // query rows per block, one thread each

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The key rows a block reads: seq_k rows of which [kmin, kmax] are valid,
// query row i's band centred on key row i + key_off.
struct KeyRange {
  int seq_k, key_off, kmin, kmax;
};

// kPacked: the (N, T, H*D) layout, grid (N, H, tiles); else (N, H, T, D),
// grid (N*H, tiles).
template <typename T, int D, bool kPacked>
__global__ void __launch_bounds__(kQueryTile)
local_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ bias,
                      T* __restrict__ out, int seq_q, KeyRange kr, int heads,
                      int window) {
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
    ks[r * kStride + d] = to_f32(k[g]);
    vs[r * kStride + d] = to_f32(v[g]);
  }
  for (int e = threadIdx.x; e < nbias; e += blockDim.x)
    bs[e] = bias != nullptr ? bias[(size_t)h * nbias + e] : 0.f;
  __syncthreads();

  const int i = q0 + threadIdx.x;
  if (i >= q1) return;
  const size_t row = q_base + (size_t)i * hd;
  float qr[D];
#pragma unroll
  for (int d = 0; d < D; ++d) qr[d] = to_f32(q[row + d]);
  const int c = i + kr.key_off;    // the key row at offset 0
  const int j0 = max(c - window, kr.kmin), j1 = min(c + window, kr.kmax);

  // pass 1: the row max of the in-band scores
  float m = -INFINITY;
  for (int j = j0; j <= j1; ++j) {
    const float* krow = ks + (j - k0) * kStride;
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) s = fmaf(qr[d], krow[d], s);
    m = fmaxf(m, s + bs[j - c + window]);
  }
  // pass 2: exp, row sum and p.v
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float l = 0.f;
  for (int j = j0; j <= j1; ++j) {
    const float* krow = ks + (j - k0) * kStride;
    const float* vrow = vs + (j - k0) * kStride;
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) s = fmaf(qr[d], krow[d], s);
    const float p = expf(s + bs[j - c + window] - m);
    l += p;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] = fmaf(p, vrow[d], acc[d]);
  }
  const float inv = 1.f / l;
#pragma unroll
  for (int d = 0; d < D; ++d) out[row + d] = from_f32<T>(acc[d] * inv);
}

template <typename T, int D, bool kPacked>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias,
                   void* out, int n, int seq_q, KeyRange kr, int heads, int window,
                   cudaStream_t stream) {
  const int rows_max = min(kr.seq_k, kQueryTile + 2 * window);
  const size_t smem =
      (2 * (size_t)rows_max * (D + 1) + (2 * (size_t)window + 1)) * sizeof(float);
  auto kernel = local_attn_fwd_kernel<T, D, kPacked>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles = (seq_q + kQueryTile - 1) / kQueryTile;
  const dim3 grid = kPacked ? dim3(n, heads, tiles) : dim3(n * heads, tiles);
  kernel<<<grid, kQueryTile, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), static_cast<T*>(out), seq_q, kr, heads, window);
  return cudaGetLastError();
}

template <bool kPacked>
int launch_any(const void* q, const void* k, const void* v, const void* bias, void* out,
               int n, int seq_q, KeyRange kr, int heads, int dim_head, int window,
               int is_bf16, void* stream) {
  if (dim_head != 32 || window < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16
      ? launch<__nv_bfloat16, 32, kPacked>(q, k, v, bias, out, n, seq_q, kr, heads, window, s)
      : launch<float, 32, kPacked>(q, k, v, bias, out, n, seq_q, kr, heads, window, s));
}

}  // namespace

extern "C" int dawn_local_attn_packed_fwd(const void* q, const void* k, const void* v,
                                          const void* bias, void* out, int n, int t,
                                          int heads, int dim_head, int window,
                                          int is_bf16, void* stream) {
  return launch_any<true>(q, k, v, bias, out, n, t, KeyRange{t, 0, 0, t - 1}, heads,
                          dim_head, window, is_bf16, stream);
}

extern "C" int dawn_local_attn_tiled_fwd(const void* q, const void* k, const void* v,
                                         const void* bias, void* out, int n, int t,
                                         int heads, int dim_head, int window,
                                         int is_bf16, void* stream) {
  return launch_any<false>(q, k, v, bias, out, n, t, KeyRange{t, 0, 0, t - 1}, heads,
                           dim_head, window, is_bf16, stream);
}

extern "C" int dawn_local_attn_stripe_fwd(const void* q, const void* k, const void* v,
                                          const void* bias, void* out, int n, int t_loc,
                                          int heads, int dim_head, int window,
                                          int left_edge, int right_edge, int is_bf16,
                                          void* stream) {
  const int seq_k = t_loc + 2 * window;
  const KeyRange kr{seq_k, window, left_edge ? window : 0,
                    right_edge ? window + t_loc - 1 : seq_k - 1};
  return launch_any<true>(q, k, v, bias, out, n, t_loc, kr, heads, dim_head, window,
                          is_bf16, stream);
}
