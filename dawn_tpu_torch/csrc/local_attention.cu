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
// p.v accumulated in f32 registers, stored in the input dtype. In f32 the
// row sum divides p.v once at the end. In bf16 (K3 only) the TPU's K3 rounds
// the normalised P to bf16 before P.V (dawn_tpu/ops/local_attention.py:
// 149-152), so the first walk keeps the row max and the row sum rescaled as
// the max grows (one exp a key), and the second rounds p = exp(s - m) / l to
// bf16 before p.v, with no division at the end (the kRoundP flag). Unlike
// the TPU's K3 (left, center and right key tiles of bq >= w rows each,
// masked), the staged rows are exactly the band's, so any w that fits shared
// memory works ((2*(128+2w)*33 + 2w+1)*4 B <= 227 KB: w <= 370 at long T;
// the wrapper asks dawn_local_attn_max_window and raises past it). (N*H, tiles)
// go on gridDim.x and y: 256^2 at T=400 has 32768 (n, h) pairs. This body
// runs on the CUDA cores (no mma), one shared-memory load per FMA; it serves
// K3 and f32 K1 and K5.
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
// bf16 K1 and K5 run the tensor-core body (attn_fwd_mma_kernel, packed
// layout); K3 and f32 K1 and K5 keep the CUDA-core body. The C entries
// dispatch on is_bf16. K1 clamps the band to the keys that exist: with
// w_eff = min(w, T - 1), [i - w_eff, i + w_eff] cut to [0, T) holds the same
// keys as [i - w, i + w], and the kernel reads the bias entries [w - w_eff,
// w + w_eff] of each head's row (bias_ld = 2w + 1 apart), so K1 takes any w
// and stage 1's w = 20 at T = 20 walks 19 keys a side.
// What bounds bf16 K5: bytes. At rank 0 of the 2-rank split it must move
// 251.7 MB, 75 us, against about 7.6 GFLOP of tensor work
// even with each warp's band padded to whole k16 steps, under 10 us at the
// bf16 peak. The CUDA-core body cannot get near the bytes: one thread a
// query row, every score computed twice, one shared load per FMA.
// What the design does about it: a block owns one (sequence, head, tile of
// 64 query rows), 4 warps of 16 rows. It stages with 16-byte cp.async, in
// bf16, the query tile and the key/value rows of the tile's band, zeros
// past [kmin, kmax]; a warp's band is 16 + 2w keys in k16 steps (96 at w =
// 40). S = Q K^T and O = P V run on mma.sync m16n8k16 with ldmatrix
// fragments (mma_bf16.cuh); S's C fragments, packed to bf16, are P V's A
// fragments, so P never leaves registers. The T5 bias is added by diagonal
// from shared memory, out-of-band and masked keys get -inf (weight exactly
// 0). The softmax is online over chunks of 32 keys, so registers do not
// grow with w. P is rounded to bf16 before P V, as the TPU kernel rounds it
// (p.astype(v.dtype)); the f32 row sum divides the output once. Blocks are
// numbered tile-fastest, so the tiles of one (sequence, head), whose bands
// share 2w key rows, run side by side and meet those rows in L2.
// mma.sync and not wgmma: the kernel is bytes-bound with tensor throughput
// to spare, and wgmma's 64-row tiles would make a warpgroup cover a
// 64 + 2w = 144-key band where four 16-row warps need 96 keys each.
// Any w with (64 + 2 * staged_rows(w, 4)) * 80 B + (2w + 1) * 4 B <= 227 KB
// works: w <= 656 for K5, any w for K1 (w_eff <= 255). Rows that all fit
// in 32 (stage 1's T = 20) take blocks of 2 warps (tile_warps), so no warp
// idles and twice as many blocks fit an SM.
//
// C interface (bound with ctypes):
//   int dawn_local_attn_packed_fwd(q, k, v, bias, out, n, t, heads, dim_head,
//                                  window, is_bf16, stream)      K1, (N, T, H*D)
//   int dawn_local_attn_tiled_fwd(q, k, v, bias, out, n, t, heads, dim_head,
//                                 window, is_bf16, stream)       K3, (N, H, T, D)
//   int dawn_local_attn_stripe_fwd(q, k, v, bias, out, n, t_loc, heads,
//                                  dim_head, window, left_edge, right_edge,
//                                  is_bf16, stream)             K5, q (N, t_loc, H*D),
//                                                               k, v (N, t_loc + 2w, H*D);
//   (K1 and K5: bf16 on tensor cores)
// each returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a dim_head it was not built for;
//   int dawn_local_attn_max_window(kernel, t, is_bf16, with_bias_grad)
// returns the largest window that kernel 1, 3 or 5 takes at T = t (K5: t_loc)
// on the current device, INT_MAX for no limit, -1 for another kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "mma_bf16.cuh"
#include "smem_limit.cuh"

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
// grid (N*H, tiles). kRoundP: the normalised P rounded to T before P.V.
template <typename T, int D, bool kPacked, bool kRoundP>
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

  if (kRoundP) {
    // walk 1: the row max m and the row sum l, rescaled when m grows
    float m = -INFINITY, l = 0.f;
    for (int j = j0; j <= j1; ++j) {
      const float s = score(j);
      if (s > m) {
        l = fmaf(l, expf(m - s), 1.f);
        m = s;
      } else {
        l += expf(s - m);
      }
    }
    // walk 2: p = exp(s - m) / l rounded to T, then p.v
    const float inv = 1.f / l;
    for (int j = j0; j <= j1; ++j) {
      const float p = to_f32(from_f32<T>(expf(score(j) - m) * inv));
      const float* vrow = vs + (j - k0) * kStride;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(p, vrow[d], acc[d]);
    }
#pragma unroll
    for (int d = 0; d < D; ++d) out[row + d] = from_f32<T>(acc[d]);
    return;
  }
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
  for (int d = 0; d < D; ++d) out[row + d] = from_f32<T>(acc[d] * inv);
}

// Dynamic shared memory of a CUDA-core launch over seq_k key rows: the key
// and value rows one tile's band touches, as f32, and the bias row.
template <int D>
size_t fwd_smem(int seq_k, int window) {
  const size_t rows = min(seq_k, kQueryTile + 2 * window);
  return (2 * rows * (D + 1) + (2 * (size_t)window + 1)) * sizeof(float);
}

template <typename T, int D, bool kPacked, bool kRoundP>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias,
                   void* out, int n, int seq_q, KeyRange kr, int heads, int window,
                   cudaStream_t stream) {
  const size_t smem = fwd_smem<D>(kr.seq_k, window);
  auto kernel = local_attn_fwd_kernel<T, D, kPacked, kRoundP>;
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

// The running state of a warp's 16 query rows in the tensor-core body: the
// output accumulator (C fragments of 4 n8 tiles over d), the row max and
// this lane's share of the row sum.
struct RowState {
  float o[4][4];
  float m[2], l[2];
};

// One chunk of NT n8 key tiles at band offset c0 of a warp (its band's key
// rows kw, vw in shared memory, band offset 0 at key row key_w): scores and
// bias, the online max and sum, then P V.
template <int NT>
__device__ __forceinline__ void fwd_chunk(RowState& st, const uint32_t (&qa)[2][4],
                                          const __nv_bfloat16* kw, const __nv_bfloat16* vw,
                                          const float* bs, int c0, int key_w, int kmin,
                                          int kmax, int nbias, int lane) {
  using namespace dawn_mma;
  const int g = lane >> 2, t = lane & 3;
  float s[NT][4];
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    mma_dot(s[j], qa, kw, c0 + 8 * j, lane);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      // row g + 8 (r / 2), band offset off: bias entry off - row
      const int off = c0 + 8 * j + 2 * t + (r & 1), idx = off - g - 8 * (r >> 1);
      const int key = key_w + off;
      const bool ok = idx >= 0 && idx < nbias && key >= kmin && key <= kmax;
      s[j][r] = ok ? s[j][r] + bs[ok ? idx : 0] : -INFINITY;
      mx[r >> 1] = fmaxf(mx[r >> 1], s[j][r]);
    }
  }
  float base[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float m_new = fmaxf(st.m[hh], quad_max(mx[hh]));
    base[hh] = m_new == -INFINITY ? 0.f : m_new;   // a row with no key yet
    const float corr = exp2f((st.m[hh] - base[hh]) * kLog2e);
    st.m[hh] = m_new;
    st.l[hh] *= corr;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      st.o[n][2 * hh] *= corr;
      st.o[n][2 * hh + 1] *= corr;
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      s[j][r] = exp2f((s[j][r] - base[r >> 1]) * kLog2e);
      st.l[r >> 1] += s[j][r];
    }
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) {
    uint32_t pa[4];
    pack_a(pa, s[2 * i], s[2 * i + 1]);   // P rounded to bf16
    mma_rows(st.o, pa, vw, c0 + 16 * i, lane);
  }
}

// The tensor-core body, bf16, packed (N, T, H*D) layout: one block of kWarps
// warps per (sequence, head, 64-row query tile), numbered tile-fastest
// (kWarps = 2 when seq_q <= 32). Head h's 2w+1 bias entries start at bias +
// h * bias_ld.
template <int kWarps>
__global__ void __launch_bounds__(32 * kWarps)
attn_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
                    int bias_ld, __nv_bfloat16* __restrict__ out, int seq_q, KeyRange kr,
                    int heads, int window, int tiles) {
  using namespace dawn_mma;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int rows_q = 16 * kWarps;
  const int staged = staged_rows(window, kWarps), nbias = 2 * window + 1;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // rows_q x kLd
  __nv_bfloat16* ks = qs + rows_q * kLd;                              // staged x kLd
  __nv_bfloat16* vs = ks + staged * kLd;
  float* bs = reinterpret_cast<float*>(vs + staged * kLd);

  const int nh = blockIdx.x / tiles, tile = blockIdx.x % tiles, h = nh % heads;
  const int q0 = tile * 64, nq = min(64, seq_q - q0);
  const int kb = q0 + kr.key_off - window;          // the key row at shared row 0
  // row r of this (sequence, head) is at base + r * ld
  const size_t ld = (size_t)heads * kDim, seq = nh / heads, head_off = (size_t)h * kDim;
  const __nv_bfloat16* qg = q + seq * seq_q * ld + head_off;
  __nv_bfloat16* og = out + seq * seq_q * ld + head_off;
  const size_t k_base = seq * kr.seq_k * ld + head_off;
  stage_rows(qs, qg, ld, q0, rows_q, q0, q0 + nq - 1);
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
  const __nv_bfloat16* kw = ks + 16 * warp * kLd;   // the warp's band: rows [0, nk)
  const __nv_bfloat16* vw = vs + 16 * warp * kLd;
  const int key_w = kb + 16 * warp, nk = band_rows(window);

  RowState st = {{}, {-INFINITY, -INFINITY}, {0.f, 0.f}};
  int c0 = 0;
  for (; c0 + 32 <= nk; c0 += 32)
    fwd_chunk<4>(st, qa, kw, vw, bs, c0, key_w, kr.kmin, kr.kmax, nbias, lane);
  if (c0 < nk)   // nk is a multiple of 16
    fwd_chunk<2>(st, qa, kw, vw, bs, c0, key_w, kr.kmin, kr.kmax, nbias, lane);

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float inv = 1.f / quad_sum(st.l[hh]);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      st.o[n][2 * hh] *= inv;
      st.o[n][2 * hh + 1] *= inv;
    }
  }
  store_rows(og, ld, q0 + 16 * warp, nq - 16 * warp, st.o, qs + 16 * warp * kLd, lane);
}

// Dynamic shared memory of a tensor-core launch of `warps` warps: the query
// tile, the band's key and value rows in bf16, and the bias row.
size_t mma_smem(int window, int warps) {
  return (16 * warps + 2 * (size_t)dawn_mma::staged_rows(window, warps)) * dawn_mma::kLd *
             sizeof(__nv_bfloat16) +
         (2 * (size_t)window + 1) * sizeof(float);
}

cudaError_t launch_mma(const void* q, const void* k, const void* v, const float* bias,
                       int bias_ld, void* out, int n, int seq_q, KeyRange kr, int heads,
                       int window, cudaStream_t stream) {
  const int warps = dawn_mma::tile_warps(seq_q);
  const size_t smem = mma_smem(window, warps);
  auto kernel = warps == 2 ? attn_fwd_mma_kernel<2> : attn_fwd_mma_kernel<4>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles = (seq_q + 63) / 64;
  const long long blocks = (long long)n * heads * tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, 32 * warps, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), bias, bias_ld,
      static_cast<__nv_bfloat16*>(out), seq_q, kr, heads, window, tiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" int dawn_local_attn_packed_fwd(const void* q, const void* k, const void* v,
                                          const void* bias, void* out, int n, int t,
                                          int heads, int dim_head, int window,
                                          int is_bf16, void* stream) {
  if (dim_head != 32 || window < 0 || t < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const KeyRange kr{t, 0, 0, t - 1};
  if (!is_bf16)
    return (int)launch<float, 32, true, false>(q, k, v, bias, out, n, t, kr, heads, window, s);
  const int w_eff = min(window, t - 1);   // the same keys, the bias entries [w - w_eff, ...]
  const float* b = bias != nullptr ? static_cast<const float*>(bias) + (window - w_eff) : nullptr;
  return (int)launch_mma(q, k, v, b, 2 * window + 1, out, n, t, kr, heads, w_eff, s);
}

extern "C" int dawn_local_attn_tiled_fwd(const void* q, const void* k, const void* v,
                                         const void* bias, void* out, int n, int t,
                                         int heads, int dim_head, int window,
                                         int is_bf16, void* stream) {
  if (dim_head != 32 || window < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const KeyRange kr{t, 0, 0, t - 1};
  return (int)(is_bf16 ? launch<__nv_bfloat16, 32, false, true>(q, k, v, bias, out, n, t, kr,
                                                                 heads, window, s)
                       : launch<float, 32, false, false>(q, k, v, bias, out, n, t, kr, heads,
                                                         window, s));
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
    return (int)launch<float, 32, true, false>(q, k, v, bias, out, n, t_loc, kr, heads,
                                               window, s);
  return (int)launch_mma(q, k, v, static_cast<const float*>(bias), 2 * window + 1, out, n,
                         t_loc, kr, heads, window, s);
}

extern "C" int dawn_local_attn_max_window(int kernel, int t, int is_bf16, int with_bias_grad) {
  (void)with_bias_grad;   // a forward computes no bias gradient
  using dawn_limits::max_window;
  if (t < 1) return -1;
  switch (kernel) {
    case 1:
      return is_bf16 ? max_window([t](int w) {
                         return mma_smem(min(w, t - 1), dawn_mma::tile_warps(t));
                       })
                     : max_window([t](int w) { return fwd_smem<32>(t, w); });
    case 3:
      return max_window([t](int w) { return fwd_smem<32>(t, w); });
    case 5:
      return is_bf16 ? max_window([t](int w) { return mma_smem(w, dawn_mma::tile_warps(t)); })
                     : max_window([t](int w) { return fwd_smem<32>(t + 2 * w, w); });
    default:
      return -1;
  }
}
