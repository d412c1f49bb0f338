// Blocked matmul and small-batch GEMV with float32 accumulators, for
// Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernels
// kernels/relic_matmul.py::relic_matmul (_matmul_kernel) and
// kernels/relic_matmul.py::relic_gemv (_gemv_kernel).
//
// What they compute: x [M,K] @ w [K,N] -> [M,N] in x's type (float32 or
// bfloat16, w the same), every product summed in float32 and rounded once
// at the end, as jnp.dot(..., preferred_element_type=float32).astype does.
// Any M, N, K: ragged edges are masked here. The wrappers keep the JAX
// functions' block-divisibility contract; the tiles below do not depend on
// the caller's bm / bk / bn.
//
// What bounds them on the H100:
// - relic_matmul at prefill sizes (M ~ 1k tokens): operations. This first
//   version runs them on the CUDA cores in float32 (67 TFLOP/s peak), not
//   on the tensor cores (989 TFLOP/s bf16), so in bf16 it sits far below
//   its bound; wgmma tiles fed by TMA are the step for speed.
// - relic_gemv (B of 1-8 decode rows): bytes. Every weight is read once and
//   used for B rows, far below the ~295 operations per byte at which the
//   tensor cores would become the limit, so the design only has to stream
//   w at the memory rate.
//
// Design, matmul: the Pallas grid (M/bm, N/bn, K/bk) with K sequential
// becomes one thread block per 128x128 output tile that loops over K in
// 16-deep slices. The Relic pair (DMA of the next block while the MXU
// contracts this one) becomes two shared-memory buffers: each thread
// issues its global loads for slice k+1 into registers, multiplies slice k
// out of shared memory, then stores slice k+1 into the other buffer, one
// barrier a slice. 256 threads each own an 8x8 block of outputs (two 4x4
// quads per dimension, so a warp's shared-memory reads are conflict-free).
//
// Design, GEMV: one thread block per 128-column panel of w (32 lanes x 4
// adjacent columns, one 8- or 16-byte load a lane) and per slice of K.
// Its 8 warps take interleaved rows of w, so a block streams 8 whole panel
// rows at a time; x is staged in shared memory 256 columns at a time (at
// zamba2's K = 10240, x of 8 rows is 320 KB in float32, more than an SM
// holds) and read as a broadcast. The 8 warps' partial sums meet in shared
// memory. When N gives too few panels to fill 132 SMs, K is split across
// blocks as well: each split writes float32 partials to a workspace and a
// second kernel sums them in a fixed order and rounds once. B is looped in
// groups of 8 rows, re-reading w for each group.
#include <stdint.h>

#include "attention_tile.cuh"

using repro_attn::from_f;
using repro_attn::launch;
using repro_attn::to_f;

namespace {

constexpr int MM_BM = 128, MM_BN = 128, MM_BK = 16, MM_THREADS = 256;
constexpr int MM_LOADS = MM_BM * MM_BK / MM_THREADS;  // 8 (and MM_BK * MM_BN / MM_THREADS)

template <typename T>
__device__ __forceinline__ void mm_fetch(const T* __restrict__ x, const T* __restrict__ w,
                                         int M, int N, int K, int m0, int n0, int k0,
                                         float (&ra)[MM_LOADS], float (&rb)[MM_LOADS]) {
#pragma unroll
  for (int i = 0; i < MM_LOADS; ++i) {
    const int e = i * MM_THREADS + threadIdx.x;
    const int am = m0 + e / MM_BK, ak = k0 + e % MM_BK;
    ra[i] = (am < M && ak < K) ? to_f(x[(size_t)am * K + ak]) : 0.f;
    const int bk = k0 + e / MM_BN, bn = n0 + e % MM_BN;
    rb[i] = (bk < K && bn < N) ? to_f(w[(size_t)bk * N + bn]) : 0.f;
  }
}

__device__ __forceinline__ void mm_stash(float (&As)[MM_BK][MM_BM + 4],
                                         float (&Bs)[MM_BK][MM_BN],
                                         const float (&ra)[MM_LOADS],
                                         const float (&rb)[MM_LOADS]) {
#pragma unroll
  for (int i = 0; i < MM_LOADS; ++i) {
    const int e = i * MM_THREADS + threadIdx.x;
    As[e % MM_BK][e / MM_BK] = ra[i];
    Bs[e / MM_BN][e % MM_BN] = rb[i];
  }
}

template <typename T>
__global__ void __launch_bounds__(MM_THREADS)
    matmul_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
                  int M, int N, int K) {
  // x's slice is stored transposed (k-major) so a thread reads its rows as
  // float4; the pad of 4 breaks the stride-128 bank pattern of the stores
  __shared__ __align__(16) float As[2][MM_BK][MM_BM + 4];
  __shared__ __align__(16) float Bs[2][MM_BK][MM_BN];
  const int m0 = blockIdx.y * MM_BM, n0 = blockIdx.x * MM_BN;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float ra[MM_LOADS], rb[MM_LOADS];
  mm_fetch(x, w, M, N, K, m0, n0, 0, ra, rb);
  mm_stash(As[0], Bs[0], ra, rb);
  __syncthreads();

  for (int k0 = 0, cur = 0; k0 < K; k0 += MM_BK, cur ^= 1) {
    const bool more = k0 + MM_BK < K;
    if (more) mm_fetch(x, w, M, N, K, m0, n0, k0 + MM_BK, ra, rb);
#pragma unroll
    for (int kk = 0; kk < MM_BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[cur][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[cur][kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    // the other buffer's readers all passed the last barrier
    if (more) mm_stash(As[cur ^ 1], Bs[cur ^ 1], ra, rb);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (n < N) out[(size_t)m * N + n] = from_f<T>(acc[i][j]);
    }
  }
}

constexpr int GV_THREADS = 256, GV_WARPS = GV_THREADS / 32;
constexpr int GV_ROWS = 8;                 // rows of x per pass over w
constexpr int GV_COLS = 4;                 // adjacent columns a lane owns
constexpr int GV_PANEL = 32 * GV_COLS;     // 128 columns a thread block
constexpr int GV_KC = 256;                 // columns of x staged at a time

template <typename T>
__device__ __forceinline__ void load4(const T* p, float (&v)[GV_COLS]);
template <>
__device__ __forceinline__ void load4<float>(const float* p, float (&v)[GV_COLS]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
}
template <>
__device__ __forceinline__ void load4<__nv_bfloat16>(const __nv_bfloat16* p,
                                                     float (&v)[GV_COLS]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
  for (int j = 0; j < GV_COLS; ++j) v[j] = __bfloat162float(h[j]);
}

// vec: N is a multiple of 4 and w is aligned for 4-value loads.
template <typename T>
__global__ void __launch_bounds__(GV_THREADS)
    gemv_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
                float* __restrict__ ws, int B, int K, int N, int k_per_split, int vec) {
  __shared__ float xs[GV_ROWS][GV_KC];
  __shared__ float red[GV_WARPS][GV_ROWS][GV_PANEL];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * GV_PANEL + lane * GV_COLS;
  const int split = blockIdx.y;
  const int kb = split * k_per_split, ke = min(K, kb + k_per_split);
  const bool full = vec && n0 + GV_COLS <= N;

  for (int r0 = 0; r0 < B; r0 += GV_ROWS) {
    const int rows = min(GV_ROWS, B - r0);
    float acc[GV_ROWS][GV_COLS];
#pragma unroll
    for (int r = 0; r < GV_ROWS; ++r)
#pragma unroll
      for (int j = 0; j < GV_COLS; ++j) acc[r][j] = 0.f;

    for (int c0 = kb; c0 < ke; c0 += GV_KC) {
      const int clen = min(GV_KC, ke - c0);
      __syncthreads();  // the previous chunk's readers are done with xs
      for (int i = threadIdx.x; i < GV_ROWS * GV_KC; i += GV_THREADS) {
        const int r = i / GV_KC, kk = i - r * GV_KC;
        xs[r][kk] = (r < rows && kk < clen) ? to_f(x[(size_t)(r0 + r) * K + c0 + kk]) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = warp; kk < clen; kk += GV_WARPS) {
        const T* wr = w + (size_t)(c0 + kk) * N;
        float wv[GV_COLS];
        if (full) {
          load4(wr + n0, wv);
        } else {
#pragma unroll
          for (int j = 0; j < GV_COLS; ++j) wv[j] = n0 + j < N ? to_f(wr[n0 + j]) : 0.f;
        }
#pragma unroll
        for (int r = 0; r < GV_ROWS; ++r) {
          const float xv = xs[r][kk];
#pragma unroll
          for (int j = 0; j < GV_COLS; ++j) acc[r][j] = fmaf(xv, wv[j], acc[r][j]);
        }
      }
    }

#pragma unroll
    for (int r = 0; r < GV_ROWS; ++r)
#pragma unroll
      for (int j = 0; j < GV_COLS; ++j) red[warp][r][lane * GV_COLS + j] = acc[r][j];
    __syncthreads();
    for (int i = threadIdx.x; i < GV_ROWS * GV_PANEL; i += GV_THREADS) {
      const int r = i / GV_PANEL, c = i - r * GV_PANEL;
      const int n = blockIdx.x * GV_PANEL + c;
      if (r >= rows || n >= N) continue;
      float s = 0.f;
#pragma unroll
      for (int v = 0; v < GV_WARPS; ++v) s += red[v][r][c];
      const size_t o = (size_t)(r0 + r) * N + n;
      if (gridDim.y == 1)
        out[o] = from_f<T>(s);
      else
        ws[(size_t)split * B * N + o] = s;
    }
    __syncthreads();  // red is rewritten by the next row group
  }
}

// out = sum over splits of ws[split], in split order, rounded once.
template <typename T>
__global__ void gemv_combine_kernel(const float* __restrict__ ws, T* __restrict__ out,
                                    int splits, size_t n_out) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n_out;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int sp = 0; sp < splits; ++sp) s += ws[sp * n_out + i];
    out[i] = from_f<T>(s);
  }
}

template <typename T>
int gemv_typed(const void* x, const void* w, void* out, void* ws, int B, int K, int N,
               int splits, void* stream) {
  const int k_per_split = (K + splits - 1) / splits;
  const int vec = N % GV_COLS == 0 &&
                  reinterpret_cast<uintptr_t>(w) % (GV_COLS * sizeof(T)) == 0;
  const dim3 grid((N + GV_PANEL - 1) / GV_PANEL, splits);
  int err = launch<GV_THREADS>(gemv_kernel<T>, grid, 0, stream, static_cast<const T*>(x),
                               static_cast<const T*>(w), static_cast<T*>(out),
                               static_cast<float*>(ws), B, K, N, k_per_split, vec);
  if (err || splits == 1) return err;
  const size_t n_out = (size_t)B * N;
  const int blocks = (int)((n_out + 255) / 256 < 4096 ? (n_out + 255) / 256 : 4096);
  return launch<256>(gemv_combine_kernel<T>, dim3(blocks), 0, stream,
                     static_cast<const float*>(ws), static_cast<T*>(out), splits, n_out);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w and out). Returns a cudaError_t
// (0 = launched).
extern "C" int relic_matmul(int dtype, const void* x, const void* w, void* out, int M,
                            int N, int K, void* stream) {
  const dim3 grid((N + MM_BN - 1) / MM_BN, (M + MM_BM - 1) / MM_BM);
  if (dtype == 0)
    return launch<MM_THREADS>(matmul_kernel<float>, grid, 0, stream,
                              static_cast<const float*>(x), static_cast<const float*>(w),
                              static_cast<float*>(out), M, N, K);
  if (dtype == 1)
    return launch<MM_THREADS>(matmul_kernel<__nv_bfloat16>, grid, 0, stream,
                              static_cast<const __nv_bfloat16*>(x),
                              static_cast<const __nv_bfloat16*>(w),
                              static_cast<__nv_bfloat16*>(out), M, N, K);
  return (int)cudaErrorInvalidValue;
}

// dtype as above. splits > 1 splits K across thread blocks and needs a
// float32 workspace ws of splits * B * N values (ignored when splits == 1).
extern "C" int relic_gemv(int dtype, const void* x, const void* w, void* out, void* ws,
                          int B, int K, int N, int splits, void* stream) {
  if (splits < 1 || (splits > 1 && ws == nullptr)) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return gemv_typed<float>(x, w, out, ws, B, K, N, splits, stream);
  if (dtype == 1) return gemv_typed<__nv_bfloat16>(x, w, out, ws, B, K, N, splits, stream);
  return (int)cudaErrorInvalidValue;
}
