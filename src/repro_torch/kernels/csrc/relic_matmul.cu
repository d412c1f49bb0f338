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
// Any M; the wrappers keep the JAX functions' block-divisibility contract,
// and the tiles below do not depend on the caller's bm / bk / bn.
//
// What bounds them on the H100:
// - relic_matmul at prefill sizes (M ~ 1k tokens): operations. At
//   smollm's (1024, 576, 1536) the 1.8 GFLOP take 1.8 us at the bf16
//   tensor-core peak (989 TFLOP/s) against 1.4 us to move the 5 MB, and at
//   zamba2's (1024, 2560, 10240) 54 GFLOP take 54 us against 23 us.
// - relic_gemv (B of 1-8 decode rows): bytes. Every weight is read once and
//   used for B rows, far below the ~295 operations per byte at which the
//   tensor cores would become the limit, so the design only has to stream
//   w at the memory rate.
//
// Design, bf16 matmul (matmul_kernel_wgmma): only wgmma reaches the
// tensor cores' bf16 rate, so the products run there, fed by TMA. One
// thread block per 128 x BN output tile; the Pallas grid's sequential K
// axis becomes a ring of 4 shared-memory stages of 64-deep slices (x's
// [128 x 64] K-major and w's [64 x BN] N-major, both 128-byte swizzled).
// One producer thread keeps TMA loads in flight; two consumer warpgroups
// each own 64 rows and run m64nBNk16 wgmma on every stage that has landed
// (w with the transpose bit), releasing a stage once the wgmma that read
// it have completed; setmaxnreg moves registers from the producer
// warpgroup to the consumers. The epilogue rounds the float32
// accumulators to bf16 and stores them, masked at ragged M and N; TMA
// fills loads past an edge with zeros, so a ragged K adds nothing. TMA
// needs 16-byte row strides, so K and N must be multiples of 8 (the
// wrapper raises otherwise). Blocks walk M fastest, so the blocks in
// flight share w's column tiles in L2 (zamba2's w is 52 MB, more than L2
// holds). Tile width (kernels/relic_matmul.py::matmul_plan): BN = 128
// when the 128 x 128 tiles fill the 132 SMs (zamba2's 640), else BN = 64
// with two blocks an SM (smollm's 1536 columns give 96 tiles of 128 x 128
// but 192 of 128 x 64); chip_smoke.py times both widths at both shapes.
// K is never split: that would need a second launch, or atomics whose
// order changes the bf16 rounding.
//
// Design, float32 matmul (matmul_kernel): stays on the CUDA cores.
// wgmma's float32 inputs are TF32, which keeps about three decimal digits;
// the float32 contract (chip_smoke.py's MATMUL_TOL of 1e-5 of the largest
// output, float32 token parity in serving) needs full float32 products.
// The Pallas grid becomes one thread block per 128x128 output tile that
// loops over K in 16-deep slices, double-buffered in shared memory: each
// thread issues its global loads for slice k+1 into registers, multiplies
// slice k, then stores slice k+1 into the other buffer, one barrier a
// slice. 256 threads each own an 8x8 block of outputs (two 4x4 quads per
// dimension, so a warp's shared-memory reads are conflict-free).
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
#include "hopper.cuh"

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

// ---------------------------------------------------------------------------
// bf16: TMA-fed wgmma

constexpr int WG_BM = 128, WG_BK = 64, WG_STAGES = 4;
constexpr int WG_THREADS = 384;  // warpgroup 0 the producer, 1-2 the consumers
constexpr int WG_A_BYTES = WG_BM * WG_BK * 2;  // x's [128 x 64] slice
constexpr int WG_B_CHUNK = WG_BK * 64 * 2;     // one [64 x 64] box of w

template <int BN>
struct WgCfg;  // blocks an SM, and the producer's / consumers' registers
template <>
struct WgCfg<128> {
  static constexpr int kBlocks = 1, kProducerRegs = 40, kConsumerRegs = 232;
};
template <>
struct WgCfg<64> {
  static constexpr int kBlocks = 2, kProducerRegs = 24, kConsumerRegs = 104;
};

template <int BN>
__host__ __device__ constexpr int wg_stage_bytes() { return WG_A_BYTES + WG_BK * BN * 2; }
template <int BN>
__host__ __device__ constexpr size_t wg_smem_bytes() {  // + 1 KB to align the ring to 1024 bytes
  return 1024 + (size_t)WG_STAGES * wg_stage_bytes<BN>() + 2 * WG_STAGES * sizeof(uint64_t);
}

template <int BN>
__device__ __forceinline__ void mm_wgmma(float (&acc)[BN / 2], uint64_t da, uint64_t db,
                                         int accumulate) {
  if constexpr (BN == 128)
    hopper::wgmma_ss_n128<1>(acc, da, db, accumulate);
  else
    hopper::wgmma_ss_n64<1>(acc, da, db, accumulate);
}

template <int BN>
__global__ void __launch_bounds__(WG_THREADS, WgCfg<BN>::kBlocks)
    matmul_kernel_wgmma(const __grid_constant__ CUtensorMap xmap,
                        const __grid_constant__ CUtensorMap wmap,
                        __nv_bfloat16* __restrict__ out, int M, int N, int K) {
  using namespace hopper;
  constexpr int STAGE = wg_stage_bytes<BN>();
  extern __shared__ __align__(1024) uint8_t wg_smem[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(wg_smem) + 1023) &
                                             ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + WG_STAGES * STAGE);
  uint64_t* empty = full + WG_STAGES;
  const int m0 = blockIdx.x * WG_BM, n0 = blockIdx.y * BN;
  const int nk = (K + WG_BK - 1) / WG_BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrive, plus the TMA bytes
      mbar_init(&empty[s], 8);  // one arrive from each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {  // producer: one thread issues every load
    setmaxnreg_dec<WgCfg<BN>::kProducerRegs>();
    if (threadIdx.x == 0) {
      for (int kb = 0; kb < nk; ++kb) {
        const int s = kb % WG_STAGES;
        mbar_wait(&empty[s], ((kb / WG_STAGES) & 1) ^ 1);
        uint8_t* a = smem + s * STAGE;
        mbar_arrive_expect_tx(&full[s], STAGE);
        tma_load_2d(a, &xmap, &full[s], kb * WG_BK, m0);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load_2d(a + WG_A_BYTES + j * WG_B_CHUNK, &wmap, &full[s], n0 + 64 * j, kb * WG_BK);
      }
    }
  } else {  // consumers: warpgroup c owns rows 64c .. 64c + 63 of the tile
    setmaxnreg_inc<WgCfg<BN>::kConsumerRegs>();
    const int c = wg - 1;
    // no zero-fill: the first slice's wgmma overwrites (scale-d 0), so no
    // ordinary instruction writes an accumulator while wgmma are in flight
    // (ptxas would serialize them)
    float acc[BN / 2];
    for (int kb = 0; kb < nk; ++kb) {
      const int s = kb % WG_STAGES;
      mbar_wait(&full[s], (kb / WG_STAGES) & 1);
      uint8_t* a = smem + s * STAGE;
      // x: K-major, rows of 128 bytes, 8-row groups 1024 bytes apart.
      // w: N-major, [64 K-rows x 64 N] boxes 8 KB apart (LBO), 8-row
      // groups of K 1024 bytes apart (SBO).
      const uint64_t da = make_desc(a + c * 64 * 128, 16, 1024, SW128);
      const uint64_t db = make_desc(a + WG_A_BYTES, WG_B_CHUNK, 1024, SW128);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WG_BK / 16; ++kk)
        mm_wgmma<BN>(acc, desc_advance(da, 32 * kk), desc_advance(db, 16 * 128 * kk),
                     kb > 0 || kk > 0);
      wgmma_commit();
      // the previous stage's products are done once at most this one is
      // in flight: hand that stage back to the producer
      wgmma_wait<1>();
      fence_regs(acc);
      if (kb > 0 && threadIdx.x % 32 == 0) mbar_arrive(&empty[(kb - 1) % WG_STAGES]);
    }
    wgmma_wait<0>();
    fence_regs(acc);

    const int w = (threadIdx.x % 128) / 32, l = threadIdx.x % 32;
    const int r0 = m0 + 64 * c + 16 * w + l / 4;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int col = n0 + 8 * i + 2 * (l % 4);
      if (col >= N) continue;  // N is even, so col + 1 < N too
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + 8 * h;
        if (row < M)
          *reinterpret_cast<uint32_t*>(out + (size_t)row * N + col) =
              pack_bf16(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
      }
    }
  }
}

int matmul_wgmma(const void* x, const void* w, void* out, int M, int N, int K, int bn,
                 void* stream) {
  if ((bn != 64 && bn != 128) || K % 8 || N % 8 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return (int)cudaErrorInvalidValue;
  CUtensorMap xmap, wmap;
  const uint64_t xdims[2] = {(uint64_t)K, (uint64_t)M}, xstride[1] = {(uint64_t)K * 2};
  const uint32_t xbox[2] = {WG_BK, WG_BM};
  int err = hopper::encode_tma(&xmap, x, 2, xdims, xstride, xbox, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  const uint64_t wdims[2] = {(uint64_t)N, (uint64_t)K}, wstride[1] = {(uint64_t)N * 2};
  const uint32_t wbox[2] = {64, WG_BK};
  err = hopper::encode_tma(&wmap, w, 2, wdims, wstride, wbox, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  auto* o = static_cast<__nv_bfloat16*>(out);
  if (bn == 128)
    return launch<WG_THREADS>(matmul_kernel_wgmma<128>,
                              dim3((M + WG_BM - 1) / WG_BM, (N + 127) / 128),
                              wg_smem_bytes<128>(), stream, xmap, wmap, o, M, N, K);
  return launch<WG_THREADS>(matmul_kernel_wgmma<64>, dim3((M + WG_BM - 1) / WG_BM, (N + 63) / 64),
                            wg_smem_bytes<64>(), stream, xmap, wmap, o, M, N, K);
}

// ---------------------------------------------------------------------------
// GEMV

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

// dtype: 0 = float32 (x, w and out), on the CUDA cores; 1 = bfloat16, on
// wgmma with BN-wide tiles (bn = 64 or 128; K and N multiples of 8, x and
// w 16-byte aligned). Returns a cudaError_t (0 = launched), or
// hopper::TMA_REFUSED + the driver's CUresult for a refused TMA descriptor.
extern "C" int relic_matmul(int dtype, const void* x, const void* w, void* out, int M,
                            int N, int K, int bn, void* stream) {
  if (dtype == 0)
    return launch<MM_THREADS>(matmul_kernel<float>,
                              dim3((N + MM_BN - 1) / MM_BN, (M + MM_BM - 1) / MM_BM), 0, stream,
                              static_cast<const float*>(x), static_cast<const float*>(w),
                              static_cast<float*>(out), M, N, K);
  if (dtype == 1) return matmul_wgmma(x, w, out, M, N, K, bn, stream);
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
