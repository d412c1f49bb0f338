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
// needs 16-byte row strides, so K and N must be multiples of 8 and x
// and w 16-byte aligned (the wrapper's plan sends other bf16 operands to
// the CUDA-core kernel). Blocks walk M fastest, so the blocks in
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
// Design, bf16 matmul off TMA's strides (K or N not a multiple of 8, or
// x or w not 16-byte aligned): the CUDA-core matmul_kernel below, the
// same template as float32's, loading element by element; the bf16
// values are widened to float32 and the sum rounded once.
//
// Design, GEMV (gemv_kernel; float32 and bf16 alike). It streams w, so
// what it needs is enough bytes in flight to cover the memory latency
// (~3.35 TB/s x ~1 us / 132 SMs ~ 25 KB per SM, more under load), in long
// contiguous pieces, and consumers that keep up. One thread block per
// (P-column panel of w, split of K, group of up to 8 rows of x), P = 256
// bf16 or 128 float32 columns, so a panel row is 512 bytes. w arrives by
// TMA, one [32 rows x P] box (16 KB) a stage, into a ring of 3-6 stages
// sized to ~110 KB of shared memory with x's buffers, so two blocks share
// an SM (kernels/relic_matmul.py::gemv_plan); one producer thread fills
// it and 8 consumer warps drain it through full / empty mbarriers, so the
// loads in flight never drain for a barrier. A consumer warp reads a whole
// panel row with one 16-byte shared-memory load a lane (conflict-free)
// and multiplies it into kRows x (16 / sizeof(T)) float32 accumulators,
// against x's values as float32 in shared memory: x arrives by TMA too,
// 512 rows of K at a time into two buffers, and the consumers turn each
// chunk into float32 [k][row] behind their own named barrier while the
// producer keeps loading. The ring is addressed as an offset from the
// shared array, so every access compiles to a shared-memory load (through
// a generic pointer the compiler lost the address space, and the loads
// were slower). Splits: 1 to 8 blocks share a panel's K as one
// thread-block cluster, chosen for the most blocks per resident wave;
// each block sums its 8 warps' partials in warp order, then rank 0 sums
// the blocks' partials in split order over distributed shared memory and
// rounds once, so one launch needs no workspace and the result does not
// depend on timing. No tensor cores: at 8 rows a weight is used 8 times,
// ~4 operations a byte; at B = 8 the 64 float32 FMAs a lane does per
// panel row make the consumers, not the memory, the limit (PERF.md). Where
// TMA cannot take w or x (N or K not a multiple of 16 / sizeof(T), an
// operand not 16-byte aligned) the consumers load both from global memory
// themselves, element by element, with the same reduction.
#include <cooperative_groups.h>
#include <stdint.h>

#include "attention_tile.cuh"
#include "hopper.cuh"

using repro_attn::from_f;
using repro_attn::launch;
using repro_attn::to_f;
using repro_attn::unpack16;

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

constexpr int GV_CONSUMERS = 8;                      // consumer warps
constexpr int GV_THREADS = 32 * (GV_CONSUMERS + 1);  // + the producer warp
constexpr int GV_ROW_BYTES = 512;                    // a panel row: 32 lanes x 16 bytes
constexpr int GV_KT = 32;                            // rows of w a stage, 4 a consumer warp
constexpr int GV_STAGE_BYTES = GV_KT * GV_ROW_BYTES;  // 16 KB, one TMA box
constexpr int GV_MAX_STAGES = 24;
constexpr int GV_XCHUNK = 512;                       // rows of x (of K) staged at a time
constexpr int GV_XBOX = 256;                         // K extent of one TMA box of x (the most)

// Shared memory: the ring of `stages` stages of GV_KT rows of w, x as float32
// [GV_XCHUNK][rows], two buffers of x as it arrives (boxes [rows][GV_XBOX]), then
// the barriers; + 1 KB to align the ring. The kernel reuses the ring for
// its reduction, which needs GV_CONSUMERS * rows * P floats (64 KB at 8
// rows).
template <typename T>
__host__ __device__ constexpr size_t gv_smem_bytes(int rows, int stages) {
  return 1024 + (size_t)stages * GV_STAGE_BYTES + (size_t)GV_XCHUNK * rows * sizeof(float) +
         2 * (size_t)GV_XCHUNK * rows * sizeof(T) + (2 * stages + 4) * sizeof(uint64_t);
}

// the consumer warps' own barrier (the producer warp never waits on it)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * GV_CONSUMERS) : "memory");
}

// One thread block per (P-column panel of w, split of K, group of kRows
// rows of x); the splits of a panel form one cluster. kTma: w and x
// arrive by TMA; otherwise (N, K or an operand's alignment refuses TMA's
// 16-byte strides) the consumers load both from global memory themselves.
template <typename T, int kRows, bool kTma>
__global__ void __launch_bounds__(GV_THREADS, 2)
    gemv_kernel(const __grid_constant__ CUtensorMap wmap, const __grid_constant__ CUtensorMap xmap,
                const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out, int B,
                int K, int N, int k_per_split, int stages) {
  using namespace hopper;
  constexpr int VEC = 16 / sizeof(T), P = 32 * VEC;
  constexpr int XBOX_BYTES = GV_XBOX * kRows * sizeof(T);
  constexpr int XBYTES = GV_XCHUNK * kRows * sizeof(T);  // one chunk of x: two TMA boxes
  constexpr int CHUNK_STAGES = GV_XCHUNK / GV_KT;
  extern __shared__ __align__(1024) uint8_t gv_smem[];
  // the ring on a 1024-byte boundary, by an offset from the shared array
  // (not through an integer), so the compiler keeps every access to it a
  // shared-memory one (LDS) and not a generic one
  uint8_t* ring = gv_smem + ((1024 - (hopper::smem_u32(gv_smem) & 1023)) & 1023);
  float* xs = reinterpret_cast<float*>(ring + stages * GV_STAGE_BYTES);  // [k][kRows]
  uint8_t* xraw = reinterpret_cast<uint8_t*>(xs + GV_XCHUNK * kRows);  // 2 x [box][kRows][GV_XBOX]
  uint64_t* full = reinterpret_cast<uint64_t*>(xraw + 2 * XBYTES);
  uint64_t* empty = full + stages;
  uint64_t* xfull = empty + stages;  // [2]
  uint64_t* xempty = xfull + 2;      // [2]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = blockIdx.x * P, r0 = blockIdx.z * kRows;
  const int rows = min(kRows, B - r0);
  const int kb = blockIdx.y * k_per_split, ke = min(K, kb + k_per_split);
  const int nst = ke > kb ? (ke - kb + GV_KT - 1) / GV_KT : 0;
  const int nchunks = (nst + CHUNK_STAGES - 1) / CHUNK_STAGES;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);              // the producer's arrive, plus the TMA bytes
      mbar_init(&empty[s], GV_CONSUMERS);  // one arrive from each consumer warp
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&xfull[i], 1);
      mbar_init(&xempty[i], GV_CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == GV_CONSUMERS) {  // producer: one thread keeps the ring full
    if (kTma && lane == 0) {
      auto load_x = [&](int c) {  // chunk c of this split's x into buffer c % 2
        mbar_arrive_expect_tx(&xfull[c % 2], XBYTES);
        for (int h = 0; h < GV_XCHUNK / GV_XBOX; ++h)
          tma_load_2d(xraw + (c % 2) * XBYTES + h * XBOX_BYTES, &xmap, &xfull[c % 2],
                      kb + c * GV_XCHUNK + h * GV_XBOX, r0);
      };
      for (int c = 0; c < 2 && c < nchunks; ++c) load_x(c);
      for (int t = 0; t < nst; ++t) {
        // halfway through chunk c - 1, chunk c - 2's buffer has long been
        // turned into float32 (the consumers run at most a ring, at most
        // 1.5 chunks, behind)
        const int c = t / CHUNK_STAGES + 1;
        if (t % CHUNK_STAGES == CHUNK_STAGES / 2 && c >= 2 && c < nchunks) {
          mbar_wait(&xempty[c % 2], ((c - 2) / 2) & 1);
          load_x(c);
        }
        const int s = t % stages;
        mbar_wait(&empty[s], ((t / stages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], GV_STAGE_BYTES);
        tma_load_2d(ring + s * GV_STAGE_BYTES, &wmap, &full[s], n0, kb + t * GV_KT);
      }
    }
  } else {  // consumers: warp c takes rows c, c + 8, ... of every stage
    float acc[kRows][VEC];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[r][j] = 0.f;

    for (int t = 0; t < nst; ++t) {
      const int k0 = kb + t * GV_KT, xrow = (t % CHUNK_STAGES) * GV_KT;
      if (xrow == 0) {  // x's rows k0 .. k0 + GV_XCHUNK - 1 of this split, as float32
        const int c = t / CHUNK_STAGES;
        consumers_sync();  // the previous chunk's readers are done
        if constexpr (kTma) {
          mbar_wait(&xfull[c % 2], (c / 2) & 1);
          const T* raw = reinterpret_cast<const T*>(xraw + (c % 2) * XBYTES);
          for (int i = threadIdx.x; i < GV_XCHUNK * kRows; i += 32 * GV_CONSUMERS) {
            const int r = i % kRows, k = i / kRows;
            xs[i] = to_f(raw[(k / GV_XBOX) * kRows * GV_XBOX + r * GV_XBOX + k % GV_XBOX]);
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(&xempty[c % 2]);  // the buffer may be refilled
        } else {
          for (int i = threadIdx.x; i < GV_XCHUNK * kRows; i += 32 * GV_CONSUMERS) {
            const int r = i % kRows, k = k0 + i / kRows;
            xs[i] = (r < rows && k < ke) ? to_f(x[(size_t)(r0 + r) * K + k]) : 0.f;
          }
        }
        consumers_sync();
      }
      const int s = t % stages;
      if constexpr (kTma) mbar_wait(&full[s], (t / stages) & 1);
#pragma unroll
      for (int i = 0; i < GV_KT / GV_CONSUMERS; ++i) {
        const int kk = warp + GV_CONSUMERS * i;
        float wv[VEC];
        if constexpr (kTma) {
          unpack16<T>(*reinterpret_cast<const uint4*>(ring + s * GV_STAGE_BYTES +
                                                      kk * GV_ROW_BYTES + lane * 16),
                      wv);
        } else {
          const int k = k0 + kk, n = n0 + lane * VEC;
          const T* wr = w + (size_t)k * N + n;
#pragma unroll
          for (int j = 0; j < VEC; ++j) wv[j] = (k < ke && n + j < N) ? to_f(wr[j]) : 0.f;
        }
        float xv[kRows];
        const float* xr = xs + (xrow + kk) * kRows;  // 16-byte aligned when kRows >= 4
        if constexpr (kRows % 4 == 0) {
#pragma unroll
          for (int r = 0; r < kRows; r += 4) {
            const float4 v4 = *reinterpret_cast<const float4*>(xr + r);
            xv[r] = v4.x, xv[r + 1] = v4.y, xv[r + 2] = v4.z, xv[r + 3] = v4.w;
          }
        } else {
#pragma unroll
          for (int r = 0; r < kRows; ++r) xv[r] = xr[r];
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc[r][j] = fmaf(xv[r], wv[j], acc[r][j]);
      }
      if constexpr (kTma) {  // this warp's reads of stage s are done
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
      }
    }

    // the block's partial sums: the 8 warps' in warp order, into warp 0's
    // slot of the (now idle) ring
    consumers_sync();
    float* red = reinterpret_cast<float*>(ring);  // [warp][kRows][P]
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int j = 0; j < VEC; ++j) red[(warp * kRows + r) * P + lane * VEC + j] = acc[r][j];
    consumers_sync();
    for (int e = threadIdx.x; e < kRows * P; e += 32 * GV_CONSUMERS) {
      float sum = red[e];
#pragma unroll
      for (int v = 1; v < GV_CONSUMERS; ++v) sum += red[v * kRows * P + e];
      red[e] = sum;
    }
  }

  // rank 0 of the cluster sums the splits' partials in split order, over
  // distributed shared memory, and rounds once; the second cluster barrier
  // keeps every block's shared memory alive until rank 0 has read it
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (cluster.block_rank() == 0 && warp < GV_CONSUMERS) {
    float* red = reinterpret_cast<float*>(ring);
    const int splits = (int)gridDim.y;  // the cluster spans the grid's y
    for (int e = threadIdx.x; e < kRows * P; e += 32 * GV_CONSUMERS) {
      const int r = e / P, c = n0 + e % P;
      if (r >= rows || c >= N) continue;
      float part[8];  // all the splits' loads in flight at once, then summed in order
#pragma unroll
      for (int q = 0; q < 8; ++q) part[q] = q < splits ? cluster.map_shared_rank(red, q)[e] : 0.f;
      float sum = 0.f;
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (q < splits) sum += part[q];
      out[(size_t)(r0 + r) * N + c] = from_f<T>(sum);
    }
  }
  cluster.sync();
}

template <typename T, int kRows, bool kTma>
int gemv_launch(const CUtensorMap& wmap, const CUtensorMap& xmap, const void* x, const void* w,
                void* out, int B, int K, int N, int splits, int k_per_split, int stages,
                void* stream) {
  constexpr int P = 32 * (16 / sizeof(T));
  const dim3 grid((N + P - 1) / P, splits, (B + kRows - 1) / kRows);
  return hopper::launch_cluster(gemv_kernel<T, kRows, kTma>, grid, dim3(1, splits, 1),
                                GV_THREADS, gv_smem_bytes<T>(kRows, stages), stream, wmap, xmap,
                                static_cast<const T*>(x), static_cast<const T*>(w),
                                static_cast<T*>(out), B, K, N, k_per_split, stages);
}

template <typename T>
int gemv_typed(const void* x, const void* w, void* out, int B, int K, int N, int rows,
               int splits, int stages, int tma, void* stream) {
  constexpr int VEC = 16 / sizeof(T), P = 32 * VEC;
  // the reduction reuses the ring (GV_CONSUMERS * rows * P floats); the
  // producer may run 1.5 chunks of x ahead of the consumers, no more
  if (splits < 1 || splits > 8 || B < 1 || K < 1 || N < 1 || stages > GV_MAX_STAGES ||
      stages > 3 * GV_XCHUNK / GV_KT / 2 ||
      (size_t)stages * GV_STAGE_BYTES < (size_t)GV_CONSUMERS * rows * P * sizeof(float))
    return (int)cudaErrorInvalidValue;
  const int k_per_split = ((K + splits - 1) / splits + GV_KT - 1) / GV_KT * GV_KT;
  CUtensorMap wmap{}, xmap{};
  if (tma) {
    if (N % VEC || K % VEC || reinterpret_cast<uintptr_t>(w) % 16 ||
        reinterpret_cast<uintptr_t>(x) % 16)
      return (int)cudaErrorInvalidValue;
    const CUtensorMapDataType type =
        sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    const uint64_t wdims[2] = {(uint64_t)N, (uint64_t)K}, wstride[1] = {(uint64_t)N * sizeof(T)};
    const uint32_t wbox[2] = {(uint32_t)P, GV_KT};
    int err = hopper::encode_tma(&wmap, w, 2, wdims, wstride, wbox, CU_TENSOR_MAP_SWIZZLE_NONE,
                                 type);
    if (err) return err;
    const uint64_t xdims[2] = {(uint64_t)K, (uint64_t)B}, xstride[1] = {(uint64_t)K * sizeof(T)};
    const uint32_t xbox[2] = {GV_XBOX, (uint32_t)rows};
    err = hopper::encode_tma(&xmap, x, 2, xdims, xstride, xbox, CU_TENSOR_MAP_SWIZZLE_NONE, type);
    if (err) return err;
  }
#define REPRO_GEMV(R)                                                                         \
  (tma ? gemv_launch<T, R, true>(wmap, xmap, x, w, out, B, K, N, splits, k_per_split, stages, \
                                 stream)                                                      \
       : gemv_launch<T, R, false>(wmap, xmap, x, w, out, B, K, N, splits, k_per_split,        \
                                  stages, stream))
  switch (rows) {
    case 1: return REPRO_GEMV(1);
    case 2: return REPRO_GEMV(2);
    case 4: return REPRO_GEMV(4);
    case 8: return REPRO_GEMV(8);
  }
#undef REPRO_GEMV
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32 (x, w and out), 1 = bfloat16. wgmma: 1 = the bf16
// tensor-core kernel with BN-wide tiles (bn = 64 or 128; K and N multiples
// of 8, x and w 16-byte aligned; the wrapper's plan decides), 0 = the
// CUDA-core kernel (float32 always; bf16 where TMA cannot take the
// operands). Returns a cudaError_t (0 = launched), or hopper::TMA_REFUSED
// + the driver's CUresult for a refused TMA descriptor.
extern "C" int relic_matmul(int dtype, const void* x, const void* w, void* out, int M,
                            int N, int K, int bn, int wgmma, void* stream) {
  if (wgmma) return dtype == 1 ? matmul_wgmma(x, w, out, M, N, K, bn, stream)
                               : (int)cudaErrorInvalidValue;
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

// dtype as above. rows: the rows of x a block takes (1, 2, 4 or 8; B > 8
// runs groups of 8 over the grid's z); splits: blocks (one cluster) that
// share a panel's K, 1-8; stages: the ring's depth in 16 KB stages; tma:
// 1 = w and x arrive by TMA (N and K multiples of 16 / sizeof(T), x and w
// 16-byte aligned), 0 = the consumers load them themselves. The wrapper's
// plan (kernels/relic_matmul.py::gemv_plan) decides them all. Returns as
// relic_matmul.
extern "C" int relic_gemv(int dtype, const void* x, const void* w, void* out, int B, int K,
                          int N, int rows, int splits, int stages, int tma, void* stream) {
  if (dtype == 0)
    return gemv_typed<float>(x, w, out, B, K, N, rows, splits, stages, tma, stream);
  if (dtype == 1)
    return gemv_typed<__nv_bfloat16>(x, w, out, B, K, N, rows, splits, stages, tma, stream);
  return (int)cudaErrorInvalidValue;
}
