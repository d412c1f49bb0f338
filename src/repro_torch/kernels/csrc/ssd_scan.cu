// Mamba2 SSD chunked scan, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel kernels/ssd_scan.py::ssd_scan
// (_ssd_kernel), and adds what the serving prefill needs: the final state
// and sequences of any length.
//
// What it computes: xh [B,S,H,hd] (float32 or bfloat16); a, dt [B,S,H]
// float32; b, c [B,S,N] in xh's type, shared by all heads (n_groups = 1).
// Per chunk of Q positions, with the state S_prev [hd,N] carried between
// chunks (zero before the first):
//   la  = cumsum_i log(max(a_i, 1e-20))
//   att = causal(i >= j) * (c_i . b_j) * exp(clip(la_i - la_j, -60, 0)) * dt_j
//   y   = att x + exp(la_i) * (c_i . S_prev)
//   S   = exp(la_end) S_prev + sum_j (x_j dt_j exp(clip(la_end - la_j, -60, 0))) (x) b_j
// Outputs: y [B,S,H,hd] in xh's type, and the final state [B,H,hd,N] in
// float32 (the model's layout; the Pallas kernel keeps [N,hd] and throws it
// away).
//
// The clip. The JAX model path clips the state-update exponent to
// (-60, 60), the Pallas kernel to (-60, 0). They agree: a = exp(dt A) with
// A = -exp(A_log) < 0 and dt = softplus(.) > 0, so a <= 1, log a <= 0, la
// never increases along a chunk, and la_end - la_j <= 0.
//
// Ragged S. The Pallas kernel asserts S % Q == 0, and the JAX model path
// shrinks Q to a divisor of S (Q = 1 for a prime S). This kernel keeps Q
// and masks the last chunk: positions past S read x = b = c = dt = 0 and
// log a = 0, so they add nothing to y or the state, and la_end is the last
// real position's. Chunking is exact in exact arithmetic; only rounding
// differs from the divisor rule.
//
// What bounds it on the H100. At the serving prefill (B = 1, S = 1024,
// H = 32, hd = 64, N = 128, bf16) it moves ~9.8 MB (~2.9 us at 3.35 TB/s)
// and does ~2.7 GFLOP counted per head as the Pallas kernel does it
// (2Q^2 N + 2Q^2 hd + 4Q N hd per (head, chunk)); c.b alone, shared by all
// heads, would be 0.27 GFLOP. Memory and tensor-core time are of one
// order, so the design's aim is parallelism: the recurrence along S is
// the only serial part, and only the [N,hd] state has to cross it.
//
// Any N, hd and chunk. A chunk above 128 positions runs as sub-chunks of
// at most 128 (the carried state makes them the same scan); where b and c
// of a chunk of the full state width N do not fit in shared memory with
// the state slice, the plan shrinks the kernel's chunk (to a multiple of
// 16) until they do. Where 16 does not divide hd, the last column slice is
// padded: its columns past hd load as zeros and are never stored.
//
// Design. One thread block of 256 threads per (batch row, head, column
// slice of hd, run of chunks): the chunks of a (row, head, slice) are
// dealt in contiguous runs to the blocks of one thread-block cluster (a
// power of two, at most 8, at most one per chunk; one chunk a block up to
// S = 8Q), so at B = 1, S = 1024 the grid holds 256 blocks at mamba2's
// shape (H = 32) and 640 at zamba2's (H = 80). Column slices are 64 wide
// (32 or 16 where hd is not a multiple of 64), and the state slice
// [N, 64] stays in shared memory. Each block:
// 1. stages its chunk: b, x (one cp.async group) and c (a second group,
//    in flight while step 2 runs) in xh's type, rows padded by 16 bytes,
//    N padded to a multiple of 16 and rows past the chunk with zeros; warp
//    0 takes the cumsum of log a by a shuffle scan;
// 2. computes its run's local state, the recurrence from a zero state
//    over its chunks: sum_j (b_j w_j) (x) x_j per chunk, one warp per
//    16 x 16 tile of [N, slice], and its decay exp(sum of la_end);
// 3. meets the cluster: the state's elements are cut in one slice a rank;
//    rank q walks its slice of every rank's local state over distributed
//    shared memory in rank order, S = D_k S + local_k, replacing rank k's
//    local value by S_in of rank k as it passes: the same recurrence in
//    the same order as a sequential scan, one remote read and write an
//    element, no serial chain between blocks; the fold past the last rank
//    is the final state, which rank q writes for its slice;
// 4. computes y, one warp per 16 rows of the chunk: the inter-chunk term
//    exp(la_i) (c_i . S_in), then c.b for the rows' causal columns, att
//    from it in registers (the accumulator fragment of c.b is the operand
//    fragment of att.x, the k index permuted within each 8-wide block, so
//    att never goes through shared memory), and att.x added on top.
//    A block with a run of several chunks (S > 8Q) walks them again from
//    S_in, restaging each chunk and carrying the state between them.
// Products. bf16 inputs: c.b on bf16 mma.sync (m16n8k16, float32
// accumulators: every product exact); att.x, c.S and (b w)^T.x on TF32
// mma.sync (m16n8k8): their float32 operand (att, the state, b w) is
// rounded to TF32's 10-bit mantissa (2^-11 relative, 8x finer than bf16
// would round it), the bf16 operand is exact in TF32, and the sums stay
// float32. TF32 was chosen over bf16 because att and the state reach y
// after one product and a bf16 rounding of them would add a bf16 ulp of
// y on top of y's own rounding; the replay test of the port's tests
// (tests/test_torch_ops.py) shows TF32 well inside the chip's SSD_TOL.
// float32 inputs keep float32 products on the CUDA cores (TF32 would miss
// the float32 tolerance) in the same structure: each m16n8k8 becomes 32
// FMAs a lane on operands gathered from the same fragments by shuffles.
// One launch per call, no workspace.
#include <cooperative_groups.h>
#include <stdint.h>

#include <type_traits>

#include "attention_tile.cuh"
#include "hopper.cuh"

using repro_attn::from_f;
using repro_attn::round16;
using repro_attn::to_f;

namespace {

constexpr int THREADS = 256, WARPS = THREADS / 32;
constexpr int MAX_Q = 128, MAX_DS = 64;
constexpr int SMEM_OPT_IN = 232448;  // the H100's per-block shared memory with the opt-in

// Dynamic shared memory of a block (kernels/ssd_scan.py::ssd_layout
// mirrors it): b, c [QP][NP] and x [QP][ds] in xh's type, rows padded by
// 16 bytes (after a chunk's products, b, c and x hold its y [QP][ds] on
// its way out); the state slice [ds][NP + 4] float32, transposed; la, dt,
// w [QP]; the run's decay.
struct SsdLayout {
  int qp, np, bpitch, xpitch, spitch;  // rows, state width, row bytes (b/c, x), state row floats
  int b, c, x, s, la, dt, w, d, total;
};

__host__ __device__ inline SsdLayout ssd_layout(int Q, int N, int ds, int es) {
  SsdLayout L{};
  L.qp = round16(Q);
  L.np = round16(N);
  L.bpitch = L.np * es + 16;
  L.xpitch = ds * es + 16;
  L.spitch = L.np + 4;
  L.b = 0;
  L.c = L.b + L.qp * L.bpitch;
  L.x = L.c + L.qp * L.bpitch;
  L.s = L.x + L.qp * L.xpitch;
  L.la = L.s + 4 * ds * L.spitch;
  L.dt = L.la + 4 * L.qp;
  L.w = L.dt + 4 * L.qp;
  L.d = L.w + 4 * L.qp;
  L.total = L.d + 16;
  return L;
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero, as cvt.rna.tf32.f32 rounds (finite x), in two integer operations
// (a conversion instruction issues at a quarter of their rate)
__device__ __forceinline__ uint32_t tf32_round(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// d += A B for one 16 x 8 x 8 tile, operands in the m16n8k8 fragment
// layout (lane = 4 g + t: a = A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4];
// b = B[t][g], B[t+4][g]; d = D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1]).
// kTF32: the tensor cores; an operand of kExactA / kExactB is already a
// TF32 value (a bf16 input) and goes as it is, the other is rounded to
// TF32. Else float32 FMAs on the CUDA cores, k in order, the operands
// gathered by shuffles.
template <bool kTF32, bool kExactA = false, bool kExactB = false>
__device__ __forceinline__ void mma8(float (&d)[4], const float (&a)[4], const float (&b)[2]) {
  if constexpr (kTF32) {
    uint32_t ua[4], ub[2];
#pragma unroll
    for (int i = 0; i < 4; ++i) ua[i] = kExactA ? __float_as_uint(a[i]) : tf32_round(a[i]);
#pragma unroll
    for (int i = 0; i < 2; ++i) ub[i] = kExactB ? __float_as_uint(b[i]) : tf32_round(b[i]);
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
        "{%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(ua[0]), "r"(ua[1]), "r"(ua[2]), "r"(ua[3]), "r"(ub[0]), "r"(ub[1]));
  } else {
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int ka = g * 4 + (k & 3);
      const float a_lo = __shfl_sync(0xffffffffu, k < 4 ? a[0] : a[2], ka);
      const float a_hi = __shfl_sync(0xffffffffu, k < 4 ? a[1] : a[3], ka);
      const float b0 = __shfl_sync(0xffffffffu, k < 4 ? b[0] : b[1], 2 * t * 4 + (k & 3));
      const float b1 = __shfl_sync(0xffffffffu, k < 4 ? b[0] : b[1], (2 * t + 1) * 4 + (k & 3));
      d[0] = fmaf(a_lo, b0, d[0]);
      d[1] = fmaf(a_lo, b1, d[1]);
      d[2] = fmaf(a_hi, b0, d[2]);
      d[3] = fmaf(a_hi, b1, d[3]);
    }
  }
}

// d += A B for one 16 x 8 x 16 bf16 tile: a and b are pairs of bf16 in
// the m16n8k16 fragment layout
__device__ __forceinline__ void mma16_bf16(float (&d)[4], const uint32_t (&a)[4],
                                           const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename T>
__device__ __forceinline__ float ld(const uint8_t* row, int col) {
  return to_f(reinterpret_cast<const T*>(row)[col]);
}

template <typename T, bool kAsync>
__global__ void __launch_bounds__(THREADS)
    ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ a,
                    const T* __restrict__ b, const T* __restrict__ c,
                    const float* __restrict__ dt, T* __restrict__ y,
                    float* __restrict__ state_out, int S, int H, int hd, int N, int Q, int ds) {
  constexpr bool kTC = std::is_same<T, __nv_bfloat16>::value;  // tensor cores for bf16
  constexpr int ES = sizeof(T);
  extern __shared__ __align__(16) uint8_t dsm[];
  const SsdLayout L = ssd_layout(Q, N, ds, ES);
  uint8_t* sB = dsm + L.b;
  uint8_t* sC = dsm + L.c;
  uint8_t* sX = dsm + L.x;
  float* sS = reinterpret_cast<float*>(dsm + L.s);  // [ds][spitch]: S[n][d] at d * spitch + n
  float* sLa = reinterpret_cast<float*>(dsm + L.la);
  float* sDt = reinterpret_cast<float*>(dsm + L.dt);
  float* sW = reinterpret_cast<float*>(dsm + L.w);
  float* sD = reinterpret_cast<float*>(dsm + L.d);  // the run's decay

  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int rank = (int)blockIdx.x, ranks = (int)gridDim.x;  // the cluster spans the grid's x
  const int bh = blockIdx.y, bi = bh / H, h = bh - bi * H;
  const int d0 = blockIdx.z * ds;
  const int nc = (S + Q - 1) / Q, per = (nc + ranks - 1) / ranks;
  const int k_begin = min(nc, rank * per), k_end = min(nc, k_begin + per);

  // chunk k: b and x into one copy group, c into the next; rows past the
  // chunk and columns past N are zeros
  auto stage = [&](int k) {
    const int c0 = k * Q, n = min(Q, S - c0);
    const int bcols = N * ES / 16, bzero = (L.np - N) * ES / 16, xcols = ds * ES / 16;
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    for (int half = 0; half < 2; ++half) {  // b (with x), then c
      const T* src = half ? c : b;
      uint8_t* dst = half ? sC : sB;
      if constexpr (kAsync) {
        for (int i = tid; i < L.qp * (bcols + bzero); i += THREADS) {
          const int r = i / (bcols + bzero), q16 = i - r * (bcols + bzero);
          uint8_t* to = dst + r * L.bpitch + q16 * 16;
          if (r < n && q16 < bcols)
            hopper::cp_async16(to, src + ((size_t)bi * S + c0 + r) * N + q16 * (16 / ES));
          else
            *reinterpret_cast<uint4*>(to) = z;
        }
      } else {
        for (int i = tid; i < L.qp * L.np; i += THREADS) {
          const int r = i / L.np, col = i - r * L.np;
          reinterpret_cast<T*>(dst + r * L.bpitch)[col] =
              r < n && col < N ? src[((size_t)bi * S + c0 + r) * N + col] : from_f<T>(0.f);
        }
      }
      if (half == 0) {
        if constexpr (kAsync) {
          for (int i = tid; i < L.qp * xcols; i += THREADS) {
            const int r = i / xcols, q16 = i - r * xcols;
            uint8_t* to = sX + r * L.xpitch + q16 * 16;
            if (r < n && d0 + q16 * (16 / ES) < hd)  // a padded slice's columns past hd: zeros
              hopper::cp_async16(
                  to, x + (((size_t)bi * S + c0 + r) * H + h) * hd + d0 + q16 * (16 / ES));
            else
              *reinterpret_cast<uint4*>(to) = z;
          }
        } else {
          for (int i = tid; i < L.qp * ds; i += THREADS) {
            const int r = i / ds, col = i - r * ds;
            reinterpret_cast<T*>(sX + r * L.xpitch)[col] =
                r < n && d0 + col < hd ? x[(((size_t)bi * S + c0 + r) * H + h) * hd + d0 + col]
                                       : from_f<T>(0.f);
          }
        }
      }
      hopper::cp_async_commit();
    }
    if (warp == 0) {
      // inclusive cumsum of log a over the chunk: lane l owns positions
      // l * pl .. l * pl + pl - 1, then a shuffle scan of lane totals
      const int pl = (L.qp + 31) / 32;
      float run[MAX_Q / 32];
      float tot = 0.f;
#pragma unroll
      for (int r = 0; r < MAX_Q / 32; ++r) {
        const int i = lane * pl + r;
        float l = 0.f;
        if (r < pl && i < n) l = logf(fmaxf(a[((size_t)bi * S + c0 + i) * H + h], 1e-20f));
        tot += l;
        run[r] = tot;
      }
      float inc = tot;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += v;
      }
      float excl = __shfl_up_sync(0xffffffffu, inc, 1);
      if (lane == 0) excl = 0.f;
#pragma unroll
      for (int r = 0; r < MAX_Q / 32; ++r) {
        const int i = lane * pl + r;
        if (r < pl && i < L.qp) {
          sLa[i] = excl + run[r];
          sDt[i] = i < n ? dt[((size_t)bi * S + c0 + i) * H + h] : 0.f;
        }
      }
    }
    return n;
  };
  // w_j = dt_j exp(la_end - la_j), after the scan has landed
  auto weights = [&](int n) {
    const float la_end = sLa[n - 1];
    for (int j = tid; j < L.qp; j += THREADS)
      sW[j] = sDt[j] * expf(fminf(fmaxf(la_end - sLa[j], -60.f), 0.f));
    return la_end;
  };
  // S[n][d] = decay * S[n][d] + sum_j b[j][n] w_j x[j][d] (decay 0: S = the sum):
  // one warp per 16 x 16 tile of [np, ds], k over the chunk's rows
  auto local_state = [&](float decay) {
    const int dtiles = ds / 16, units = (L.np / 16) * dtiles;
    for (int u = warp; u < units; u += WARPS) {
      const int n0 = (u / dtiles) * 16, c0 = (u % dtiles) * 16;
      float acc[2][4] = {};
#pragma unroll 4
      for (int k0 = 0; k0 < L.qp; k0 += 8) {
        const float w0 = sW[k0 + t], w1 = sW[k0 + t + 4];
        const uint8_t* r0 = sB + (k0 + t) * L.bpitch;
        const uint8_t* r1 = sB + (k0 + t + 4) * L.bpitch;
        const float fa[4] = {ld<T>(r0, n0 + g) * w0, ld<T>(r0, n0 + g + 8) * w0,
                             ld<T>(r1, n0 + g) * w1, ld<T>(r1, n0 + g + 8) * w1};
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const float fb[2] = {ld<T>(sX + (k0 + t) * L.xpitch, c0 + 8 * nt + g),
                               ld<T>(sX + (k0 + t + 4) * L.xpitch, c0 + 8 * nt + g)};
          mma8<kTC, false, true>(acc[nt], fa, fb);  // b w rounded, x exact
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float* s = sS + (c0 + 8 * nt + 2 * t + (e & 1)) * L.spitch + n0 + g + 8 * (e / 2);
          *s = decay == 0.f ? acc[nt][e] : fmaf(decay, *s, acc[nt][e]);
        }
    }
  };

  // ---- pass 1: the run's local state and decay
  float log_decay = 0.f;
  if (k_begin == k_end)
    for (int i = tid; i < ds * L.spitch; i += THREADS) sS[i] = 0.f;
  for (int k = k_begin; k < k_end; ++k) {
    if (k > k_begin) {
      hopper::cp_async_wait<0>();
      __syncthreads();  // the last chunk's b, c and x are no longer read
    }
    const int n = stage(k);
    hopper::cp_async_wait<1>();  // b and x have landed; c may be in flight
    __syncthreads();
    const float la_end = weights(n);
    __syncthreads();
    local_state(k == k_begin ? 0.f : expf(la_end));
    log_decay += la_end;
  }
  if (tid == 0) *sD = expf(log_decay);
  __syncthreads();

  // ---- the cluster: rank q takes slice q of the state's elements and, for
  // each, walks the ranks in order: rank k's local value is read and
  // replaced, in rank k's shared memory, by S_in of rank k, the fold so far
  // (S = D_k S + local_k). Slices are disjoint, so no element is read by
  // one thread and written by another; the last fold is the final state.
  cluster.sync();  // every rank's local state and decay are published
  {
    float dr[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) dr[r] = r < ranks ? *cluster.map_shared_rank(sD, r) : 0.f;
    const int e4 = ds * L.np / 4, per4 = (e4 + ranks - 1) / ranks;
    for (int j = tid; j < per4 && rank * per4 + j < e4; j += THREADS) {
      const int i = 4 * (rank * per4 + j), d = i / L.np, n = i - d * L.np;
      float4 v[8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
        if (r < ranks)
          v[r] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(sS, r) + d * L.spitch + n);
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int r = 0; r < 8; ++r)
        if (r < ranks) {
          *reinterpret_cast<float4*>(cluster.map_shared_rank(sS, r) + d * L.spitch + n) = acc;
          acc = make_float4(fmaf(dr[r], acc.x, v[r].x), fmaf(dr[r], acc.y, v[r].y),
                            fmaf(dr[r], acc.z, v[r].z), fmaf(dr[r], acc.w, v[r].w));
        }
      const float f[4] = {acc.x, acc.y, acc.z, acc.w};
      float* o = state_out + ((size_t)bh * hd + d0 + d) * N + n;
#pragma unroll
      for (int q4 = 0; q4 < 4; ++q4)
        if (n + q4 < N && d0 + d < hd) o[q4] = f[q4];
    }
  }
  cluster.sync();  // every rank's S_in has landed
  __syncthreads();

  // ---- pass 2: y over the run, from S_in
  for (int k = k_begin; k < k_end; ++k) {
    const int c0 = k * Q;
    int n = min(Q, S - c0);
    if (k_end - k_begin > 1) {  // restage: the staged chunk is the run's last
      hopper::cp_async_wait<0>();
      __syncthreads();
      stage(k);
    }
    hopper::cp_async_wait<0>();
    __syncthreads();
    const float la_end = weights(n);
    __syncthreads();

    const int i0 = 16 * warp, ntd = ds / 8;
    float acc[MAX_DS / 8][4] = {};  // y [i0 + 16 rows][ds] in the accumulator layout
    if (i0 < n) {
      const int ntj = min(2 * warp + 2, L.qp / 8);
      const uint8_t* c_lo = sC + (i0 + g) * L.bpitch;
      const uint8_t* c_hi = sC + (i0 + g + 8) * L.bpitch;
      // inter-chunk: exp(la_i) (c_i . S_in)
#pragma unroll 2
      for (int k0 = 0; k0 < L.np; k0 += 8) {
        const float fa[4] = {ld<T>(c_lo, k0 + t), ld<T>(c_hi, k0 + t), ld<T>(c_lo, k0 + t + 4),
                             ld<T>(c_hi, k0 + t + 4)};
#pragma unroll
        for (int nt = 0; nt < MAX_DS / 8; ++nt)
          if (nt < ntd) {
            const float fb[2] = {sS[(8 * nt + g) * L.spitch + k0 + t],
                                 sS[(8 * nt + g) * L.spitch + k0 + t + 4]};
            mma8<kTC, true, false>(acc[nt], fa, fb);  // c exact, the state rounded
          }
      }
      const float e_lo = expf(sLa[i0 + g]), e_hi = expf(sLa[i0 + g + 8]);
#pragma unroll
      for (int nt = 0; nt < MAX_DS / 8; ++nt) {
        acc[nt][0] *= e_lo;
        acc[nt][1] *= e_lo;
        acc[nt][2] *= e_hi;
        acc[nt][3] *= e_hi;
      }
      // c.b over the causal columns j < i0 + 16
      float cb[MAX_Q / 8][4] = {};
      if constexpr (kTC) {
#pragma unroll 2
        for (int k0 = 0; k0 < L.np; k0 += 16) {
          const uint32_t fa[4] = {
              *reinterpret_cast<const uint32_t*>(c_lo + (k0 + 2 * t) * 2),
              *reinterpret_cast<const uint32_t*>(c_hi + (k0 + 2 * t) * 2),
              *reinterpret_cast<const uint32_t*>(c_lo + (k0 + 2 * t + 8) * 2),
              *reinterpret_cast<const uint32_t*>(c_hi + (k0 + 2 * t + 8) * 2)};
#pragma unroll
          for (int jt = 0; jt < MAX_Q / 8; ++jt)
            if (jt < ntj) {
              const uint8_t* br = sB + (8 * jt + g) * L.bpitch;
              const uint32_t fb[2] = {*reinterpret_cast<const uint32_t*>(br + (k0 + 2 * t) * 2),
                                      *reinterpret_cast<const uint32_t*>(br + (k0 + 2 * t + 8) * 2)};
              mma16_bf16(cb[jt], fa, fb);
            }
        }
      } else {
        for (int k0 = 0; k0 < L.np; k0 += 8) {
          const float fa[4] = {ld<T>(c_lo, k0 + t), ld<T>(c_hi, k0 + t),
                               ld<T>(c_lo, k0 + t + 4), ld<T>(c_hi, k0 + t + 4)};
#pragma unroll
          for (int jt = 0; jt < MAX_Q / 8; ++jt)
            if (jt < ntj) {
              const uint8_t* br = sB + (8 * jt + g) * L.bpitch;
              const float fb[2] = {ld<T>(br, k0 + t), ld<T>(br, k0 + t + 4)};
              mma8<false>(cb[jt], fa, fb);
            }
        }
      }
      // att in place, then y += att x with the k index of each 8-wide
      // block permuted: logical k = t, t + 4 are columns 2t, 2t + 1
      const float la_lo = sLa[i0 + g], la_hi = sLa[i0 + g + 8];
#pragma unroll
      for (int jt = 0; jt < MAX_Q / 8; ++jt)
        if (jt < ntj) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = i0 + g + 8 * (e / 2), j = 8 * jt + 2 * t + (e & 1);
            const float la_i = e < 2 ? la_lo : la_hi;
            cb[jt][e] = j <= i ? cb[jt][e] * expf(fminf(fmaxf(la_i - sLa[j], -60.f), 0.f)) * sDt[j]
                               : 0.f;
          }
          const float fa[4] = {cb[jt][0], cb[jt][2], cb[jt][1], cb[jt][3]};
          const uint8_t* x0 = sX + (8 * jt + 2 * t) * L.xpitch;
          const uint8_t* x1 = sX + (8 * jt + 2 * t + 1) * L.xpitch;
#pragma unroll
          for (int nt = 0; nt < MAX_DS / 8; ++nt)
            if (nt < ntd) {
              const float fb[2] = {ld<T>(x0, 8 * nt + g), ld<T>(x1, 8 * nt + g)};
              mma8<kTC, false, true>(acc[nt], fa, fb);  // att rounded, x exact
            }
        }
    }
    __syncthreads();  // b, c, x and the state are read
    if (k + 1 < k_end) {  // carry the state to the run's next chunk
      local_state(expf(la_end));
      __syncthreads();
    }
    // y through shared memory (b's place, rows of xpitch bytes), then out
    // in 16-byte stores
    if (i0 < n) {
#pragma unroll
      for (int nt = 0; nt < MAX_DS / 8; ++nt)
        if (nt < ntd)
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            T* row = reinterpret_cast<T*>(sB + (i0 + g + 8 * hi) * L.xpitch);
            row[8 * nt + 2 * t] = from_f<T>(acc[nt][2 * hi]);
            row[8 * nt + 2 * t + 1] = from_f<T>(acc[nt][2 * hi + 1]);
          }
    }
    __syncthreads();
    if constexpr (kAsync) {  // y's rows are 16-byte multiples: 16-byte stores
      const int ycols = ds * ES / 16;
      for (int i = tid; i < n * ycols; i += THREADS) {
        const int r = i / ycols, q16 = i - r * ycols;
        if (d0 + q16 * (16 / ES) < hd)
          *reinterpret_cast<uint4*>(y + (((size_t)bi * S + c0 + r) * H + h) * hd + d0 +
                                    q16 * (16 / ES)) =
              *reinterpret_cast<const uint4*>(sB + r * L.xpitch + q16 * 16);
      }
    } else {
      for (int i = tid; i < n * ds; i += THREADS) {
        const int r = i / ds, col = i - r * ds;
        if (d0 + col < hd)
          y[(((size_t)bi * S + c0 + r) * H + h) * hd + d0 + col] =
              reinterpret_cast<const T*>(sB + r * L.xpitch)[col];
      }
    }
  }
  hopper::cp_async_wait<0>();
}

template <typename T>
int ssd_typed(const void* x, const float* a, const void* b, const void* c, const float* dt,
              void* y, float* state, int B, int S, int H, int hd, int N, int Q, int ds,
              int cluster, int async, void* stream) {
  const SsdLayout L = ssd_layout(Q, N, ds, sizeof(T));
  if (L.total > SMEM_OPT_IN) return (int)cudaErrorInvalidValue;
  const dim3 grid(cluster, B * H, (hd + ds - 1) / ds);
#define REPRO_SSD_ARGS                                                                      \
  grid, dim3(cluster, 1, 1), THREADS, (size_t)L.total, stream, static_cast<const T*>(x), a, \
      static_cast<const T*>(b), static_cast<const T*>(c), dt, static_cast<T*>(y), state, S,  \
      H, hd, N, Q, ds
  if (async) {
    if ((N * sizeof(T)) % 16 || (hd * sizeof(T)) % 16 || reinterpret_cast<uintptr_t>(x) % 16 ||
        reinterpret_cast<uintptr_t>(b) % 16 || reinterpret_cast<uintptr_t>(c) % 16 ||
        reinterpret_cast<uintptr_t>(y) % 16)
      return (int)cudaErrorInvalidValue;
    return hopper::launch_cluster(ssd_scan_kernel<T, true>, REPRO_SSD_ARGS);
  }
  return hopper::launch_cluster(ssd_scan_kernel<T, false>, REPRO_SSD_ARGS);
#undef REPRO_SSD_ARGS
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, b, c and y); a, dt and the state are
// float32. Q is the chunk length (the last chunk may be shorter), at most
// 128; any N whose layout fits in 227 KB; ds the column slice of hd a
// block takes (64, 32 or 16; the last slice is padded where ds does not
// divide hd); cluster: blocks (1, 2, 4 or 8) that share a (row, head,
// slice)'s chunks; async: 1 = 16-byte cp.async copies and stores (rows of
// N and hd of 16-byte multiples, x, b, c, y 16-byte aligned), 0 = element
// loads and stores.
// The wrapper's plan (kernels/ssd_scan.py::ssd_plan) decides them.
// Returns a cudaError_t (0 = launched).
extern "C" int ssd_scan(int dtype, const void* x, const float* a, const void* b,
                        const void* c, const float* dt, void* y, float* state,
                        int B, int S, int H, int hd, int N, int Q, int ds, int cluster,
                        int async, void* stream) {
  if (Q < 1 || Q > MAX_Q || N < 1 || hd < 1 || (ds != 64 && ds != 32 && ds != 16) ||
      cluster < 1 || cluster > 8 || (cluster & (cluster - 1)))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return ssd_typed<float>(x, a, b, c, dt, y, state, B, S, H, hd, N, Q, ds, cluster, async,
                            stream);
  if (dtype == 1)
    return ssd_typed<__nv_bfloat16>(x, a, b, c, dt, y, state, B, S, H, hd, N, Q, ds, cluster,
                                    async, stream);
  return (int)cudaErrorInvalidValue;
}
