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
// never increases along a chunk, and la_end - la_j <= 0. Summing
// non-positive terms keeps a float cumsum monotone too.
//
// Ragged S. The Pallas kernel asserts S % Q == 0, and the JAX model path
// shrinks Q to a divisor of S (Q = 1 for a prime S). This kernel keeps Q
// and masks the last chunk: positions past S read x = b = c = dt = 0 and
// log a = 0, so they add nothing to y or the state, and la_end is the last
// real position's. Chunking is exact in exact arithmetic; only rounding
// differs from the divisor rule.
//
// What bounds it on the H100. At the serving prefill (B = 1, S = 1024,
// H = 32, hd = 64, N = 128, bf16) it moves ~9.8 MB (x and y 4 MiB each,
// b, c 0.5 MiB, a, dt 0.25 MiB, the state 1 MiB: ~2.9 us at 3.35 TB/s)
// and does ~2.7 GFLOP counted per head as the Pallas kernel does it
// (2Q^2 N + 2Q^2 hd + 4Q N hd per (head, chunk): ~2.7 us on bf16 tensor
// cores). This first version runs everything on the CUDA cores in float32
// and recomputes c.b for every head and column slice, so it sits far above
// that bound; moving c.b to one pass per (batch, chunk) shared by all heads
// and the products onto wgmma is the step for speed.
//
// Design. One thread block per (batch row, head, HS = 16 columns of hd):
// each column slice of y and of the state depends only on the same
// columns of x, so at B = 1 the grid has 32 x 4 = 128 blocks for 132 SMs.
// The Pallas grid's sequential chunk axis becomes a loop inside the block,
// with the [HS,N] state slice in shared memory.
//
// Shared memory. Staging x, b, c, att and the state in float32 at full
// width (Q = N = 128, all 64 columns) would take ~256 KB, above the
// 227 KB a block can opt into. The column slice is the fix: x and the
// state shrink to 16 columns (8 KB each), and b, c and att stay float32
// in rows padded by one word (so the threads of a warp hit distinct
// banks): (2 Q (N+1) + Q (Q+1) + Q HS + HS (N+1) + 3Q) * 4 = 216,128
// bytes, launched through the >48 KB opt-in.
//
// Work per chunk, 256 threads: (1) stage b, c, x, dt and, in warp 0, the
// cumsum of log a by a shuffle scan; (2) att in an 8 x 8 register tile
// per thread, rows ti + 16r and columns tj + 16s, over the N axis;
// (3) y for (row, column) pairs, the intra-chunk sum over j <= i plus the
// inter-chunk term from the carried state; (4) the state update for
// (column, n) pairs over the chunk's positions.
#include "attention_tile.cuh"

using repro_attn::from_f;
using repro_attn::to_f;

namespace {

constexpr int THREADS = 256;
constexpr int HS = 16;     // hd columns per block
constexpr int MAX_Q = 128;  // the 8 x 8 register tiles of 16 x 16 threads cover 128 x 128
constexpr int TILE = 8;

inline size_t smem_bytes(int Q, int N) {
  return sizeof(float) * ((size_t)2 * Q * (N + 1) + (size_t)Q * (Q + 1) +
                          (size_t)Q * HS + (size_t)HS * (N + 1) + 3 * (size_t)Q);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ a,
                    const T* __restrict__ b, const T* __restrict__ c,
                    const float* __restrict__ dt, T* __restrict__ y,
                    float* __restrict__ state_out, int S, int H, int hd, int N,
                    int Q) {
  const int bh = blockIdx.x;  // batch row * H + head
  const int bi = bh / H, h = bh - (bh / H) * H;
  const int d0 = blockIdx.y * HS;
  const int tid = threadIdx.x;
  const int NP = N + 1, QP = Q + 1;

  extern __shared__ __align__(16) float smem[];
  float* sB = smem;            // [Q][N+1]
  float* sC = sB + Q * NP;     // [Q][N+1]
  float* sAtt = sC + Q * NP;   // [Q][Q+1]
  float* sX = sAtt + Q * QP;   // [Q][HS]
  float* sS = sX + Q * HS;     // [HS][N+1] state slice S[d][n]
  float* sLa = sS + HS * NP;   // [Q] cumulative log decay
  float* sDt = sLa + Q;        // [Q]
  float* sW = sDt + Q;         // [Q] dt_j * exp(la_end - la_j)

  for (int i = tid; i < HS * NP; i += THREADS) sS[i] = 0.f;

  for (int c0 = 0; c0 < S; c0 += Q) {
    const int n = min(Q, S - c0);  // real positions in this chunk

    // (1) stage the chunk; rows past n are zero
    for (int idx = tid; idx < Q * N; idx += THREADS) {
      const int i = idx / N, k = idx - (idx / N) * N;
      const size_t g = ((size_t)bi * S + c0 + i) * N + k;
      sB[i * NP + k] = i < n ? to_f(b[g]) : 0.f;
      sC[i * NP + k] = i < n ? to_f(c[g]) : 0.f;
    }
    for (int idx = tid; idx < Q * HS; idx += THREADS) {
      const int i = idx / HS, d = idx - (idx / HS) * HS;
      sX[idx] = i < n ? to_f(x[(((size_t)bi * S + c0 + i) * H + h) * hd + d0 + d]) : 0.f;
    }
    if (tid < 32) {
      // inclusive cumsum of log a over the chunk: lane l owns positions
      // l * per .. l * per + per - 1, then a shuffle scan of lane totals
      const int per = (Q + 31) / 32;
      float run[MAX_Q / 32];
      float tot = 0.f;
#pragma unroll
      for (int r = 0; r < MAX_Q / 32; ++r) {
        const int i = tid * per + r;
        float l = 0.f;
        if (r < per && i < n) l = logf(fmaxf(a[((size_t)bi * S + c0 + i) * H + h], 1e-20f));
        tot += l;
        run[r] = tot;
      }
      float inc = tot;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, inc, o);
        if (tid >= o) inc += t;
      }
      float excl = __shfl_up_sync(0xffffffffu, inc, 1);
      if (tid == 0) excl = 0.f;
#pragma unroll
      for (int r = 0; r < MAX_Q / 32; ++r) {
        const int i = tid * per + r;
        if (r < per && i < Q) {
          sLa[i] = excl + run[r];
          sDt[i] = i < n ? dt[((size_t)bi * S + c0 + i) * H + h] : 0.f;
        }
      }
    }
    __syncthreads();

    const float la_end = sLa[Q - 1];
    for (int j = tid; j < Q; j += THREADS)
      sW[j] = sDt[j] * expf(fminf(fmaxf(la_end - sLa[j], -60.f), 0.f));

    // (2) att[i][j] for rows ti + 16r, columns tj + 16s
    {
      const int ti = tid / 16, tj = tid - (tid / 16) * 16;
      float acc[TILE][TILE];
#pragma unroll
      for (int r = 0; r < TILE; ++r)
#pragma unroll
        for (int s = 0; s < TILE; ++s) acc[r][s] = 0.f;
      for (int k = 0; k < N; ++k) {
        float cr[TILE], br[TILE];
#pragma unroll
        for (int r = 0; r < TILE; ++r) {
          const int i = ti + 16 * r, j = tj + 16 * r;
          cr[r] = i < Q ? sC[i * NP + k] : 0.f;
          br[r] = j < Q ? sB[j * NP + k] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < TILE; ++r)
#pragma unroll
          for (int s = 0; s < TILE; ++s) acc[r][s] = fmaf(cr[r], br[s], acc[r][s]);
      }
#pragma unroll
      for (int r = 0; r < TILE; ++r) {
        const int i = ti + 16 * r;
#pragma unroll
        for (int s = 0; s < TILE; ++s) {
          const int j = tj + 16 * s;
          if (i < Q && j < Q)
            sAtt[i * QP + j] =
                j <= i ? acc[r][s] * expf(fminf(fmaxf(sLa[i] - sLa[j], -60.f), 0.f)) * sDt[j]
                       : 0.f;
        }
      }
    }
    __syncthreads();

    // (3) y[i][d] = sum_{j<=i} att[i][j] x[j][d] + exp(la_i) (c_i . S_prev[d])
    {
      const int d = tid % HS;
      for (int i = tid / HS; i < n; i += THREADS / HS) {
        float intra = 0.f, inter = 0.f;
        for (int j = 0; j <= i; ++j) intra = fmaf(sAtt[i * QP + j], sX[j * HS + d], intra);
        for (int k = 0; k < N; ++k) inter = fmaf(sC[i * NP + k], sS[d * NP + k], inter);
        y[(((size_t)bi * S + c0 + i) * H + h) * hd + d0 + d] =
            from_f<T>(intra + expf(sLa[i]) * inter);
      }
    }
    __syncthreads();

    // (4) S[d][k] = exp(la_end) S[d][k] + sum_j x[j][d] w_j b[j][k]
    {
      const float decay = expf(la_end);
      for (int idx = tid; idx < HS * N; idx += THREADS) {
        const int d = idx / N, k = idx - (idx / N) * N;
        float acc = 0.f;
        for (int j = 0; j < n; ++j) acc = fmaf(sX[j * HS + d] * sW[j], sB[j * NP + k], acc);
        sS[d * NP + k] = decay * sS[d * NP + k] + acc;
      }
    }
    __syncthreads();
  }

  for (int idx = tid; idx < HS * N; idx += THREADS) {
    const int d = idx / N, k = idx - (idx / N) * N;
    state_out[((size_t)bh * hd + d0 + d) * N + k] = sS[d * NP + k];
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, b, c and y); a, dt and the state are
// float32. Q is the chunk length (the last chunk may be shorter). Returns a
// cudaError_t (0 = launched).
extern "C" int ssd_scan(int dtype, const void* x, const float* a, const void* b,
                        const void* c, const float* dt, void* y, float* state,
                        int B, int S, int H, int hd, int N, int Q, void* stream) {
  if (Q < 1 || Q > MAX_Q || hd % HS || N < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(Q, N);
  const dim3 grid(B * H, hd / HS);
  if (dtype == 0)
    return repro_attn::launch<THREADS>(
        ssd_scan_kernel<float>, grid, smem, stream, static_cast<const float*>(x), a,
        static_cast<const float*>(b), static_cast<const float*>(c), dt,
        static_cast<float*>(y), state, S, H, hd, N, Q);
  if (dtype == 1)
    return repro_attn::launch<THREADS>(
        ssd_scan_kernel<__nv_bfloat16>, grid, smem, stream,
        static_cast<const __nv_bfloat16*>(x), a, static_cast<const __nv_bfloat16*>(b),
        static_cast<const __nv_bfloat16*>(c), dt, static_cast<__nv_bfloat16*>(y), state,
        S, H, hd, N, Q);
  return (int)cudaErrorInvalidValue;
}
