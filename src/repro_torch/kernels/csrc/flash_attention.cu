// GQA flash attention, causal with a query offset or non-causal, for
// Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// kernels/flash_attention.py::flash_attention (_flash_kernel), and extends
// it to what the serving prefill needs: an absolute query offset (a suffix
// prefill over a cached prefix attends Skv = h + W keys at q_offset = h)
// and ragged Sq / Skv (no multiple-of-tile requirement).
//
// What it computes: q [B,Sq,H,hd]; k, v [B,Skv,KV,hd] -> [B,Sq,H,hd].
// Causal: query i sits at position q_offset + i and attends keys j <= that
// position. Non-causal (the Pallas kernel's causal=False): every query
// attends all Skv keys. Query head h reads kv head h / g (g = H / KV), and
// K/V are never repeated in memory.
//
// What bounds it on the H100: at prefill lengths of a few hundred tokens
// and more, operations (about 4 * hd flops per (query, key) pair against
// 2 * hd * 2 bytes per key). This first version does those operations on
// the CUDA cores in float32, not on the tensor cores (wgmma), so it runs
// far below the bf16 peak; moving the two products onto wgmma is the step
// for speed.
//
// Design: one thread block per (BQ query positions, batch row, kv head):
// the g query heads of the kv group ride together as BQ * g rows, so one
// K/V tile in shared memory serves all of them. The Pallas grid's
// sequential kv axis becomes a loop over BK-key tiles that stops at the
// block's causal limit (tiles above the diagonal are never read), or at
// Skv when non-causal (a template parameter: with a runtime flag the
// causal kernel ran ~40% slower at smollm's prefill shapes); the ragged
// last query block and key tile are masked. Softmax and the
// accumulator are float32 (attention_tile.cuh).
#include "attention_tile.cuh"

using namespace repro_attn;

constexpr int BQ = 16;  // query positions per block
constexpr int BK = 32;  // keys per tile

template <typename T, bool kCausal>
__global__ void __launch_bounds__(THREADS)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int Sq, int Skv,
                 int H, int KV, int hd, int q_offset, float scale) {
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / KV, kv = blockIdx.y - (blockIdx.y / KV) * KV;
  const int g = H / KV, R = BQ * g;
  extern __shared__ __align__(16) char smem_raw[];
  Smem sm = carve(smem_raw, R, BK, hd);

  // row r = i * g + j is query position q0 + i of head kv * g + j
  for (int idx = threadIdx.x; idx < R * hd; idx += blockDim.x) {
    const int r = idx / hd, c = idx - r * hd;
    const int i = r / g, j = r - i * g;
    const int qi = q0 + i;
    sm.q[idx] = qi < Sq ? to_f(q[(((size_t)b * Sq + qi) * H + kv * g + j) * hd + c]) : 0.f;
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    const int qi = q0 + r / g;
    sm.lim[r] = qi >= Sq ? 0 : kCausal ? q_offset + qi + 1 : Skv;
  }
  init_rows(sm, R, hd);
  __syncthreads();

  const int kv_end = kCausal ? min(Skv, q_offset + min(q0 + BQ, Sq)) : Skv;
  for (int j0 = 0; j0 < kv_end; j0 += BK) {
    const int n = min(BK, Skv - j0);
    for (int idx = threadIdx.x; idx < n * hd; idx += blockDim.x) {
      const int s = idx / hd, c = idx - s * hd;
      const size_t gi = (((size_t)b * Skv + j0 + s) * KV + kv) * hd + c;
      sm.k[s * (hd + 1) + c] = to_f(k[gi]);
      sm.v[s * hd + c] = to_f(v[gi]);
    }
    __syncthreads();
    tile_step(sm, R, BK, hd, j0, n, scale);
  }

  for (int idx = threadIdx.x; idx < R * hd; idx += blockDim.x) {
    const int r = idx / hd, c = idx - r * hd;
    const int i = r / g, j = r - i * g;
    const int qi = q0 + i;
    if (qi < Sq)
      out[(((size_t)b * Sq + qi) * H + kv * g + j) * hd + c] =
          from_f<T>(sm.acc[idx] / fmaxf(sm.l[r], 1e-30f));
  }
}

// dtype: 0 = float32, 1 = bfloat16. causal: 1 = causal from q_offset,
// 0 = every query attends every key (q_offset unused). Returns a
// cudaError_t (0 = launched).
extern "C" int flash_attention(int dtype, const void* q, const void* k, const void* v,
                               void* out, int B, int Sq, int Skv, int H, int KV,
                               int hd, int q_offset, int causal, float scale,
                               void* stream) {
  const size_t smem = smem_bytes(BQ * (H / KV), BK, hd);
  const dim3 grid((Sq + BQ - 1) / BQ, B * KV);
#define REPRO_FLASH_LAUNCH(T, C)                                                              \
  launch(flash_kernel<T, C>, grid, smem, stream, static_cast<const T*>(q),                   \
         static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(out), Sq, Skv, \
         H, KV, hd, q_offset, scale)
  if (dtype == 0)
    return causal ? REPRO_FLASH_LAUNCH(float, true) : REPRO_FLASH_LAUNCH(float, false);
  if (dtype == 1)
    return causal ? REPRO_FLASH_LAUNCH(__nv_bfloat16, true)
                  : REPRO_FLASH_LAUNCH(__nv_bfloat16, false);
#undef REPRO_FLASH_LAUNCH
  return (int)cudaErrorInvalidValue;
}
