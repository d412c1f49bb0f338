// Block-paged flash decode / verify attention for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// kernels/paged_decode_attention.py::paged_decode_attention (_paged_kernel),
// for T >= 1 queries over float32 or bfloat16 pools, and its int8 mode:
// int8 pools with per-vector bfloat16 scales, dequantized in the kernel,
// and its partials mode for the kv-sequence split: an `owned` [B,MB] mask
// whose zero entries are skipped like blocks past the window, and the
// unnormalised float32 triple (m, l, acc) as the result.
//
// What it computes: q [B,T,H,hd]; pools [NB,BS,KV,hd]; tables [B,MB] int32
// block ids; lengths [B] int32 committed lengths. Query t of row b attends
// key positions < lengths[b] + t + 1, gathered block by block through the
// row's table; the result is [B,T,H,hd] in q's type. In the int8 mode the
// scales are [NB,BS,KV] and each key or value element is used as
// float(int8) * (float(scale) / 127), the Pallas kernel's dequant. In the
// partials mode the result is m, l [B,T,H] and acc [B,T,H,hd], all
// float32 whatever q's type: the running max over the attended keys of
// owned blocks, the sum of exp(score - m) and the sum of exp(score - m) v;
// a query row with no such key gives exactly (-1e30, 0, 0), which the
// cross-rank combine scales to 0.
//
// What bounds it on the H100: memory. Each KV byte is read once and used
// for T*g query rows (g = H / KV: 3 for smollm-135m, 1 for zamba2-2.7b),
// far below the ~295 operations per byte at which the tensor cores would
// become the limit. The int8 mode halves the KV bytes of a bf16 pool, plus
// 4 bytes of scales per (key, kv head).
//
// Design: one thread block per (row b, kv head). The Pallas grid's
// sequential block-table axis becomes a loop inside the block: each live
// block of the row is staged in shared memory (as float32, dequantized
// on the way in for int8 pools) and folded into the T*g query rows with an
// online softmax in float32 (attention_tile.cuh). An int8 block is staged
// 16 values of a vector per thread and load: one 16-byte load of keys and
// one of values, one scale and one division each (hd a multiple of 16,
// pools 16-byte aligned; the entry point refuses anything else). Staged
// one element per load, with a scale load and a division each, it took
// ~7x longer at zamba2's slot shape: 128 threads per SM hide little
// latency. Blocks wholly past the last query's window are never read.
// Each query row reduces over the same blocks in the same order whatever
// T is, and a block masked for a query adds weight 0 with rescale exactly
// 1, so verify (T > 1) equals decode (T = 1) bitwise. Table entries of
// dead rows point at the pool's null block, a real slot, so every read is
// in bounds. With B * KV thread blocks (24 at smollm's decode shapes, 256
// at zamba2's) on 132 SMs the card is mostly idle or runs one block per
// SM (the slot layout's 256-key blocks at hd = 80 take ~166 KB of shared
// memory): splitting a row's blocks across thread blocks (flash-decoding)
// is the next step for speed.
#include <stdint.h>

#include <type_traits>

#include "attention_tile.cuh"

using namespace repro_attn;

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(THREADS)
    paged_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pool,
                        const TKV* __restrict__ v_pool,
                        const __nv_bfloat16* __restrict__ k_scale,
                        const __nv_bfloat16* __restrict__ v_scale,
                        const int* __restrict__ tables, const int* __restrict__ lengths,
                        const int* __restrict__ owned, TQ* __restrict__ out,
                        float* __restrict__ p_m, float* __restrict__ p_l,
                        float* __restrict__ p_acc, int nq, int H, int KV, int hd, int BS,
                        int MB, float scale) {
  constexpr bool kInt8 = std::is_same<TKV, int8_t>::value;
  const int b = blockIdx.x, kv = blockIdx.y;
  const int g = H / KV, R = nq * g;
  extern __shared__ __align__(16) char smem_raw[];
  Smem sm = carve(smem_raw, R, BS, hd);
  const int len = lengths[b];

  // row r = t * g + j is query t of head kv * g + j
  for (int idx = threadIdx.x; idx < R * hd; idx += blockDim.x) {
    const int r = idx / hd, c = idx - r * hd;
    const int t = r / g, j = r - t * g;
    sm.q[idx] = to_f(q[(((size_t)b * nq + t) * H + kv * g + j) * hd + c]);
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x) sm.lim[r] = len + r / g + 1;
  init_rows(sm, R, hd);
  __syncthreads();

  const int n_live = min(MB, (len + nq + BS - 1) / BS);
  const int* tb = tables + (size_t)b * MB;
  for (int mb = 0; mb < n_live; ++mb) {
    // a block another rank owns is skipped like one past the window (the
    // same branch for every thread of the block)
    if (owned != nullptr && owned[(size_t)b * MB + mb] == 0) continue;
    const size_t blk = (size_t)tb[mb];
    // (key s, kv head) vector of this block: (blk * BS + s) * KV + kv
    if constexpr (kInt8) {
      const int cpv = hd >> 4;  // 16-value chunks per vector
      for (int idx = threadIdx.x; idx < BS * cpv; idx += blockDim.x) {
        const int s = idx / cpv, c0 = (idx - s * cpv) << 4;
        const size_t vec = (blk * BS + s) * KV + kv;
        const int4 kr = *reinterpret_cast<const int4*>(k_pool + vec * hd + c0);
        const int4 vr = *reinterpret_cast<const int4*>(v_pool + vec * hd + c0);
        const float ks = __bfloat162float(k_scale[vec]) / 127.f;
        const float vs = __bfloat162float(v_scale[vec]) / 127.f;
        const int8_t* kb = reinterpret_cast<const int8_t*>(&kr);
        const int8_t* vb = reinterpret_cast<const int8_t*>(&vr);
        float* kd = sm.k + s * (hd + 1) + c0;
        float* vd = sm.v + s * hd + c0;
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          kd[i] = (float)kb[i] * ks;
          vd[i] = (float)vb[i] * vs;
        }
      }
    } else {
      for (int idx = threadIdx.x; idx < BS * hd; idx += blockDim.x) {
        const int s = idx / hd, c = idx - s * hd;
        const size_t gi = ((blk * BS + s) * KV + kv) * hd + c;
        sm.k[s * (hd + 1) + c] = to_f(k_pool[gi]);
        sm.v[s * hd + c] = to_f(v_pool[gi]);
      }
    }
    __syncthreads();
    tile_step(sm, R, BS, hd, mb * BS, BS, scale);
  }

  for (int idx = threadIdx.x; idx < R * hd; idx += blockDim.x) {
    const int r = idx / hd, c = idx - r * hd;
    const int t = r / g, j = r - t * g;
    const size_t o = (((size_t)b * nq + t) * H + kv * g + j) * hd + c;
    if (p_acc != nullptr)
      p_acc[o] = sm.acc[idx];
    else
      out[o] = from_f<TQ>(sm.acc[idx] / fmaxf(sm.l[r], 1e-30f));
  }
  if (p_acc == nullptr) return;
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    const int t = r / g, j = r - t * g;
    const size_t o = ((size_t)b * nq + t) * H + kv * g + j;
    p_m[o] = sm.m[r];
    p_l[o] = sm.l[r];
  }
}

template <typename TQ, typename TKV>
static int launch_typed(dim3 grid, size_t smem, void* stream, const void* q,
                        const void* k_pool, const void* v_pool, const void* k_scale,
                        const void* v_scale, const int* tables, const int* lengths,
                        const int* owned, void* out, float* p_m, float* p_l, int T, int H,
                        int KV, int hd, int BS, int MB, int partials, float scale) {
  return launch(paged_decode_kernel<TQ, TKV>, grid, smem, stream,
                static_cast<const TQ*>(q), static_cast<const TKV*>(k_pool),
                static_cast<const TKV*>(v_pool),
                static_cast<const __nv_bfloat16*>(k_scale),
                static_cast<const __nv_bfloat16*>(v_scale), tables, lengths, owned,
                partials ? nullptr : static_cast<TQ*>(out), partials ? p_m : nullptr,
                partials ? p_l : nullptr, partials ? static_cast<float*>(out) : nullptr, T,
                H, KV, hd, BS, MB, scale);
}

// q_dtype: 0 = float32, 1 = bfloat16 (q and out). kv_dtype: 0 = float32,
// 1 = bfloat16 (the same type as q), 2 = int8 with bfloat16 scales
// [NB,BS,KV] (null otherwise), hd a multiple of 16 and 16-byte aligned
// pools. owned: [B,MB] int32, 0 = skip the block, or null (every block).
// partials = 0: out [B,T,H,hd] in q's type, p_m / p_l unused; partials = 1:
// out is acc [B,T,H,hd] float32 and p_m, p_l [B,T,H] float32 take m and l.
// Returns a cudaError_t (0 = launched).
extern "C" int paged_decode_attention(int q_dtype, int kv_dtype, const void* q,
                                      const void* k_pool, const void* v_pool,
                                      const void* k_scale, const void* v_scale,
                                      const int* tables, const int* lengths,
                                      const int* owned, void* out, float* p_m, float* p_l,
                                      int B, int T, int H, int KV, int hd, int BS, int MB,
                                      int partials, float scale, void* stream) {
  if (partials && (p_m == nullptr || p_l == nullptr)) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(T * (H / KV), BS, hd);
  const dim3 grid(B, KV);
#define REPRO_PAGED_ARGS \
  grid, smem, stream, q, k_pool, v_pool, k_scale, v_scale, tables, lengths, owned, out, p_m, \
      p_l, T, H, KV, hd, BS, MB, partials, scale
  if (q_dtype == 0 && kv_dtype == 0) return launch_typed<float, float>(REPRO_PAGED_ARGS);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch_typed<__nv_bfloat16, __nv_bfloat16>(REPRO_PAGED_ARGS);
  if (kv_dtype == 2 && (k_scale == nullptr || v_scale == nullptr || hd % 16 ||
                        reinterpret_cast<uintptr_t>(k_pool) % 16 ||
                        reinterpret_cast<uintptr_t>(v_pool) % 16))
    return (int)cudaErrorInvalidValue;
  if (q_dtype == 0 && kv_dtype == 2) return launch_typed<float, int8_t>(REPRO_PAGED_ARGS);
  if (q_dtype == 1 && kv_dtype == 2)
    return launch_typed<__nv_bfloat16, int8_t>(REPRO_PAGED_ARGS);
#undef REPRO_PAGED_ARGS
  return (int)cudaErrorInvalidValue;
}
