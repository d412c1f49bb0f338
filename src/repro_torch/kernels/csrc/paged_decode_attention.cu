// Block-paged flash decode / verify attention for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// kernels/paged_decode_attention.py::paged_decode_attention (_paged_kernel),
// for T >= 1 queries with float32 or bfloat16 pools. The int8-dequant and
// partials (sequence-split) modes are not ported yet (ROADMAP §2 item 1).
//
// What it computes: q [B,T,H,hd]; pools [NB,BS,KV,hd]; tables [B,MB] int32
// block ids; lengths [B] int32 committed lengths. Query t of row b attends
// key positions < lengths[b] + t + 1, gathered block by block through the
// row's table; the result is [B,T,H,hd].
//
// What bounds it on the H100: memory. Each KV byte is read once and used
// for T*g query rows (g = H / KV, 3 for smollm-135m), far below the ~295
// operations per byte at which the tensor cores would become the limit.
//
// Design: one thread block per (row b, kv head). The Pallas grid's
// sequential block-table axis becomes a loop inside the block: each live
// block of the row is staged in shared memory (as float32) and folded into
// the T*g query rows with an online softmax in float32 (attention_tile.cuh).
// Blocks wholly past the last query's window are never read. Each query
// row reduces over the same blocks in the same order whatever T is, and a
// block masked for a query adds weight 0 with rescale exactly 1, so
// verify (T > 1) equals decode (T = 1) bitwise. Table entries of dead rows
// point at the pool's null block, a real slot, so every read is in bounds.
// With B * KV = 24 blocks on 132 SMs at smollm's decode shapes the card is
// mostly idle: splitting a row's blocks across thread blocks
// (flash-decoding) is the next step for speed.
#include "attention_tile.cuh"

using namespace repro_attn;

template <typename T>
__global__ void __launch_bounds__(THREADS)
    paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                        const T* __restrict__ v_pool, const int* __restrict__ tables,
                        const int* __restrict__ lengths, T* __restrict__ out, int nq,
                        int H, int KV, int hd, int BS, int MB, float scale) {
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
    const size_t blk = (size_t)tb[mb];
    for (int idx = threadIdx.x; idx < BS * hd; idx += blockDim.x) {
      const int s = idx / hd, c = idx - s * hd;
      const size_t gi = ((blk * BS + s) * KV + kv) * hd + c;
      sm.k[s * (hd + 1) + c] = to_f(k_pool[gi]);
      sm.v[s * hd + c] = to_f(v_pool[gi]);
    }
    __syncthreads();
    tile_step(sm, R, BS, hd, mb * BS, BS, scale);
  }

  for (int idx = threadIdx.x; idx < R * hd; idx += blockDim.x) {
    const int r = idx / hd, c = idx - r * hd;
    const int t = r / g, j = r - t * g;
    out[(((size_t)b * nq + t) * H + kv * g + j) * hd + c] =
        from_f<T>(sm.acc[idx] / fmaxf(sm.l[r], 1e-30f));
  }
}

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int paged_decode_attention(int dtype, const void* q, const void* k_pool,
                                      const void* v_pool, const int* tables,
                                      const int* lengths, void* out, int B, int T,
                                      int H, int KV, int hd, int BS, int MB,
                                      float scale, void* stream) {
  const size_t smem = smem_bytes(T * (H / KV), BS, hd);
  const dim3 grid(B, KV);
  if (dtype == 0)
    return launch(paged_decode_kernel<float>, grid, smem, stream,
                  static_cast<const float*>(q), static_cast<const float*>(k_pool),
                  static_cast<const float*>(v_pool), tables, lengths,
                  static_cast<float*>(out), T, H, KV, hd, BS, MB, scale);
  if (dtype == 1)
    return launch(paged_decode_kernel<__nv_bfloat16>, grid, smem, stream,
                  static_cast<const __nv_bfloat16*>(q),
                  static_cast<const __nv_bfloat16*>(k_pool),
                  static_cast<const __nv_bfloat16*>(v_pool), tables, lengths,
                  static_cast<__nv_bfloat16*>(out), T, H, KV, hd, BS, MB, scale);
  return (int)cudaErrorInvalidValue;
}
