// Single-query flash decode over a dense KV cache, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// kernels/decode_attention.py::decode_attention (_decode_kernel).
//
// What it computes: q [B,H,hd]; caches [B,Smax,KV,hd] in q's type;
// cache_len [B] int32, clamped to [0, Smax]. Head h of row b attends the
// positions < cache_len[b] of kv head h / g (g = H / KV); the result is
// acc / max(l, 1e-30) in q's type, so a row with cache_len 0 gives zeros.
// The cache is read in place: the JAX wrapper transposes it to
// [B,KV,Smax,hd] outside its kernel, this one copies nothing.
//
// What bounds it on the H100: memory. Each cached key and value is read
// once and used for the g query heads of its group (3 for smollm-135m, 1
// for zamba2-2.7b), far below the ~295 operations per byte at which the
// tensor cores would become the limit.
//
// Design: the Pallas grid (B, KV, S/bk) with the cache axis sequential
// becomes one thread block per (row, kv head, split): a row's live key
// tiles (64 keys each; tiles at or past cache_len are never read) are
// dealt out to `splits` thread blocks, so that the card has work for all
// 132 SMs at smollm's 24 (row, kv head) pairs (flash-decoding). Each block
// stages its tiles in shared memory as float32, 16 bytes a load where the
// head dim allows it, and folds them into its g query rows with an online
// softmax (attention_tile.cuh). With one split the block writes the
// normalised output; with more, each writes its unnormalised (m, l, acc)
// in float32 to a workspace and a second kernel combines them in split
// order, scaling each by exp(m_split - m) (by 0 for a split that saw no
// key, whose m is the -1e30 sentinel), as the kv-sequence split's
// distributed softmax does.
#include <stdint.h>

#include "attention_tile.cuh"

using namespace repro_attn;

namespace {

constexpr int DBK = 64;  // keys per tile

// Stage keys j0 .. j0 + n - 1 of (row b, kv head) into sm.k / sm.v.
// base: element offset of key j0's vector; stride: elements between keys.
template <typename T>
__device__ inline void stage_keys(Smem sm, const T* __restrict__ k, const T* __restrict__ v,
                                  size_t base, size_t stride, int n, int hd, bool vec) {
  const int hp = hd + 1;
  if (vec) {
    constexpr int E = 16 / sizeof(T);  // values per 16-byte load
    const int cpv = hd / E;
    for (int idx = threadIdx.x; idx < n * cpv; idx += blockDim.x) {
      const int s = idx / cpv, c0 = (idx - s * cpv) * E;
      const size_t gi = base + s * stride + c0;
      const int4 kr = *reinterpret_cast<const int4*>(k + gi);
      const int4 vr = *reinterpret_cast<const int4*>(v + gi);
      const T* kb = reinterpret_cast<const T*>(&kr);
      const T* vb = reinterpret_cast<const T*>(&vr);
#pragma unroll
      for (int i = 0; i < E; ++i) {
        sm.k[s * hp + c0 + i] = to_f(kb[i]);
        sm.v[s * hd + c0 + i] = to_f(vb[i]);
      }
    }
  } else {
    for (int idx = threadIdx.x; idx < n * hd; idx += blockDim.x) {
      const int s = idx / hd, c = idx - s * hd;
      const size_t gi = base + s * stride + c;
      sm.k[s * hp + c] = to_f(k[gi]);
      sm.v[s * hd + c] = to_f(v[gi]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const int* __restrict__ cache_len, T* __restrict__ out,
                  float* __restrict__ ws_m, float* __restrict__ ws_l,
                  float* __restrict__ ws_acc, int Smax, int H, int KV, int hd,
                  int tiles_per_split, int vec, float scale) {
  const int b = blockIdx.x, kv = blockIdx.y, split = blockIdx.z;
  const int g = H / KV;
  extern __shared__ __align__(16) char smem_raw[];
  Smem sm = carve(smem_raw, g, DBK, hd);
  const int len = min(max(cache_len[b], 0), Smax);
  const size_t h0 = (size_t)b * H + kv * g;  // the group's g heads are adjacent

  for (int idx = threadIdx.x; idx < g * hd; idx += blockDim.x) sm.q[idx] = to_f(q[h0 * hd + idx]);
  for (int r = threadIdx.x; r < g; r += blockDim.x) sm.lim[r] = len;
  init_rows(sm, g, hd);
  __syncthreads();

  const int j_begin = split * tiles_per_split * DBK;
  const int j_end = min(len, j_begin + tiles_per_split * DBK);
  const size_t stride = (size_t)KV * hd;
  for (int j0 = j_begin; j0 < j_end; j0 += DBK) {
    const int n = min(DBK, j_end - j0);
    stage_keys(sm, k, v, ((size_t)b * Smax + j0) * stride + (size_t)kv * hd, stride, n, hd,
               vec);
    __syncthreads();
    tile_step(sm, g, DBK, hd, j0, n, scale);
  }

  if (gridDim.z == 1) {
    for (int idx = threadIdx.x; idx < g * hd; idx += blockDim.x)
      out[h0 * hd + idx] = from_f<T>(sm.acc[idx] / fmaxf(sm.l[idx / hd], 1e-30f));
    return;
  }
  const size_t w0 = (size_t)split * gridDim.x * H + h0;
  for (int idx = threadIdx.x; idx < g * hd; idx += blockDim.x) ws_acc[w0 * hd + idx] = sm.acc[idx];
  for (int r = threadIdx.x; r < g; r += blockDim.x) {
    ws_m[w0 + r] = sm.m[r];
    ws_l[w0 + r] = sm.l[r];
  }
}

// One thread block per (row, head): combine the splits' partials.
template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ ws_m,
                                      const float* __restrict__ ws_l,
                                      const float* __restrict__ ws_acc, T* __restrict__ out,
                                      int BH, int hd, int splits) {
  const size_t bh = blockIdx.x;
  float m = NEG;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, ws_m[s * BH + bh]);
  for (int c = threadIdx.x; c < hd; c += blockDim.x) {
    float l = 0.f, acc = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float ms = ws_m[s * BH + bh];
      const float w = ms <= NEG ? 0.f : expf(ms - m);
      l = fmaf(ws_l[s * BH + bh], w, l);
      acc = fmaf(ws_acc[(s * BH + bh) * hd + c], w, acc);
    }
    out[bh * hd + c] = from_f<T>(acc / fmaxf(l, 1e-30f));
  }
}

template <typename T>
int decode_typed(const void* q, const void* k, const void* v, const int* cache_len, void* out,
                 float* ws_m, float* ws_l, float* ws_acc, int B, int Smax, int H, int KV,
                 int hd, int splits, float scale, void* stream) {
  const int tiles = (Smax + DBK - 1) / DBK;
  const int tiles_per_split = (tiles + splits - 1) / splits;
  const int vec = (hd * sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const int g = H / KV;
  int err = launch(decode_kernel<T>, dim3(B, KV, splits), smem_bytes(g, DBK, hd), stream,
                   static_cast<const T*>(q), static_cast<const T*>(k),
                   static_cast<const T*>(v), cache_len, static_cast<T*>(out), ws_m, ws_l,
                   ws_acc, Smax, H, KV, hd, tiles_per_split, vec, scale);
  if (err || splits == 1) return err;
  return launch(decode_combine_kernel<T>, dim3(B * H), 0, stream,
                static_cast<const float*>(ws_m), static_cast<const float*>(ws_l),
                static_cast<const float*>(ws_acc), static_cast<T*>(out), B * H, hd, splits);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, caches and out). splits > 1 needs
// float32 workspaces ws_m, ws_l [splits,B,H] and ws_acc [splits,B,H,hd]
// (null when splits == 1). Returns a cudaError_t (0 = launched).
extern "C" int decode_attention(int dtype, const void* q, const void* k_cache,
                                const void* v_cache, const int* cache_len, void* out,
                                float* ws_m, float* ws_l, float* ws_acc, int B, int Smax,
                                int H, int KV, int hd, int splits, float scale,
                                void* stream) {
  if (splits < 1 || (splits > 1 && (!ws_m || !ws_l || !ws_acc)))
    return (int)cudaErrorInvalidValue;
#define REPRO_DECODE_ARGS \
  q, k_cache, v_cache, cache_len, out, ws_m, ws_l, ws_acc, B, Smax, H, KV, hd, splits, scale, \
      stream
  if (dtype == 0) return decode_typed<float>(REPRO_DECODE_ARGS);
  if (dtype == 1) return decode_typed<__nv_bfloat16>(REPRO_DECODE_ARGS);
#undef REPRO_DECODE_ARGS
  return (int)cudaErrorInvalidValue;
}
