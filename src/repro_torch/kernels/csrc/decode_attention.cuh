// The templates of the single-query flash decode kernel: the kernel, its
// launch, and the dispatch over types, rows and copy path for one width
// class (kWide). decode_attention.cu says what the kernel computes and
// how, instantiates the register path and holds the C entry point;
// decode_attention_wide.cu instantiates the wide path, so that nvcc
// compiles the two at once.
#pragma once

#include <cooperative_groups.h>
#include <stdint.h>

#include "attention_tile.cuh"
#include "hopper.cuh"

namespace repro_decode {

using repro_attn::from_f;
using repro_attn::NEG;
using repro_attn::to_f;
using repro_attn::unpack16;

// keys per tile: 64, or 32 or 16 where a head is too wide for a ring of
// 64-key tiles in 227 KB (kernels/decode_attention.py::decode_plan)
constexpr int DTHREADS = repro_attn::THREADS, DWARPS = DTHREADS / 32;  // ring_layout's block

// kWide: a head of more 16-byte chunks than threads (pv_wide); a template
// parameter, so that the register path's instantiations are the same code
// as without it
template <typename T, int R, bool kAsync, bool kWide>
__global__ void __launch_bounds__(DTHREADS)
    decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const int* __restrict__ cache_len, T* __restrict__ out, int Smax, int H,
                  int KV, int hd, int stages, int bk, float scale) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(16) uint8_t dsm[];
  const repro_attn::RingLayout L = repro_attn::ring_layout(hd, sizeof(T), R, stages, bk);
  float* qs = reinterpret_cast<float*>(dsm + L.qs);
  float* ps = reinterpret_cast<float*>(dsm + L.ps);
  float* wred = reinterpret_cast<float*>(dsm + L.wred);
  float* part = reinterpret_cast<float*>(dsm + L.part);  // m [R], l [R], acc [R][hdp]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = H / KV, groups = (g + R - 1) / R;
  const int b = blockIdx.x, kv = blockIdx.y / groups;
  const int h0 = kv * g + (blockIdx.y % groups) * R;
  const int rows = min(R, kv * g + g - h0);
  const int len = min(max(cache_len[b], 0), Smax);
  // the row's live tiles, dealt to the cluster's splits in contiguous runs
  const int splits = (int)gridDim.z;  // the cluster spans the grid's z
  const int live = (len + bk - 1) / bk, per = (live + splits - 1) / splits;
  const int j_begin = (int)blockIdx.z * per * bk;
  const int j_end = min(len, j_begin + per * bk);
  const int ntiles = j_end > j_begin ? (j_end - j_begin + bk - 1) / bk : 0;
  const size_t key_stride = (size_t)KV * hd;  // elements between keys
  const T* kh = k + (size_t)b * Smax * key_stride + (size_t)kv * hd;
  const T* vh = v + (size_t)b * Smax * key_stride + (size_t)kv * hd;

  for (int i = tid; i < R * L.hdp; i += DTHREADS) {
    const int r = i / L.hdp, c = i - r * L.hdp;
    qs[i] = (r < rows && c < hd) ? to_f(q[((size_t)b * H + h0 + r) * hd + c]) : 0.f;
  }

  // tile t of this block's run into stage t % stages: rows 0 .. n - 1
  auto load_tile = [&](int t) {
    uint8_t* st = dsm + (t % stages) * L.stage;
    const int j0 = j_begin + t * bk, n = min(bk, j_end - j0);
    if constexpr (kAsync) {
      for (int i = tid; i < 2 * n * L.chunks; i += DTHREADS) {
        const int half = i / (n * L.chunks), rem = i - half * n * L.chunks;
        const int j = rem / L.chunks, c = rem - j * L.chunks;
        const T* src = (half ? vh : kh) + (size_t)(j0 + j) * key_stride + c * VEC;
        hopper::cp_async16(st + half * bk * L.pitch + j * L.pitch + c * 16, src);
      }
    } else {
      for (int i = tid; i < 2 * n * L.hdp; i += DTHREADS) {
        const int half = i / (n * L.hdp), rem = i - half * n * L.hdp;
        const int j = rem / L.hdp, c = rem - j * L.hdp;
        const T* src = (half ? vh : kh) + (size_t)(j0 + j) * key_stride;
        reinterpret_cast<T*>(st + half * bk * L.pitch + j * L.pitch)[c] =
            c < hd ? src[c] : from_f<T>(0.f);
      }
    }
  };

  float m_run[R], l_run[R], acc[R][VEC];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m_run[r] = NEG;
    l_run[r] = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[r][i] = 0.f;
  }
  // scoring: tpk = DTHREADS / bk threads a key (2, 4 or 8), each taking a
  // run of the head's chunks; their sums join by shuffles
  const int tpk = DTHREADS / bk, key = tid / tpk, sub = tid % tpk;
  const int c_per = (L.chunks + tpk - 1) / tpk;
  const int c_lo = min(L.chunks, sub * c_per), c_hi = min(L.chunks, c_lo + c_per);
  const int cc = tid % L.chunks, kg = tid / L.chunks;  // P.V: column chunk, key group
  const bool pv = kg < L.groups;
  if constexpr (kWide)  // a wide head accumulates in part (pv_wide)
    for (int i = tid; i < R * L.hdp; i += DTHREADS) part[2 * R + i] = 0.f;

  for (int t = 0; t < stages - 1; ++t) {
    if (t < ntiles) load_tile(t);
    hopper::cp_async_commit();
  }
  for (int t = 0; t < ntiles; ++t) {
    if (stages == 1) {  // no ring: load the tile once the last one is done with
      __syncthreads();
      load_tile(t);
      hopper::cp_async_commit();
      hopper::cp_async_wait<0>();
      __syncthreads();
    } else {
      hopper::cp_async_wait_for(stages - 2);  // this thread's copies of tile t have landed
      __syncthreads();  // everyone's have, and tile t - 1's stage and the weights are free
      if (t + stages - 1 < ntiles) load_tile(t + stages - 1);
      hopper::cp_async_commit();
    }
    const uint8_t* st = dsm + (t % stages) * L.stage;
    const int n = min(bk, j_end - (j_begin + t * bk));

    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = 0.f;
    for (int c = c_lo; c < c_hi; ++c) {
      float kf[VEC];
      unpack16<T>(*reinterpret_cast<const uint4*>(st + key * L.pitch + c * 16), kf);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4* qv = reinterpret_cast<const float4*>(qs + r * L.hdp + c * VEC);
#pragma unroll
        for (int i = 0; i < VEC / 4; ++i) {
          const float4 qq = qv[i];
          s[r] = fmaf(qq.x, kf[4 * i], s[r]);
          s[r] = fmaf(qq.y, kf[4 * i + 1], s[r]);
          s[r] = fmaf(qq.z, kf[4 * i + 2], s[r]);
          s[r] = fmaf(qq.w, kf[4 * i + 3], s[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      for (int o = 1; o < tpk; o <<= 1) s[r] += __shfl_xor_sync(0xffffffffu, s[r], o);
      s[r] = key < n ? s[r] * scale : NEG;  // a select: a stale row's value never enters
      float mx = s[r];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      if (lane == 0) wred[warp * R + r] = mx;
    }
    __syncthreads();
    float corr[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float mx = wred[r];
#pragma unroll
      for (int w = 1; w < DWARPS; ++w) mx = fmaxf(mx, wred[w * R + r]);
      const float m_new = fmaxf(m_run[r], mx);
      corr[r] = expf(m_run[r] - m_new);
      if (sub == 0) ps[r * bk + key] = key < n ? expf(s[r] - m_new) : 0.f;
      m_run[r] = m_new;
    }
    __syncthreads();
    if constexpr (kWide) {
      repro_attn::pv_wide<T, R>(part + 2 * R, l_run, corr, st + bk * L.pitch, L.pitch, ps, bk, n,
                                L.chunks, L.hdp, nullptr, acc);
    } else if (pv) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        l_run[r] *= corr[r];
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[r][i] *= corr[r];
      }
      const uint8_t* vt = st + bk * L.pitch + cc * 16;
      for (int j = kg; j < n; j += L.groups) {
        float vf[VEC];
        unpack16<T>(*reinterpret_cast<const uint4*>(vt + j * L.pitch), vf);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float p = ps[r * bk + j];
          l_run[r] += p;
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[r][i] = fmaf(p, vf[i], acc[r][i]);
        }
      }
    }
  }
  hopper::cp_async_wait<0>();  // no copy may land in the ring once it is reused

  // the block's partials, summed over the key groups in group order (a
  // wide head's acc is in part already, its l in thread 0)
  if constexpr (kWide) {
    if (tid == 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        part[r] = m_run[r];
        part[R + r] = l_run[r];
      }
    }
  } else {
    __syncthreads();
    float* red = reinterpret_cast<float*>(dsm);  // [groups][R][hdp], then [groups][R]
    float* lred = red + L.groups * R * L.hdp;
    if (pv) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) red[(kg * R + r) * L.hdp + cc * VEC + i] = acc[r][i];
        if (cc == 0) lred[kg * R + r] = l_run[r];
      }
    }
    __syncthreads();
    for (int e = tid; e < R * L.hdp; e += DTHREADS) {
      float sum = red[e];
      for (int gi = 1; gi < L.groups; ++gi) sum += red[gi * R * L.hdp + e];
      part[2 * R + e] = sum;
    }
    if (tid == 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float sum = lred[r];
        for (int gi = 1; gi < L.groups; ++gi) sum += lred[gi * R + r];
        part[r] = m_run[r];
        part[R + r] = sum;
      }
    }
  }

  // rank 0 combines the splits in split order; the second cluster barrier
  // keeps every block's shared memory alive until rank 0 has read it
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (cluster.block_rank() == 0) {
    for (int e = tid; e < rows * hd; e += DTHREADS) {
      const int r = e / hd, c = e - r * hd;
      float m = NEG;
      for (int sp = 0; sp < splits; ++sp) m = fmaxf(m, cluster.map_shared_rank(part, sp)[r]);
      float l = 0.f, a = 0.f;
      for (int sp = 0; sp < splits; ++sp) {
        const float* pp = cluster.map_shared_rank(part, sp);
        const float ms = pp[r];
        const float wgt = ms <= NEG ? 0.f : expf(ms - m);
        l = fmaf(pp[R + r], wgt, l);
        a = fmaf(pp[2 * R + r * L.hdp + c], wgt, a);
      }
      out[((size_t)b * H + h0 + r) * hd + c] = from_f<T>(a / fmaxf(l, 1e-30f));
    }
  }
  cluster.sync();
}

template <typename T, int R, bool kAsync, bool kWide>
int decode_launch(const void* q, const void* k, const void* v, const int* cache_len, void* out,
                  int B, int Smax, int H, int KV, int hd, int splits, int stages, int bk,
                  float scale, void* stream) {
  const repro_attn::RingLayout L = repro_attn::ring_layout(hd, sizeof(T), R, stages, bk);
  if (L.groups < 1) return (int)cudaErrorInvalidValue;
  const int groups = (H / KV + R - 1) / R;
  return hopper::launch_cluster(decode_kernel<T, R, kAsync, kWide>, dim3(B, KV * groups, splits),
                                dim3(1, 1, splits), DTHREADS, (size_t)L.total, stream,
                                static_cast<const T*>(q), static_cast<const T*>(k),
                                static_cast<const T*>(v), cache_len, static_cast<T*>(out), Smax,
                                H, KV, hd, stages, bk, scale);
}

template <typename T, bool kWide>
int decode_typed(const void* q, const void* k, const void* v, const int* cache_len, void* out,
                 int B, int Smax, int H, int KV, int hd, int rows, int splits, int stages,
                 int bk, int async, float scale, void* stream) {
  if (splits < 1 || splits > 8 || stages < 1 || stages > 4 || KV < 1 || H % KV ||
      (bk != 64 && bk != 32 && bk != 16))
    return (int)cudaErrorInvalidValue;
  if (async && ((hd * sizeof(T)) % 16 || reinterpret_cast<uintptr_t>(k) % 16 ||
                reinterpret_cast<uintptr_t>(v) % 16))
    return (int)cudaErrorInvalidValue;
#define REPRO_LAUNCH_ARGS \
  q, k, v, cache_len, out, B, Smax, H, KV, hd, splits, stages, bk, scale, stream
#define REPRO_DECODE(R)                                             \
  (async ? decode_launch<T, R, true, kWide>(REPRO_LAUNCH_ARGS)      \
         : decode_launch<T, R, false, kWide>(REPRO_LAUNCH_ARGS))
  switch (rows) {
    case 1: return REPRO_DECODE(1);
    case 4: return REPRO_DECODE(4);
    case 8: return REPRO_DECODE(8);
  }
#undef REPRO_DECODE
#undef REPRO_LAUNCH_ARGS
  return (int)cudaErrorInvalidValue;
}

// dtype as the C entry point takes it
template <bool kWide>
int decode_dispatch(int dtype, const void* q, const void* k, const void* v, const int* cache_len,
                    void* out, int B, int Smax, int H, int KV, int hd, int rows, int splits,
                    int stages, int bk, int async, float scale, void* stream) {
#define REPRO_DECODE_ARGS \
  q, k, v, cache_len, out, B, Smax, H, KV, hd, rows, splits, stages, bk, async, scale, stream
  if (dtype == 0) return decode_typed<float, kWide>(REPRO_DECODE_ARGS);
  if (dtype == 1) return decode_typed<__nv_bfloat16, kWide>(REPRO_DECODE_ARGS);
#undef REPRO_DECODE_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace repro_decode
