// The templates of the block-paged decode / verify kernel: the kernel, its
// launch, and the dispatch over types, rows and copy path for one width
// class (kWide). paged_decode_attention.cu says what the kernel computes
// and how, instantiates the register path and holds the C entry point;
// paged_decode_attention_wide.cu instantiates the wide path, so that nvcc
// compiles the two at once.
#pragma once

#include <cooperative_groups.h>
#include <stdint.h>

#include <type_traits>

#include "attention_tile.cuh"
#include "hopper.cuh"

namespace repro_paged {

using repro_attn::from_f;
using repro_attn::NEG;
using repro_attn::to_f;
using repro_attn::unpack16;

constexpr int PTHREADS = repro_attn::THREADS, PWARPS = PTHREADS / 32;  // ring_layout's block
// table entries of a split's tiles kept in shared memory, after the ring
// layout (kernels/paged_decode_attention.py::TABLE_IDS)
constexpr int kTableIds = 256;

// How a row's table is cut into tiles of at most tc keys: epr table
// entries a tile (BS <= tc), or spe slices of tc keys an entry (BS > tc).
// Either way a tile's keys are consecutive positions.
struct Tiling {
  int bs, mb, tc, epr, spe;
  __device__ int start(int i) const {  // the position of the tile's first key
    return spe == 1 ? i * epr * bs : (i / spe) * bs + (i % spe) * tc;
  }
  __device__ int keys(int i) const {
    return spe == 1 ? min(epr, mb - i * epr) * bs : min(tc, bs - (i % spe) * tc);
  }
  __device__ int entry(int i, int j) const { return spe == 1 ? i * epr + j / bs : i / spe; }
  __device__ int slot(int i, int j) const { return spe == 1 ? j % bs : (i % spe) * tc + j; }
  __device__ int below(int lim) const {  // tiles whose first key is below lim (<= mb * bs)
    if (spe == 1) return (lim + epr * bs - 1) / (epr * bs);
    const int e = lim / bs;
    return e * spe + (lim - e * bs + tc - 1) / tc;
  }
};

template <typename T>
__device__ __forceinline__ T zero_of() {
  if constexpr (std::is_same<T, int8_t>::value)
    return 0;
  else
    return from_f<T>(0.f);
}

// kWide: a head of more 16-byte chunks than threads (pv_wide); a template
// parameter, so that the register path's instantiations are the same code
// as without it
template <typename TQ, typename TKV, int R, bool kAsync, bool kWide>
__global__ void __launch_bounds__(PTHREADS)
    paged_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pool,
                 const TKV* __restrict__ v_pool, const __nv_bfloat16* __restrict__ k_scale,
                 const __nv_bfloat16* __restrict__ v_scale, const int* __restrict__ tables,
                 const int* __restrict__ lengths, const int* __restrict__ owned,
                 TQ* __restrict__ out, float* __restrict__ p_m, float* __restrict__ p_l,
                 float* __restrict__ p_acc, int T, int H, int KV, int hd, int BS, int MB,
                 int stages, int tc, int epr, int spe, float scale) {
  constexpr bool kInt8 = std::is_same<TKV, int8_t>::value;
  constexpr int VEC = 16 / sizeof(TKV);
  extern __shared__ __align__(16) uint8_t dsm[];
  const repro_attn::RingLayout L = repro_attn::ring_layout(hd, sizeof(TKV), R, stages, tc);
  const Tiling G{BS, MB, tc, epr, spe};
  float* qs = reinterpret_cast<float*>(dsm + L.qs);
  float* ps = reinterpret_cast<float*>(dsm + L.ps);
  float* wred = reinterpret_cast<float*>(dsm + L.wred);
  float* part = reinterpret_cast<float*>(dsm + L.part);  // m [R], l [R], acc [R][hdp]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = H / KV, nrows = T * g, groups = (nrows + R - 1) / R;
  const int b = blockIdx.x, kv = blockIdx.y / groups, r0 = (blockIdx.y % groups) * R;
  const int rows = min(R, nrows - r0);  // row r0 + r is query (r0 + r) / g of head kv * g + (r0 + r) % g
  const int reach = MB * BS, len = lengths[b];
  int lim[R];  // row r attends positions < lim[r]
#pragma unroll
  for (int r = 0; r < R; ++r) lim[r] = r < rows ? max(0, min(reach, len + (r0 + r) / g + 1)) : 0;
  const int lim_max = max(0, min(reach, len + T));
  const int splits = (int)gridDim.z, split = (int)blockIdx.z;  // the cluster spans the grid's z
  const int live = G.below(lim_max);
  const int ntiles = live > split ? (live - split + splits - 1) / splits : 0;
  const int* tb = tables + (size_t)b * MB;
  const int* own = owned != nullptr ? owned + (size_t)b * MB : nullptr;

  // the pool blocks of this split's tiles (-1: not owned), read at once
  // into shared memory so that no copy waits on a table read; past
  // kTableIds entries a copy reads the table itself
  int* ids = reinterpret_cast<int*>(dsm + L.total);
  const int per_tile = G.spe == 1 ? G.epr : 1;
  for (int x = tid; x < min(kTableIds, ntiles * per_tile); x += PTHREADS) {
    const int lt = x / per_tile, i = split + lt * splits;
    const int e = G.spe == 1 ? i * G.epr + (x - lt * per_tile) : i / G.spe;
    ids[x] = own == nullptr || own[e] != 0 ? tb[e] : -1;
  }
  __syncthreads();
  // the pool block of key j of this split's tile lt (table tile i), or -1
  auto block_of = [&](int lt, int i, int j) {
    const int x = lt * per_tile + (G.spe == 1 ? j / BS : 0);
    if (x < kTableIds) return ids[x];
    const int e = G.entry(i, j);
    return own == nullptr || own[e] != 0 ? tb[e] : -1;
  };

  for (int i = tid; i < R * L.hdp; i += PTHREADS) {
    const int r = i / L.hdp, c = i - r * L.hdp, gr = r0 + r;
    qs[i] = (r < rows && c < hd)
                ? to_f(q[(((size_t)b * T + gr / g) * H + kv * g + gr % g) * hd + c])
                : 0.f;
  }

  // copies and P.V: column chunk, key group; a wide head loops the chunks
  // in its copies and accumulates in part (pv_wide)
  const int cc = kWide ? tid : tid % L.chunks, kg = kWide ? 0 : tid / L.chunks;
  const bool pv = kg < L.groups;
  if constexpr (kWide)
    for (int i = tid; i < R * L.hdp; i += PTHREADS) part[2 * R + i] = 0.f;

  // this split's tile lt (table tile split + lt * splits) into stage lt % stages
  auto load_tile = [&](int lt) {
    uint8_t* st = dsm + (lt % stages) * L.stage;
    const int i = split + lt * splits, p0 = G.start(i);
    const int n = min(G.keys(i), lim_max - p0);
    if constexpr (kAsync) {
      // thread (key group kg, column chunk cc) copies chunk cc of rows kg,
      // kg + groups, ... of the tile's K rows then its V rows (a wide head:
      // chunks cc, cc + 128, ... of every row)
      for (int r = kg; pv && r < 2 * n; r += L.groups) {
        const int half = r >= n, j = r - half * n, blk = block_of(lt, i, j);
        auto copy = [&](int c) {
          uint8_t* dst = st + half * tc * L.pitch + j * L.pitch + c * 16;
          if (blk < 0) {
            *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
          } else {
            const size_t vec = ((size_t)blk * BS + G.slot(i, j)) * KV + kv;
            hopper::cp_async16(dst, (half ? v_pool : k_pool) + vec * hd + c * VEC);
          }
        };
        if constexpr (kWide)
          for (int c = cc; c < L.chunks; c += PTHREADS) copy(c);
        else
          copy(cc);
      }
    } else {
      for (int idx = tid; idx < 2 * n * L.hdp; idx += PTHREADS) {
        const int half = idx / (n * L.hdp), rem = idx - half * n * L.hdp;
        const int j = rem / L.hdp, c = rem - j * L.hdp;
        const int blk = block_of(lt, i, j);
        TKV val = zero_of<TKV>();
        if (c < hd && blk >= 0) {
          const size_t vec = ((size_t)blk * BS + G.slot(i, j)) * KV + kv;
          val = (half ? v_pool : k_pool)[vec * hd + c];
        }
        reinterpret_cast<TKV*>(st + half * tc * L.pitch + j * L.pitch)[c] = val;
      }
    }
    if constexpr (kInt8) {
      float* sc = reinterpret_cast<float*>(st + L.scales);
      for (int idx = tid; idx < 2 * n; idx += PTHREADS) {
        const int half = idx / n, j = idx - half * n;
        const int blk = block_of(lt, i, j);
        float s = 0.f;
        if (blk >= 0) {
          const size_t vec = ((size_t)blk * BS + G.slot(i, j)) * KV + kv;
          s = __bfloat162float((half ? v_scale : k_scale)[vec]) / 127.f;
        }
        sc[half * tc + j] = s;
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
  // scoring: tpk = PTHREADS / tc threads a key (2 for 64-key tiles), each
  // taking a run of the head's chunks
  const int tpk = PTHREADS / tc, key = tid / tpk, sub = tid % tpk;
  const int c_per = (L.chunks + tpk - 1) / tpk;
  const int c_lo = min(L.chunks, sub * c_per), c_hi = min(L.chunks, c_lo + c_per);

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
    const float* sc = reinterpret_cast<const float*>(st + L.scales);
    const int i = split + t * splits, p0 = G.start(i);
    const int n = min(G.keys(i), lim_max - p0);
    // the key is in the tile's loaded run and its entry is owned
    const bool kv_ok = key < n && (own == nullptr || block_of(t, i, key) >= 0);

    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = 0.f;
    for (int c = c_lo; c < c_hi; ++c) {
      float kf[VEC];
      unpack16<TKV>(*reinterpret_cast<const uint4*>(st + key * L.pitch + c * 16), kf);
      if constexpr (kInt8) {
        const float ks = sc[key];
#pragma unroll
        for (int e = 0; e < VEC; ++e) kf[e] *= ks;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4* qv = reinterpret_cast<const float4*>(qs + r * L.hdp + c * VEC);
#pragma unroll
        for (int e = 0; e < VEC / 4; ++e) {
          const float4 qq = qv[e];
          s[r] = fmaf(qq.x, kf[4 * e], s[r]);
          s[r] = fmaf(qq.y, kf[4 * e + 1], s[r]);
          s[r] = fmaf(qq.z, kf[4 * e + 2], s[r]);
          s[r] = fmaf(qq.w, kf[4 * e + 3], s[r]);
        }
      }
    }
    bool valid[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      for (int o = 1; o < tpk; o <<= 1) s[r] += __shfl_xor_sync(0xffffffffu, s[r], o);
      valid[r] = kv_ok && p0 + key < lim[r];
      s[r] = valid[r] ? s[r] * scale : NEG;  // a select: a stale row's value never enters
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
      for (int w = 1; w < PWARPS; ++w) mx = fmaxf(mx, wred[w * R + r]);
      const float m_new = fmaxf(m_run[r], mx);
      corr[r] = expf(m_run[r] - m_new);
      if (sub == 0 && key < tc) ps[r * tc + key] = valid[r] ? expf(s[r] - m_new) : 0.f;
      m_run[r] = m_new;
    }
    __syncthreads();
    if constexpr (kWide) {
      repro_attn::pv_wide<TKV, R>(part + 2 * R, l_run, corr, st + tc * L.pitch, L.pitch, ps, tc,
                                  n, L.chunks, L.hdp, kInt8 ? sc + tc : nullptr, acc);
    } else if (pv) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        l_run[r] *= corr[r];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[r][e] *= corr[r];
      }
      const uint8_t* vt = st + tc * L.pitch + cc * 16;
      for (int j = kg; j < n; j += L.groups) {
        float vf[VEC];
        unpack16<TKV>(*reinterpret_cast<const uint4*>(vt + j * L.pitch), vf);
        if constexpr (kInt8) {
          const float vs = sc[tc + j];
#pragma unroll
          for (int e = 0; e < VEC; ++e) vf[e] *= vs;
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float p = ps[r * tc + j];
          l_run[r] += p;
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[r][e] = fmaf(p, vf[e], acc[r][e]);
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
        for (int e = 0; e < VEC; ++e) red[(kg * R + r) * L.hdp + cc * VEC + e] = acc[r][e];
        if (cc == 0) lred[kg * R + r] = l_run[r];
      }
    }
    __syncthreads();
    for (int e = tid; e < R * L.hdp; e += PTHREADS) {
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
    for (int e = tid; e < rows * hd; e += PTHREADS) {
      const int r = e / hd, c = e - r * hd, gr = r0 + r;
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
      const size_t o = ((size_t)b * T + gr / g) * H + kv * g + gr % g;
      if (p_acc != nullptr) {
        p_acc[o * hd + c] = a;
        if (c == 0) {
          p_m[o] = m;
          p_l[o] = l;
        }
      } else {
        out[o * hd + c] = from_f<TQ>(a / fmaxf(l, 1e-30f));
      }
    }
  }
  cluster.sync();
}

struct PagedArgs {
  const void *q, *k_pool, *v_pool, *k_scale, *v_scale;
  const int *tables, *lengths, *owned;
  void* out;
  float *p_m, *p_l;
  int B, T, H, KV, hd, BS, MB, partials, splits, stages, tile;
  float scale;
  void* stream;
};

template <typename TQ, typename TKV, int R, bool kAsync, bool kWide>
int paged_launch(const PagedArgs& a) {
  const repro_attn::RingLayout L = repro_attn::ring_layout(a.hd, sizeof(TKV), R, a.stages, a.tile);
  if (L.groups < 1) return (int)cudaErrorInvalidValue;
  const int epr = a.BS <= a.tile ? a.tile / a.BS : 1;
  const int spe = a.BS <= a.tile ? 1 : (a.BS + a.tile - 1) / a.tile;
  const int groups = (a.T * (a.H / a.KV) + R - 1) / R;
  return hopper::launch_cluster(
      paged_decode_kernel<TQ, TKV, R, kAsync, kWide>, dim3(a.B, a.KV * groups, a.splits),
      dim3(1, 1, a.splits), PTHREADS, (size_t)L.total + 4 * kTableIds, a.stream, static_cast<const TQ*>(a.q),
      static_cast<const TKV*>(a.k_pool), static_cast<const TKV*>(a.v_pool),
      static_cast<const __nv_bfloat16*>(a.k_scale), static_cast<const __nv_bfloat16*>(a.v_scale),
      a.tables, a.lengths, a.owned, a.partials ? nullptr : static_cast<TQ*>(a.out),
      a.partials ? a.p_m : nullptr, a.partials ? a.p_l : nullptr,
      a.partials ? static_cast<float*>(a.out) : nullptr, a.T, a.H, a.KV, a.hd, a.BS, a.MB,
      a.stages, a.tile, epr, spe, a.scale);
}

template <typename TQ, typename TKV, int R, bool kWide>
int paged_async(const PagedArgs& a, int async) {
  return async ? paged_launch<TQ, TKV, R, true, kWide>(a) : paged_launch<TQ, TKV, R, false, kWide>(a);
}

template <typename TQ, typename TKV, bool kWide>
int paged_typed(const PagedArgs& a, int rows, int async) {
  constexpr bool kInt8 = std::is_same<TKV, int8_t>::value;
  if (async && ((a.hd * sizeof(TKV)) % 16 || reinterpret_cast<uintptr_t>(a.k_pool) % 16 ||
                reinterpret_cast<uintptr_t>(a.v_pool) % 16))
    return (int)cudaErrorInvalidValue;
  switch (rows) {
    case 1: return paged_async<TQ, TKV, 1, kWide>(a, async);
    case 4: return paged_async<TQ, TKV, 4, kWide>(a, async);
    case 8:
      if constexpr (!kInt8) return paged_async<TQ, TKV, 8, kWide>(a, async);
  }
  return (int)cudaErrorInvalidValue;
}

// q_dtype and kv_dtype as the C entry point takes them
template <bool kWide>
int paged_dispatch(const PagedArgs& a, int q_dtype, int kv_dtype, int rows, int async) {
  if (q_dtype == 0 && kv_dtype == 0) return paged_typed<float, float, kWide>(a, rows, async);
  if (q_dtype == 1 && kv_dtype == 1)
    return paged_typed<__nv_bfloat16, __nv_bfloat16, kWide>(a, rows, async);
  if (q_dtype == 0 && kv_dtype == 2) return paged_typed<float, int8_t, kWide>(a, rows, async);
  if (q_dtype == 1 && kv_dtype == 2)
    return paged_typed<__nv_bfloat16, int8_t, kWide>(a, rows, async);
  return (int)cudaErrorInvalidValue;
}

}  // namespace repro_paged
