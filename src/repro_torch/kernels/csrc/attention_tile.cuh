// Shared pieces of the attention kernels: the type conversions, 16 bytes
// of a K/V row unpacked to float32 (the paged and dense decode kernels),
// and, for the flash kernel's CUDA-core path, the shared-memory layout,
// the online-softmax step over one key tile and the launch helper (the
// matmul kernels use the launch helper too).
//
// The flash tile step: one thread block owns R query rows (the g query
// heads of one kv group times BQ prefill positions). Per key tile it
// (1) scores every (row, key) pair into shared memory, (2) lets one warp
// per row fold the tile into the row's running max m and sum l, turning
// the scores into weights in place, and (3) updates the float32
// accumulator acc = acc * exp(m_old - m_new) + P V. A key tile that is
// masked for a row gives that row weight 0 and rescale exactly 1.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_attn {

constexpr float NEG = -1e30f;  // the JAX package's mask value
constexpr int THREADS = 128;

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes of a row in T (float32, bfloat16 or int8) as float32 values
template <typename T>
__device__ __forceinline__ void unpack16(const uint4& u, float (&v)[16 / sizeof(T)]) {
  const uint32_t word[4] = {u.x, u.y, u.z, u.w};
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = __uint_as_float(word[i]);
  } else if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(word[i] << 16);
      v[2 * i + 1] = __uint_as_float(word[i] & 0xFFFF0000u);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) v[4 * i + k] = (float)((int)(word[i] << (24 - 8 * k)) >> 24);
  }
}

// Dynamic shared memory of a block of the dense and paged decode kernels
// (128 threads), in bytes from its base, for a head of hd elements of
// `elem` bytes (1: an int8 pool), `rows` query rows and a ring of `stages`
// tiles of `tile` keys (kernels/decode_attention.py::decode_layout
// mirrors it). A wide head (more 16-byte chunks than threads) keeps its
// running acc in the block's (m, l, acc) slot, `part`, from the start.
struct RingLayout {
  int chunks;  // 16-byte column chunks of a head's row
  int hdp;     // the row in values, padded to whole chunks
  int groups;  // key groups of P.V: THREADS / chunks, 1 for a wide head (chunks > THREADS)
  int pitch;   // bytes between rows of a tile (16 bytes of padding)
  int scales;  // int8: offset in a stage of the k then v scales / 127, float [2][tile]
  int stage;   // one tile of K then one of V (then the int8 scales)
  int qs, ps, wred, part, total;
};

__host__ __device__ constexpr int round16(int bytes) { return (bytes + 15) / 16 * 16; }

__host__ __device__ inline RingLayout ring_layout(int hd, int elem, int rows, int stages,
                                                  int tile) {
  RingLayout L{};
  L.chunks = (hd * elem + 15) / 16;
  L.hdp = L.chunks * (16 / elem);
  L.groups = L.chunks > THREADS ? 1 : THREADS / L.chunks;
  L.pitch = L.chunks * 16 + 16;
  L.scales = 2 * tile * L.pitch;
  L.stage = L.scales + (elem == 1 ? round16(2 * tile * 4) : 0);
  // the ring, which the end-of-block reduction reuses: [groups][rows][hdp]
  // accumulators then [groups][rows] sums
  const int ring = stages * L.stage;
  const int red = round16(4 * L.groups * rows * (L.hdp + 1));
  L.qs = ring > red ? ring : red;
  L.ps = L.qs + round16(4 * rows * L.hdp);            // q [rows][hdp], float32
  L.wred = L.ps + round16(4 * rows * tile);           // weights [rows][tile]
  L.part = L.wred + round16(4 * (THREADS / 32) * rows);  // warp maxima [warps][rows]
  L.total = L.part + round16(4 * rows * (L.hdp + 2));  // m [rows], l [rows], acc [rows][hdp]
  return L;
}

// P.V of one key tile for a wide head (more 16-byte chunks than the
// block's threads, the ring_layout's one key group): thread t takes
// column chunks t, t + THREADS, ..., each over every key of the tile in
// order, its R rows' float32 accumulators held in the block's part slot
// acc_s [R][hdp] (registers cannot hold a whole wide row) and rescaled by
// corr first; thread 0 keeps the running sums l. The same operations in
// the same order as the register path at one key group. vt: the tile's
// V rows at `pitch` bytes; ps: the weights [R][bk]; vscale: an int8
// pool's V scales / 127 of the tile (null for a float pool); a: the
// register path's accumulators, unused by a wide head, as scratch (so the
// kernel needs no registers beyond the register path's).
template <typename T, int R>
__device__ __forceinline__ void pv_wide(float* acc_s, float (&l_run)[R], const float (&corr)[R],
                                        const uint8_t* vt, int pitch, const float* ps, int bk,
                                        int n, int chunks, int hdp, const float* vscale,
                                        float (&a)[R][16 / sizeof(T)]) {
  constexpr int VEC = 16 / sizeof(T);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) l_run[r] *= corr[r];
    for (int j = 0; j < n; ++j)
#pragma unroll
      for (int r = 0; r < R; ++r) l_run[r] += ps[r * bk + j];
  }
  for (int c = threadIdx.x; c < chunks; c += THREADS) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int i = 0; i < VEC; ++i) a[r][i] = acc_s[r * hdp + c * VEC + i] * corr[r];
    for (int j = 0; j < n; ++j) {
      float vf[VEC];
      unpack16<T>(*reinterpret_cast<const uint4*>(vt + j * pitch + c * 16), vf);
      if (vscale != nullptr) {
        const float vs = vscale[j];
#pragma unroll
        for (int i = 0; i < VEC; ++i) vf[i] *= vs;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float p = ps[r * bk + j];
#pragma unroll
        for (int i = 0; i < VEC; ++i) a[r][i] = fmaf(p, vf[i], a[r][i]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc_s[r * hdp + c * VEC + i] = a[r][i];
  }
}

// Shared-memory workspace for R rows against key tiles of BK keys.
struct Smem {
  float* q;     // [R][hd]
  float* acc;   // [R][hd]
  float* s;     // [R][BK] scores, then weights
  float* k;     // [BK][hd + 1] (padded: threads of a warp read different keys)
  float* v;     // [BK][hd]
  float* m;     // [R] running max
  float* l;     // [R] running sum
  float* corr;  // [R] this tile's rescale
  int* lim;     // [R] row attends key positions < lim
};

inline size_t smem_bytes(int R, int BK, int hd) {
  return sizeof(float) * ((size_t)2 * R * hd + (size_t)R * BK +
                          (size_t)BK * (hd + 1) + (size_t)BK * hd + 3 * (size_t)R) +
         sizeof(int) * (size_t)R;
}

__device__ inline Smem carve(char* base, int R, int BK, int hd) {
  Smem sm;
  float* f = reinterpret_cast<float*>(base);
  sm.q = f;
  f += R * hd;
  sm.acc = f;
  f += R * hd;
  sm.s = f;
  f += R * BK;
  sm.k = f;
  f += BK * (hd + 1);
  sm.v = f;
  f += BK * hd;
  sm.m = f;
  f += R;
  sm.l = f;
  f += R;
  sm.corr = f;
  f += R;
  sm.lim = reinterpret_cast<int*>(f);
  return sm;
}

__device__ inline void init_rows(Smem sm, int R, int hd) {
  for (int i = threadIdx.x; i < R * hd; i += blockDim.x) sm.acc[i] = 0.f;
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    sm.m[r] = NEG;
    sm.l[r] = 0.f;
  }
}

// Fold one key tile into every row. The tile's keys sit at positions
// pos0 .. pos0 + BK - 1; sm.k / sm.v hold the first n of them (loaded and
// synchronised by the caller). Keys at j >= n or at positions >= lim[r]
// are masked for row r.
__device__ inline void tile_step(Smem sm, int R, int BK, int hd, int pos0, int n,
                                 float scale) {
  const int hp = hd + 1;
  for (int idx = threadIdx.x; idx < R * BK; idx += blockDim.x) {
    const int r = idx / BK, j = idx - r * BK;
    float sc = NEG;
    if (j < n && pos0 + j < sm.lim[r]) {
      const float* qr = sm.q + r * hd;
      const float* kj = sm.k + j * hp;
      float d = 0.f;
      for (int c = 0; c < hd; ++c) d = fmaf(qr[c], kj[c], d);
      sc = d * scale;
    }
    sm.s[idx] = sc;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  for (int r = warp; r < R; r += nw) {
    float* sr = sm.s + r * BK;
    float mx = NEG;
    for (int j = lane; j < BK; j += 32) mx = fmaxf(mx, sr[j]);
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_prev = sm.m[r];
    const float m_new = fmaxf(m_prev, mx);
    float sum = 0.f;
    for (int j = lane; j < BK; j += 32) {
      const bool valid = j < n && pos0 + j < sm.lim[r];
      const float p = valid ? expf(sr[j] - m_new) : 0.f;
      sr[j] = p;
      sum += p;
    }
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) {
      const float c = expf(m_prev - m_new);
      sm.corr[r] = c;
      sm.l[r] = sm.l[r] * c + sum;
      sm.m[r] = m_new;
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < R * hd; idx += blockDim.x) {
    const int r = idx / hd, c = idx - r * hd;
    const float* pr = sm.s + r * BK;
    float pv = 0.f;
    for (int j = 0; j < n; ++j) pv = fmaf(pr[j], sm.v[j * hd + c], pv);
    sm.acc[idx] = sm.acc[idx] * sm.corr[r] + pv;
  }
  __syncthreads();
}

// Launch on `stream` with `smem` bytes of dynamic shared memory (raising
// the kernel's limit above the 48 KB default when needed) and return the
// launch's error code: a refused launch never runs, and a later
// synchronise would not report it.
template <int Threads = THREADS, typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, size_t smem, void* stream, Args... args) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, Threads, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace repro_attn
