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
// and more, operations (4 * hd flops per (query, key) pair against
// 2 * hd * 2 bytes per key), and they reach the card's bf16 rate only on
// the tensor cores through wgmma.
//
// Design, bf16 at hd = 64, 80 or 128 (flash_kernel_wgmma): one thread block per
// (64 query positions, query head, batch row): one consumer warpgroup owns
// the 64 rows, one producer warp issues the TMA loads. Q arrives once; K
// and V tiles of 64 keys arrive into a 2-stage ring, so the next tile
// loads while this one is computed. Per tile: S = Q K^T on wgmma (Q and K
// both K-major in shared memory), the scores masked (the causal diagonal,
// keys past Skv) and folded into the float32 running max m and sum l in
// registers, the row max reduced over the 4 threads that share a row; then
// P is rounded to bf16 in registers, where the score accumulator's
// fragment layout is already wgmma's A-operand layout, and O += P V runs
// on wgmma with V as the N-major B operand. Tiles above the causal
// diagonal are never loaded. At the flush acc / max(l, 1e-30).
// hd = 80 and 128: a row of 160 or 256 bytes is wider than the 128-byte
// swizzle atom, so each of Q, K and V arrives as two TMA boxes, a 64-column
// one (128-byte swizzle) and a tail box after it: 16 columns with a 32-byte
// swizzle at hd 80, or a second 64-column, 128-byte-swizzled box at hd 128.
// S sums 4 + 1 (hd 80) or 4 + 4 (hd 128) k16 slices over the two, and O is
// an n64 plus an n16 accumulator, or two n64 ones. At hd 128 a thread holds
// 64 O, 32 score and 16 P registers, so that instance is built for two
// blocks an SM (~200 registers a thread, no spills) where the others take
// three.
// Filling the card: blocks are independent, ~42 KB (hd 64), ~52 KB (hd 80)
// or ~82 KB (hd 128) of shared memory and 160 threads, so several share an
// SM; the
// g query heads of a kv group are neighbouring blocks and re-read the same
// K/V tiles out of L2. The block index runs over the q-blocks slowest,
// longest causal q-block first, so the short ones fill in behind. At
// smollm's serving prefill (B=1, S=1024, H=9) that is 16 x 9 = 144 blocks,
// all resident at once on the 132 SMs; the time is the longest block's 16
// key tiles.
//
// Design, float32, every other bf16 head size and bf16 q/k/v that are not
// 16-byte aligned (flash_kernel): the CUDA cores, element loads that take
// any head size and alignment. wgmma's float32 inputs are TF32, which
// keeps about three decimal digits; the float32 contract (chip_smoke.py's
// TOL of 2e-5, float32 token parity in serving) needs full float32
// products. One thread block per (BQ
// query positions, batch row, kv head): the g query heads of the kv group
// ride together as BQ * g rows, so one K/V tile in shared memory serves
// all of them. The Pallas grid's sequential kv axis becomes a loop over
// BK-key tiles that stops at the block's causal limit, or at Skv when
// non-causal (a template parameter: with a runtime flag the causal kernel
// ran ~40% slower at smollm's prefill shapes); the ragged last query block
// and key tile are masked. Softmax and the accumulator are float32
// (attention_tile.cuh).
#include "attention_tile.cuh"
#include "hopper.cuh"

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

// ---------------------------------------------------------------------------
// bf16, hd = 64, 80 or 128: TMA-fed wgmma

constexpr int FQ = 64;          // query rows per block (one consumer warpgroup)
constexpr int FK = 64;          // keys per tile
constexpr int F_THREADS = 160;  // warps 0-3 consume, warp 4 loads

// Shared memory of a block, every region 1024-byte aligned: Q, then two
// stages of (K, V). Each of Q, K, V is a [64 x 64] 128-byte-swizzled box
// and, past hd 64, a tail box after it: [64 x 16] 32-byte-swizzled at
// hd = 80, a second [64 x 64] 128-byte-swizzled one at hd = 128.
template <int HD>
struct FlashSmem {
  static_assert(HD == 64 || HD == 80 || HD == 128, "flash_kernel_wgmma: hd 64, 80 or 128");
  static constexpr int kTail = HD - 64;       // columns past the first 64
  static constexpr int kMain = 64 * 64 * 2;   // bytes of the 64-column box
  static constexpr int kTailBytes = 64 * kTail * 2;
  static constexpr int kTailRow = kTail * 2;  // bytes of a tail-box row
  static constexpr hopper::Swizzle kTailSw = kTail == 64 ? hopper::SW128 : hopper::SW32;
  static constexpr int kTile = kMain + kTailBytes;  // one of Q, K, V
  static constexpr int kStage = 2 * kTile;          // K then V
  static constexpr int kBars = kTile + 2 * kStage;  // offset of the barriers
  static constexpr size_t kBytes = 1024 + kBars + 7 * sizeof(uint64_t);
  static constexpr int kOt = kTail > 0 ? kTail / 2 : 1;  // tail O floats a thread
  // blocks an SM the registers must allow: hd 128's 64 O floats a thread
  // would spill under three blocks' ~136-register cap
  static constexpr int kMinBlocks = HD == 128 ? 2 : 3;
};

// O[:, 64:] (+)= P V[:, 64:] for one 16-key slice: the n16 tail (hd 80) or
// the second n64 box (hd 128)
template <int Tail>
__device__ __forceinline__ void flash_pv_tail(float (&ot)[Tail / 2], const uint32_t (&pa)[4],
                                              uint64_t desc) {
  if constexpr (Tail == 64)
    hopper::wgmma_rs_n64<1>(ot, pa, desc, 1);
  else
    hopper::wgmma_rs_n16<1>(ot, pa, desc, 1);
}

template <int HD, bool kCausal>
__global__ void __launch_bounds__(F_THREADS, FlashSmem<HD>::kMinBlocks)
    flash_kernel_wgmma(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap qtail,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap ktail,
                       const __grid_constant__ CUtensorMap vmap,
                       const __grid_constant__ CUtensorMap vtail,
                       __nv_bfloat16* __restrict__ out, int B, int Sq, int Skv, int H, int KV,
                       int q_offset, float scale_log2) {
  using namespace hopper;
  using Sm = FlashSmem<HD>;
  extern __shared__ __align__(1024) uint8_t wg_smem[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(wg_smem) + 1023) &
                                             ~static_cast<uintptr_t>(1023));
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + Sm::kBars);
  uint64_t* k_full = q_full + 1;  // [2]
  uint64_t* v_full = q_full + 3;  // [2]
  uint64_t* empty = q_full + 5;   // [2]

  const int hb = H * B;
  const int nqb = (Sq + FQ - 1) / FQ;
  const int qb = nqb - 1 - (int)(blockIdx.x / hb);  // longest causal q-blocks first
  const int b = (int)(blockIdx.x % hb) / H, h = (int)(blockIdx.x % H);
  const int kvh = h / (H / KV);
  const int q0 = qb * FQ;
  const int kv_end = kCausal ? min(Skv, q_offset + min(q0 + FQ, Sq)) : Skv;
  const int n_tiles = (kv_end + FK - 1) / FK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 4);  // one arrive from each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // the producer warp: lane 0 issues every load
    if (threadIdx.x == 128) {
      mbar_arrive_expect_tx(q_full, Sm::kTile);
      tma_load_4d(smem, &qmap, q_full, 0, h, q0, b);
      if constexpr (Sm::kTail > 0) tma_load_4d(smem + Sm::kMain, &qtail, q_full, 64, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j & 1;
        mbar_wait(&empty[s], ((j >> 1) & 1) ^ 1);
        uint8_t* kt = smem + Sm::kTile + s * Sm::kStage;
        uint8_t* vt = kt + Sm::kTile;
        mbar_arrive_expect_tx(&k_full[s], Sm::kTile);
        tma_load_4d(kt, &kmap, &k_full[s], 0, kvh, j * FK, b);
        if constexpr (Sm::kTail > 0) tma_load_4d(kt + Sm::kMain, &ktail, &k_full[s], 64, kvh, j * FK, b);
        mbar_arrive_expect_tx(&v_full[s], Sm::kTile);
        tma_load_4d(vt, &vmap, &v_full[s], 0, kvh, j * FK, b);
        if constexpr (Sm::kTail > 0) tma_load_4d(vt + Sm::kMain, &vtail, &v_full[s], 64, kvh, j * FK, b);
      }
    }
    return;
  }

  // the consumer warpgroup: thread t holds rows r and r + 8 of the block
  // (the wgmma accumulator layout, hopper.cuh)
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  const int r = 16 * w + l / 4;
  int lim[2];  // the row attends keys < lim
#pragma unroll
  for (int e = 0; e < 2; ++e) lim[e] = kCausal ? min(Skv, q_offset + q0 + r + 8 * e + 1) : Skv;
  // a tile needs the per-element mask where some row of the block stops
  // inside it (the causal diagonal) or where it runs past Skv
  const int lim_min = kCausal ? min(Skv, q_offset + q0 + 1) : Skv;

  float o[32], ot[Sm::kOt], sc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = sc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < Sm::kOt; ++i) ot[i] = 0.f;
  float m_run[2] = {NEG, NEG}, l_run[2] = {0.f, 0.f};

  // Q and K are K-major: rows of 128 (or a tail box's 32 or 128) bytes,
  // 8-row groups 8 rows apart. V is N-major: rows are keys, 8-key groups 8
  // rows apart; each box is one N chunk, so LBO is unused.
  const uint64_t dq = make_desc(smem, 16, 1024, SW128);
  const uint64_t dq_tail = make_desc(smem + Sm::kMain, 16, 8 * Sm::kTailRow, Sm::kTailSw);
  mbar_wait(q_full, 0);

  // Each tile's products are waited for before their registers are
  // touched. Variants that issued the next tile's scores before this
  // tile's softmax (FlashAttention-3's overlap) ran slower: ptxas
  // serialised their wgmma (C7514, C7515).
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j & 1;
    const uint32_t parity = (j >> 1) & 1;
    uint8_t* kt = smem + Sm::kTile + s * Sm::kStage;
    uint8_t* vt = kt + Sm::kTile;

    // S = Q K^T
    mbar_wait(&k_full[s], parity);
    const uint64_t dk = make_desc(kt, 16, 1024, SW128);
    fence_regs(sc);
    wgmma_fence();
    wgmma_ss_n64<0>(sc, dq, dk, 0);
#pragma unroll
    for (int kk = 1; kk < 4; ++kk)
      wgmma_ss_n64<0>(sc, desc_advance(dq, 32 * kk), desc_advance(dk, 32 * kk), 1);
    if constexpr (Sm::kTail > 0) {
      const uint64_t dk_tail = make_desc(kt + Sm::kMain, 16, 8 * Sm::kTailRow, Sm::kTailSw);
#pragma unroll
      for (int kk = 0; kk < Sm::kTail / 16; ++kk)
        wgmma_ss_n64<0>(sc, desc_advance(dq_tail, 32 * kk), desc_advance(dk_tail, 32 * kk), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // mask, then fold the tile into the running max and sum (log2 units)
    const int j0 = j * FK;
    const bool masked = j0 + FK > lim_min;
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int e = (i >> 1) & 1;
      const int col = j0 + 8 * (i >> 2) + 2 * (l % 4) + (i & 1);
      const float x = (masked && col >= lim[e]) ? NEG : sc[i] * scale_log2;
      sc[i] = x;
      mx[e] = fmaxf(mx[e], x);
    }
    float corr[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 1));
      mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 2));
      const float m_new = fmaxf(m_run[e], mx[e]);
      corr[e] = exp2f(m_run[e] - m_new);
      m_run[e] = m_new;
      l_run[e] *= corr[e];
    }
    // P in bf16, the A operand of each 16-key slice; l sums the rounded
    // weights that P V uses, so the output stays their weighted mean
    uint32_t pa[4][4];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int e = (i >> 1) & 1;
      const int col = j0 + 8 * (i >> 2) + 2 * (l % 4);
      const float p0 = (masked && col >= lim[e]) ? 0.f : exp2f(sc[i] - m_run[e]);
      const float p1 = (masked && col + 1 >= lim[e]) ? 0.f : exp2f(sc[i + 1] - m_run[e]);
      const __nv_bfloat162 pb = __floats2bfloat162_rn(p0, p1);
      l_run[e] += __low2float(pb) + __high2float(pb);
      pa[i >> 3][(i >> 1) & 3] = *reinterpret_cast<const uint32_t*>(&pb);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] *= corr[(i >> 1) & 1];
    if constexpr (Sm::kTail > 0) {
#pragma unroll
      for (int i = 0; i < Sm::kOt; ++i) ot[i] *= corr[(i >> 1) & 1];
    }

    // O += P V
    mbar_wait(&v_full[s], parity);
    const uint64_t dv = make_desc(vt, Sm::kMain, 1024, SW128);
    const uint64_t dv_tail = make_desc(vt + Sm::kMain, Sm::kTailBytes, 8 * Sm::kTailRow, Sm::kTailSw);
    fence_regs(o);
    fence_regs(ot);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs_n64<1>(o, pa[kk], desc_advance(dv, 16 * 128 * kk), 1);
      if constexpr (Sm::kTail > 0)
        flash_pv_tail<Sm::kTail>(ot, pa[kk], desc_advance(dv_tail, 16 * Sm::kTailRow * kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(ot);
    if (l == 0) mbar_arrive(&empty[s]);  // this stage's K and V are read
  }

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    l_run[e] += __shfl_xor_sync(0xffffffffu, l_run[e], 1);
    l_run[e] += __shfl_xor_sync(0xffffffffu, l_run[e], 2);
    const float den = fmaxf(l_run[e], 1e-30f);
    const int row = q0 + r + 8 * e;
    if (row >= Sq) continue;
    __nv_bfloat16* dst = out + (((size_t)b * Sq + row) * H + h) * HD + 2 * (l % 4);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<uint32_t*>(dst + 8 * i) =
          pack_bf16(o[4 * i + 2 * e] / den, o[4 * i + 2 * e + 1] / den);
    if constexpr (Sm::kTail > 0) {
#pragma unroll
      for (int i = 0; i < Sm::kTail / 8; ++i)
        *reinterpret_cast<uint32_t*>(dst + 64 + 8 * i) =
            pack_bf16(ot[4 * i + 2 * e] / den, ot[4 * i + 2 * e + 1] / den);
    }
  }
}

// the six TMA descriptors of one call: q, k, v as [B, S, heads, hd]
// tensors (4-d, innermost first), each cut into 64-column boxes of 64 rows
// of one head and, at hd 80, 16-column tail boxes; at hd 128 the tail is
// the 64-column box again, loaded at column 64
static int flash_maps(CUtensorMap (&maps)[6], const void* q, const void* k, const void* v, int B,
               int Sq, int Skv, int H, int KV, int hd) {
  const void* base[3] = {q, k, v};
  const int rows[3] = {Sq, Skv, Skv}, heads[3] = {H, KV, KV};
  for (int t = 0; t < 3; ++t) {
    const uint64_t dims[4] = {(uint64_t)hd, (uint64_t)heads[t], (uint64_t)rows[t], (uint64_t)B};
    const uint64_t strides[3] = {(uint64_t)hd * 2, (uint64_t)heads[t] * hd * 2,
                                 (uint64_t)rows[t] * heads[t] * hd * 2};
    const uint32_t box[4] = {64, 1, FQ, 1}, tail[4] = {16, 1, FQ, 1};
    int err = hopper::encode_tma(&maps[2 * t], base[t], 4, dims, strides, box,
                                 CU_TENSOR_MAP_SWIZZLE_128B);
    if (!err && hd == 80)
      err = hopper::encode_tma(&maps[2 * t + 1], base[t], 4, dims, strides, tail,
                               CU_TENSOR_MAP_SWIZZLE_32B);
    if (err) return err;
    // hd 64: no tail box (passed, never read); hd 128: the same box at column 64
    if (hd != 80) maps[2 * t + 1] = maps[2 * t];
  }
  return 0;
}

static int flash_wgmma(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Skv,
                int H, int KV, int hd, int q_offset, int causal, float scale, void* stream) {
  if ((hd != 64 && hd != 80 && hd != 128) || reinterpret_cast<uintptr_t>(q) % 16 ||
      reinterpret_cast<uintptr_t>(k) % 16 || reinterpret_cast<uintptr_t>(v) % 16)
    return (int)cudaErrorInvalidValue;
  CUtensorMap m[6];
  const int err = flash_maps(m, q, k, v, B, Sq, Skv, H, KV, hd);
  if (err) return err;
  const dim3 grid((unsigned)((Sq + FQ - 1) / FQ) * H * B);
  const float scale_log2 = scale * 1.4426950408889634f;
  auto* o = static_cast<__nv_bfloat16*>(out);
#define REPRO_FLASH_WGMMA(HD, C)                                                             \
  launch<F_THREADS>(flash_kernel_wgmma<HD, C>, grid, FlashSmem<HD>::kBytes, stream, m[0], m[1], \
                    m[2], m[3], m[4], m[5], o, B, Sq, Skv, H, KV, q_offset, scale_log2)
  if (hd == 64) return causal ? REPRO_FLASH_WGMMA(64, true) : REPRO_FLASH_WGMMA(64, false);
  if (hd == 128) return causal ? REPRO_FLASH_WGMMA(128, true) : REPRO_FLASH_WGMMA(128, false);
  return causal ? REPRO_FLASH_WGMMA(80, true) : REPRO_FLASH_WGMMA(80, false);
#undef REPRO_FLASH_WGMMA
}

// ---------------------------------------------------------------------------

// dtype: 0 = float32, 1 = bfloat16. causal: 1 = causal from q_offset,
// 0 = every query attends every key (q_offset unused). wgmma: 1 = the
// bf16 tensor-core kernel (hd 64, 80 or 128, q/k/v 16-byte aligned; the
// wrapper's plan decides), 0 = the CUDA-core kernel (float32 always, and
// every other bf16 input).
// Returns a cudaError_t (0 = launched), or hopper::TMA_REFUSED + the
// driver's CUresult for a refused TMA descriptor.
extern "C" int flash_attention(int dtype, const void* q, const void* k, const void* v,
                               void* out, int B, int Sq, int Skv, int H, int KV,
                               int hd, int q_offset, int causal, float scale, int wgmma,
                               void* stream) {
  if (wgmma)
    return dtype == 1 ? flash_wgmma(q, k, v, out, B, Sq, Skv, H, KV, hd, q_offset, causal,
                                    scale, stream)
                      : (int)cudaErrorInvalidValue;
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
