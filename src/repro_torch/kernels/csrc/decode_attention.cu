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
// tensor cores would become the limit. So the design keeps bytes in
// flight at every moment and spends few instructions per key.
//
// Design: the Pallas grid (B, KV, S/bk) with the cache axis sequential
// becomes one thread block of 128 threads per (row, kv head, group of up
// to R of its g query heads, split of the keys); the splits of a (row,
// head, group) form one thread-block cluster (at most 8 blocks), and the
// row's live key tiles (below cache_len) are dealt out to
// them in equal contiguous runs, so no block of a cluster waits long for
// the others at the combine (kernels/decode_attention.py::decode_plan
// picks the splits for the card's occupancy). Tiles at or past cache_len
// are never read. K and V tiles stay in the cache's type and arrive by
// 16-byte cp.async copies into a 2-4-stage ring (a tile is 64 keys; a
// head too wide for that ring in 227 KB takes 32- or 16-key tiles, and
// past those one stage, which the plan picks), the rows padded by 16
// bytes so that reads of different keys' rows do not share banks; the
// next tiles load while this one is computed. Per tile:
// - scores: 128 / tile threads per key (two for 64-key tiles), each
//   taking a run of the head's 16-byte chunks with shared-memory reads
//   against q (float32, in shared memory), joined by shuffles: all 128
//   threads score;
// - the tile's max over the block (warp shuffles, then 4 warps through
//   shared memory), the running max m and the rescale exp(m_old - m_new);
//   the weights p = exp(s - m) into shared memory, in float32;
// - P.V: thread t owns one 16-byte column chunk of V and every
//   (128 / chunks)-th key of the tile, with float32 accumulators (and its
//   part of the running sum l) in registers, rescaled at each tile; a
//   head wider than 128 chunks (float32 hd > 512, bf16 hd > 1024) loops
//   its chunks instead, thread t taking chunks t, t + 128, ... over every
//   key, the accumulators in shared memory (attention_tile.cuh::pv_wide):
//   any hd whose ring of one 16-key tile fits in 227 KB runs.
// Three block barriers a tile; none of them waits for the copies in
// flight. At the end each block sums its threads' partials in key-group
// order into (m, l, acc) in shared memory, and rank 0 of the cluster
// combines the splits in split order over distributed shared memory,
// scaling each by exp(m_split - m) (by 0 for a split that saw no key,
// whose m is the -1e30 sentinel), as the kv-sequence split's distributed
// softmax does, then divides and rounds once: one launch, no workspace,
// and a result that does not depend on timing. Where the cache rows are
// not 16-byte multiples or aligned, the same kernel stages the tiles with
// element loads (kAsync false).
//
// The templates are in decode_attention.cuh. This file instantiates the
// register path (heads of at most 128 16-byte chunks) and holds the C
// entry point; decode_attention_wide.cu instantiates the wide path.
#include "decode_attention.cuh"

#define REPRO_DISPATCH_SIG                                                       \
  (int, const void*, const void*, const void*, const int*, void*, int, int, int, int, \
   int, int, int, int, int, int, float, void*)
extern template int repro_decode::decode_dispatch<true> REPRO_DISPATCH_SIG;
template int repro_decode::decode_dispatch<false> REPRO_DISPATCH_SIG;
#undef REPRO_DISPATCH_SIG

// dtype: 0 = float32, 1 = bfloat16 (q, caches and out). rows: query heads
// a block takes (1, 4 or 8; g = H / KV above it runs in groups); splits:
// blocks (one cluster, 1-8) that share a (row, kv head, group)'s key
// tiles; stages: the K/V ring's depth (1-4); bk: keys a tile (64, 32 or
// 16); async: 1 = 16-byte cp.async
// copies (hd * sizeof(T) a multiple of 16, caches 16-byte aligned), 0 =
// element loads. The wrapper's plan (kernels/decode_attention.py::
// decode_plan) decides them. Returns a cudaError_t (0 = launched).
extern "C" int decode_attention(int dtype, const void* q, const void* k_cache,
                                const void* v_cache, const int* cache_len, void* out, int B,
                                int Smax, int H, int KV, int hd, int rows, int splits,
                                int stages, int bk, int async, float scale, void* stream) {
#define REPRO_DECODE_ARGS                                                                  \
  dtype, q, k_cache, v_cache, cache_len, out, B, Smax, H, KV, hd, rows, splits, stages, bk, \
      async, scale, stream
  if (repro_attn::ring_layout(hd, dtype == 0 ? 4 : 2, 1, 1, bk).chunks > repro_decode::DTHREADS)
    return repro_decode::decode_dispatch<true>(REPRO_DECODE_ARGS);
  return repro_decode::decode_dispatch<false>(REPRO_DECODE_ARGS);
#undef REPRO_DECODE_ARGS
}
