// Block-paged flash decode / verify attention for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// kernels/paged_decode_attention.py::paged_decode_attention (_paged_kernel),
// for T >= 1 queries over float32 or bfloat16 pools, and its int8 mode:
// int8 pools with per-vector bfloat16 scales, dequantized in the kernel,
// and its partials mode for the kv-sequence split: an `owned` [B,MB] mask
// whose zero entries are skipped, and the unnormalised float32 triple
// (m, l, acc) as the result.
//
// What it computes: q [B,T,H,hd]; pools [NB,BS,KV,hd]; tables [B,MB] int32
// block ids; lengths [B] int32 committed lengths. Query t of row b attends
// key positions < lengths[b] + t + 1, gathered block by block through the
// row's table; the result is [B,T,H,hd] in q's type. In the int8 mode the
// scales are [NB,BS,KV] and each key or value element is used as
// float(int8) * (float(scale) / 127), the Pallas kernel's dequant. In the
// partials mode the result is m, l [B,T,H] and acc [B,T,H,hd], all
// float32 whatever q's type: the max over the attended keys of owned
// blocks, the sum of exp(score - m) and the sum of exp(score - m) v; a
// query row with no such key gives exactly (-1e30, 0, 0), which the
// cross-rank combine scales to 0.
//
// What bounds it on the H100: memory. Each KV byte is read once and used
// for T*g query rows (g = H / KV: 3 for smollm-135m, 1 for zamba2-2.7b),
// far below the ~295 operations per byte at which the tensor cores would
// become the limit. The int8 mode halves the KV bytes of a bf16 pool, plus
// 4 bytes of scales per (key, kv head). So the design keeps bytes in
// flight at every moment and spends few instructions per key, as the
// dense decode kernel (decode_attention.cu) does.
//
// Design. The Pallas grid (B, KV, MB) with the table axis sequential
// becomes one thread block of 128 threads per (row, kv head, group of up
// to R of its T*g query rows, split); the splits of a (row, kv head,
// group) form one thread-block cluster (at most 8 blocks). A row's table
// is cut into tiles of about 64 keys: where BS < 64 (the paged layout,
// BS = 16) a tile gathers 64 / BS table entries from their pool blocks;
// where BS > 64 (the slot layout's 256-key identity-table blocks) it is a
// 64-key slice of one entry. Tile i goes to split i mod splits: a fixed
// rule that depends on neither T nor the lengths, so every split of a
// long row has work and a short row leaves splits idle, never unbalanced
// (kernels/paged_decode_attention.py::paged_plan picks the splits from
// the pool's shape for the card's occupancy). A block first reads the
// pool block ids of its tiles into shared memory, one load each, all at
// once, so that no copy waits on a table read. Tiles wholly at or past the
// last query's window are never read. K and V tiles stay in the pool's
// type (int8 as raw bytes, with their scales / 127 in float32 beside
// them) and arrive by 16-byte cp.async copies into a 2-4-stage ring, rows
// padded by 16 bytes against bank conflicts; the next tiles load while
// this one is computed. Where a head's row is not a 16-byte multiple or a
// pool is not 16-byte aligned (int8 at hd 72, say), the same kernel
// stages with element loads (kAsync false). Keys of unowned entries are
// not read: their rows are written as zeros and masked. Per tile:
// - scores: 128 / tile threads per key, each taking a run of the head's
//   16-byte chunks against q (float32, in shared memory), joined by
//   shuffles; a key masked for a row (past the row's window, unowned, or
//   past the tile) scores -1e30 by a select;
// - the tile's max per row over the block, the running max m and the
//   rescale exp(m_old - m_new); the weights p = exp(s - m) in float32, 0
//   where masked;
// - P.V: thread t owns one 16-byte column chunk of V and every
//   (128 / chunks)-th key of the tile, with float32 accumulators and its
//   part of the running sum l in registers, rescaled at each tile; a
//   head wider than 128 chunks (float32 hd > 512, bf16 > 1024, int8 >
//   2048) loops its chunks instead, thread t taking chunks t, t + 128, ...
//   over every key, the accumulators in shared memory
//   (attention_tile.cuh::pv_wide), and the copies loop the chunks too.
// At the end each block sums its threads' partials in key-group order
// into (m, l, acc) in shared memory, and rank 0 of the cluster combines
// the splits in split order over distributed shared memory, scaling each
// by exp(m_split - m), or by 0 for a split that saw no key (m at the
// -1e30 sentinel), then divides and rounds once, or in the partials mode
// writes (m, l, acc): one launch, no workspace, and a result that does
// not depend on timing.
//
// Verify equals decode bitwise. Each query row reduces over the same
// tiles of the same splits in the same order whatever T is, and its
// arithmetic does not depend on the other rows of its block. A tile
// that verify reads past query t's window (inside query T-1's) gives
// that row scores of -1e30 and weights of 0: the running max stays, the
// rescale is exactly 1, and adding 0 * v leaves l and acc as they were;
// a split that sees only such tiles keeps the -1e30 sentinel and weighs
// 0 at the combine, as the same split does in decode, where it reads
// nothing. Table entries of dead rows point at the pool's null block, a
// real slot, so every read is in bounds.
//
// The templates are in paged_decode_attention.cuh. This file instantiates
// the register path (heads of at most 128 16-byte chunks) and holds the C
// entry point; paged_decode_attention_wide.cu instantiates the wide path.
#include "paged_decode_attention.cuh"

extern template int repro_paged::paged_dispatch<true>(const repro_paged::PagedArgs&, int, int, int, int);
template int repro_paged::paged_dispatch<false>(const repro_paged::PagedArgs&, int, int, int, int);

// q_dtype: 0 = float32, 1 = bfloat16 (q and out). kv_dtype: 0 = float32,
// 1 = bfloat16 (the same type as q), 2 = int8 with bfloat16 scales
// [NB,BS,KV] (null otherwise). owned: [B,MB] int32, 0 = skip the entry, or
// null (every entry). partials = 0: out [B,T,H,hd] in q's type, p_m / p_l
// unused; partials = 1: out is acc [B,T,H,hd] float32 and p_m, p_l [B,T,H]
// float32 take m and l. rows: query rows a block takes (1, 4, or 8 over
// float pools; T * g above it runs in groups); splits: blocks (one
// cluster, 1-8) that share a row's tiles; stages: the ring's depth (1-4);
// tile: keys a tile holds at most (64, 32 or 16); async: 1 = 16-byte
// cp.async copies (hd * element size a multiple of 16, pools 16-byte
// aligned), 0 = element loads. The wrapper's plan
// (kernels/paged_decode_attention.py::paged_plan) decides them. Returns a
// cudaError_t (0 = launched).
extern "C" int paged_decode_attention(int q_dtype, int kv_dtype, const void* q,
                                      const void* k_pool, const void* v_pool,
                                      const void* k_scale, const void* v_scale,
                                      const int* tables, const int* lengths,
                                      const int* owned, void* out, float* p_m, float* p_l,
                                      int B, int T, int H, int KV, int hd, int BS, int MB,
                                      int partials, int rows, int splits, int stages, int tile,
                                      int async, float scale, void* stream) {
  if ((partials && (p_m == nullptr || p_l == nullptr)) || splits < 1 || splits > 8 ||
      stages < 1 || stages > 4 || (tile != 64 && tile != 32 && tile != 16) || KV < 1 ||
      H % KV || BS < 1 || MB < 1 ||
      (kv_dtype == 2 && (k_scale == nullptr || v_scale == nullptr)))
    return (int)cudaErrorInvalidValue;
  const repro_paged::PagedArgs a{q,  k_pool, v_pool, k_scale, v_scale, tables,   lengths, owned,
                                 out, p_m,   p_l,    B,       T,       H,        KV,      hd,
                                 BS, MB,     partials, splits, stages, tile,     scale,   stream};
  const int kv_size = kv_dtype == 0 ? 4 : kv_dtype == 1 ? 2 : 1;
  if (repro_attn::ring_layout(hd, kv_size, 1, 1, tile).chunks > repro_paged::PTHREADS)
    return repro_paged::paged_dispatch<true>(a, q_dtype, kv_dtype, rows, async);
  return repro_paged::paged_dispatch<false>(a, q_dtype, kv_dtype, rows, async);
}
