// Hopper (sm_90a) building blocks shared by the port's kernels, as inline
// PTX: TMA tile loads into shared memory that complete on an mbarrier, the
// mbarrier itself, 16-byte cp.async copies, wgmma shared-memory
// descriptors for swizzled tiles, and bf16 wgmma.mma_async with float32
// accumulators at the widths the matmul and flash kernels use. Also the
// host half: a TMA descriptor encoded with cuTensorMapEncodeTiled, which
// is a driver API; it is looked up through cudaGetDriverEntryPoint, so the
// library links no -lcuda; and a launch in thread-block clusters.
//
// Layout conventions (PTX ISA, "Matrix Descriptor Format" and the
// canonical wgmma layouts; every tile base here is 1024-byte aligned):
// - A TMA box whose inner extent is 128 bytes (64 bf16), loaded with
//   CU_TENSOR_MAP_SWIZZLE_128B, lands as rows of 128 bytes whose 16-byte
//   chunks are XOR-ed with (row % 8): the wgmma 128-byte swizzle.
//   A 32-byte inner extent (16 bf16) with SWIZZLE_32B is its 32-byte kin.
// - K-major operand (the contraction dimension contiguous: x for the
//   matmul, Q and K for attention scores): rows of the tile are M (or N)
//   and SBO is the byte step between groups of 8 rows (8 * row bytes);
//   LBO is unused. The k-th 16-deep slice starts 32 * k bytes into the
//   row (the hardware applies the swizzle to the absolute address).
// - MN-major operand (M or N contiguous: w [K,N] for the matmul, V for
//   P.V): rows of the tile are K; SBO is the byte step between groups of
//   8 K-rows, LBO the byte step between 64-wide (128-byte) chunks of N.
//   The k-th 16-deep slice starts 16 * k rows in. wgmma reads it with its
//   transpose bit set.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// A TMA descriptor the driver refused comes back from an entry point as
// TMA_REFUSED + its CUresult (kernels/_build.py decodes it); above every
// cudaError_t value.
constexpr int TMA_REFUSED = 1 << 20;
constexpr int TMA_NO_ENTRY_POINT = TMA_REFUSED + 0xFFFF;

enum Swizzle : int { SW128 = 1, SW32 = 3 };  // wgmma descriptor layout types

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarrier

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// make the initialised barriers visible to the other threads and to the
// async proxy (TMA) before anyone uses them; follow with __syncthreads()
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// one arrival that also announces `bytes` of TMA traffic to come
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed. A fresh barrier
// counts its (non-existent) previous phase, parity 1, as complete, so a
// producer's first wait on an "empty" barrier with parity 1 passes.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// ---------------------------------------------------------------------------
// TMA: one thread copies a whole box of a tensor into shared memory; the
// copy's bytes complete on `bar` (which must expect them). Coordinates are
// in elements, innermost first; parts of the box outside the tensor are
// filled with zeros (and still count as bytes).

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// ---------------------------------------------------------------------------
// cp.async: each thread copies 16 bytes (both addresses 16-byte aligned)
// into shared memory without holding a register; a thread's copies are
// committed in groups and waited for by group.

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the same with a run-time count, at most 2 (deeper rings wait for 2)
__device__ __forceinline__ void cp_async_wait_for(int pending) {
  if (pending >= 2)
    cp_async_wait<2>();
  else if (pending == 1)
    cp_async_wait<1>();
  else
    cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// wgmma

// The 64-bit shared-memory matrix descriptor: start address, leading and
// stride byte offsets (each >> 4), base offset 0 (every tile base is
// aligned to its swizzle pattern), layout type in bits 62-63.
__device__ __forceinline__ uint64_t make_desc(const void* tile, uint32_t lbo_bytes,
                                              uint32_t sbo_bytes, Swizzle swizzle) {
  uint64_t d = (smem_u32(tile) & 0x3FFFF) >> 4;
  d |= (uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo_bytes >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)swizzle << 62;
  return d;
}

// a descriptor moved `bytes` further into its tile (a multiple of 16)
__device__ __forceinline__ uint64_t desc_advance(uint64_t desc, uint32_t bytes) {
  return desc + (bytes >> 4);
}

// order the registers' and shared memory's earlier writes before the
// wgmma that follow (before the first of a batch, and after the
// accumulators or A fragments were touched by ordinary instructions)
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed groups of this warp are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep accumulators in registers across the asynchronous wgmma: the
// compiler must not move their reads or writes past a wait
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Move registers from the producer warpgroup to the consumer warpgroups
// (the whole warpgroup executes it; values are multiples of 8).
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Accumulator fragment of m64nNk16 (float32): thread t of the warpgroup
// (warp w = t / 32, lane l = t % 32) holds, for i < N / 8,
//   d[4i + 0], d[4i + 1]: row 16w + l/4,     columns 8i + 2(l%4) + {0, 1}
//   d[4i + 2], d[4i + 3]: row 16w + l/4 + 8, the same columns.
// The register A operand of an m64nNk16 slice has the same layout over its
// 16 columns, so d[8k .. 8k+7] of one product, packed to bf16 pairs, is A
// for the k-th 16-deep slice of the next.

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64], A and B in shared memory.
template <int TransB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TransB));
}

// D[64 x 128] (+)= A[64 x 16] * B[16 x 128], A and B in shared memory.
template <int TransB>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TransB));
}

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64], A in registers (four bf16x2 a
// thread, the accumulator's fragment layout), B in shared memory.
template <int TransB>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                           uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TransB));
}

// D[64 x 16] (+)= A[64 x 16] * B[16 x 16], A in registers (four bf16x2 a
// thread, the accumulator's fragment layout), B in shared memory.
template <int TransB>
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4],
                                           uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TransB));
}

// ---------------------------------------------------------------------------
// host: TMA descriptors

inline PFN_cuTensorMapEncodeTiled_v12000 encode_tiled_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p)
               : nullptr;
  }();
  return fn;
}

// A tensor of `rank` dimensions (innermost first: sizes in elements,
// strides of dimensions 1.. in bytes) of `type` (bf16 unless said) cut into
// boxes of `box` elements, landing in shared memory with `swizzle`. Returns
// 0, or TMA_REFUSED + the driver's CUresult.
inline int encode_tma(CUtensorMap* map, const void* base, uint32_t rank, const uint64_t* dims,
                      const uint64_t* strides, const uint32_t* box, CUtensorMapSwizzle swizzle,
                      CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  const auto fn = encode_tiled_fn();
  if (fn == nullptr) return TMA_NO_ENTRY_POINT;
  const uint32_t elem_strides[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(map, type, rank, const_cast<void*>(base),
                        dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : TMA_REFUSED + (int)r;
}

// ---------------------------------------------------------------------------
// host: a launch in thread-block clusters of `cluster` blocks (at most 8,
// the portable size), `threads` a block, `smem` bytes of dynamic shared
// memory (raising the kernel's limit above the 48 KB default when needed),
// on `stream`. Returns the launch's cudaError_t: a refused launch never
// runs, and a later synchronise would not report it.
template <typename... Params, typename... Args>
int launch_cluster(void (*kernel)(Params...), dim3 grid, dim3 cluster, int threads, size_t smem,
                   void* stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster.x;
  attr[0].val.clusterDim.y = cluster.y;
  attr[0].val.clusterDim.z = cluster.z;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace hopper
