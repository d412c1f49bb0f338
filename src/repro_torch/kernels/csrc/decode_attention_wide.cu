// The wide path (kWide) of the single-query flash decode kernel: heads of
// more 16-byte chunks than a block has threads (float32 hd > 512, bf16 >
// 1024). decode_attention.cu says what the kernel computes and holds its C
// entry point; these instances build here, beside the register path's, so
// that nvcc compiles the two at once.
#include "decode_attention.cuh"

template int repro_decode::decode_dispatch<true>(int, const void*, const void*,
                                                 const void*, const int*, void*, int,
                                                 int, int, int, int, int, int, int,
                                                 int, int, float, void*);
