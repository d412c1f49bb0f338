// The wide path (kWide) of the block-paged decode / verify kernel: heads
// of more 16-byte chunks than a block has threads (float32 hd > 512, bf16
// > 1024, int8 > 2048). paged_decode_attention.cu says what the kernel
// computes and holds its C entry point; these instances build here, beside
// the register path's, so that nvcc compiles the two at once.
#include "paged_decode_attention.cuh"

template int repro_paged::paged_dispatch<true>(const repro_paged::PagedArgs&, int, int, int, int);
