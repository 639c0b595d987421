// Flash attention for Hopper at head dims 64 and 128: flash_attention.cu
// built as a library of its own (libflash_attention_wide.so), the same C
// entry points with run() taking these two head dims, so that the two
// halves compile in parallel. The note at the top of flash_attention.cu
// covers the fp32 kernels; the bf16 passes at these head dims are
// Hopper's own: the backward and its prologue (kst_flash_prep) are
// flash_backward_wide.cuh's, the forward flash_forward_wide.cuh's, which
// uses the backward's barrier, TMA, descriptor and wgmma helpers.

#define KST_FLASH_WIDE
#include "flash_attention.cu"
#include "flash_backward_wide.cuh"
#include "flash_forward_wide.cuh"
