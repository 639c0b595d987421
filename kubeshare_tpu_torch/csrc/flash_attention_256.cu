// Flash attention for Hopper at the instance 256 (head dims 129 to 256;
// Gemma's 256): flash_attention.cu built as a library of its own
// (libflash_attention_256.so), the same C entry points with run() and
// kst_flash_prep taking this instance, so that it compiles beside the
// other two libraries. The fp32 kernels are flash_attention.cu's; the bf16
// passes and the prologue are those of the instances 64 and 128
// (flash_forward_wide.cuh, flash_backward_wide.cuh) with the block split
// by columns that 256 needs (the note at the top of
// flash_backward_wide.cuh).

#define KST_FLASH_256
#include "flash_attention.cu"
#include "flash_backward_wide.cuh"
#include "flash_forward_wide.cuh"
