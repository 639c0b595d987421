// Flash attention for Hopper at the instances 64 and 128 (head dims 33 to
// 128): flash_attention.cu built as a library of its own
// (libflash_attention_wide.so), the same C entry points with run() taking
// these two instances, so that the libraries compile in parallel. The
// note at the top of flash_attention.cu covers the fp32 kernels; the bf16
// passes at these instances are Hopper's own: the backward and its
// prologue (kst_flash_prep) are flash_backward_wide.cuh's, the forward
// flash_forward_wide.cuh's, which uses the backward's barrier, TMA,
// descriptor and wgmma helpers. flash_attention_256.cu builds the same
// sources for the instance 256.

#define KST_FLASH_WIDE
#include "flash_attention.cu"
#include "flash_backward_wide.cuh"
#include "flash_forward_wide.cuh"
