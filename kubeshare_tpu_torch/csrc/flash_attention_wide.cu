// Flash attention for Hopper at head dims 64 and 128: flash_attention.cu
// built as a library of its own (libflash_attention_wide.so), the same
// kernels and C entry points with run() taking these two head dims, so
// that the two halves compile in parallel. The note at the top of
// flash_attention.cu covers both.

#define KST_FLASH_WIDE
#include "flash_attention.cu"
