// flash_fwd.cu's kernels at 256 columns (head dims 129-256), compiled by an
// nvcc of their own beside flash_fwd.cu's 32, 64 and 128 (flash_common.cuh).
#define QT_FLASH_WIDE
#include "flash_fwd.cu"
