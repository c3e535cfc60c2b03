// flash_generic.cu's kernels in bf16, an object of their own so that nvcc builds
// the dtypes side by side (flash_generic.cu's header).
#define RANKPO_GEN_T __nv_bfloat16
#define RANKPO_GEN_NAME dispatch_bf16
#include "flash_generic.cu"
