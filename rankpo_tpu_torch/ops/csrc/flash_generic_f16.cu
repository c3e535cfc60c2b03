// flash_generic.cu's kernels in fp16, an object of their own so that nvcc builds
// the dtypes side by side (flash_generic.cu's header).
#define RANKPO_GEN_T __half
#define RANKPO_GEN_NAME dispatch_f16
#include "flash_generic.cu"
