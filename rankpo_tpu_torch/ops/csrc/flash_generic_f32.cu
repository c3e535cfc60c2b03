// flash_generic.cu's kernels in fp32, an object of their own so that nvcc builds
// the dtypes side by side (flash_generic.cu's header).
#define RANKPO_GEN_T float
#define RANKPO_GEN_NAME dispatch_f32
#include "flash_generic.cu"
