// flash_bwd.cu's kernels at head_dim 256 (K2, K3a, K3b), an object of their own
// so that nvcc builds the head dims side by side (flash_bwd.cu's header).
#define RANKPO_BWD_D 256
#include "flash_bwd.cu"
