// The message of a CUDA error code, for the wrappers of every kernel's
// `*_launch` (drt_tpu_torch/kernels.py: `check`).

#include <cuda_runtime.h>

extern "C" const char* drt_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
