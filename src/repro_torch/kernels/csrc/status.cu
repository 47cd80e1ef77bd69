// Error text for the status codes the kernels' C functions return.
#include <cuda_runtime.h>

extern "C" const char* aco_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
