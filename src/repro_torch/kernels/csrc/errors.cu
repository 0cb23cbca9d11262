// cudaGetErrorString for the ctypes wrappers, which have no CUDA runtime
// binding of their own.
#include <cuda_runtime.h>

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
