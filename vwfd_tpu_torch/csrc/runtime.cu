// Error reporting for the ctypes wrappers: the text of a cudaError_t code.
#include "common.cuh"

extern "C" const char* vwfd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
