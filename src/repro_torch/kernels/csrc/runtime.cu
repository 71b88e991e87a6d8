// Error text for the codes the launchers return, from the same CUDA
// runtime that produced them.
#include "common.cuh"

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
