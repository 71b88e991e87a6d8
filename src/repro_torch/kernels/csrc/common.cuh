// Shared launch plumbing for the port's kernels.
//
// Every kernel is reached through an `extern "C"` launcher that takes raw
// device pointers, the device index and the caller's stream (PyTorch's
// current stream, passed as a void*), launches without synchronising and
// returns the cudaError_t of the launch as an int: 0 when the launch was
// accepted.  The Python wrapper raises on anything else.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Deepest oblivious tree the kernels take (CatBoost's own cap).  Leaf
// indexes are assembled in an int, one bit per level.
constexpr int kMaxDepth = 16;

// The launcher's own CUDA runtime keeps its own current device, so each
// launch names the device its tensors live on.
inline cudaError_t select_device(int device) { return cudaSetDevice(device); }

inline int launch_status() { return static_cast<int>(cudaGetLastError()); }

// A block gets 48 KB of shared memory unless its kernel opts in to more
// (up to the device's opt-in limit, 227 KB on an H100).  `bytes` is the
// block's dynamic plus static shared memory, `dynamic` its dynamic part.
template <typename Kernel>
inline cudaError_t allow_shared_memory(Kernel kernel, size_t bytes,
                                       size_t dynamic) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(dynamic));
}
