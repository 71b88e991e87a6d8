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

// The resource record (runtime.cu): off unless the caller turns it on
// (`repro_resource_record`).  While it is on, every launch first notes its
// kernel's attributes (registers, static and local shared memory bytes,
// threads a block at most) and the dynamic shared memory it requests; off,
// a launch costs one branch on this global and no host call.
extern int repro_resource_record_on;
void record_resources(const void* kernel, size_t dynamic);

template <typename Kernel>
inline void note_launch(Kernel kernel, size_t dynamic) {
  if (repro_resource_record_on) {
    record_resources(reinterpret_cast<const void*>(kernel), dynamic);
  }
}

// A block gets 48 KB of shared memory unless its kernel opts in to more
// (up to the device's opt-in limit, 227 KB on an H100).  `bytes` is the
// block's dynamic plus static shared memory, `dynamic` its dynamic part.
// Every launcher that passes dynamic shared memory calls it right before
// its launch, which it also notes in the resource record.
template <typename Kernel>
inline cudaError_t allow_shared_memory(Kernel kernel, size_t bytes,
                                       size_t dynamic) {
  note_launch(kernel, dynamic);
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(dynamic));
}
