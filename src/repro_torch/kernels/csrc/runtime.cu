// Error text for the codes the launchers return, from the same CUDA
// runtime that produced them; and the resource record (common.cuh).
#include <cuda.h>  // CUfunction; cuFuncGetName comes from
                   // cudaGetDriverEntryPoint, so nothing links libcuda
#include <mutex>
#include <string.h>

#include "common.cuh"

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int repro_resource_record_on = 0;

namespace {

// One launch's resources, as `repro_resource_record_entry` copies it out
// (kernels/_build.py and analysis/resources.py read this layout).
struct ResourceEntry {
  char name[240];        // the kernel's mangled name ("" if unknown)
  int registers;         // a thread
  int static_bytes;      // static shared memory a block
  int local_bytes;       // local memory a thread (stack and spills)
  int max_threads;       // threads a block at most
  long long dynamic_bytes;   // dynamic shared memory requested
};

constexpr int kMaxEntries = 8192;
ResourceEntry g_entries[kMaxEntries];
int g_count = 0;
std::mutex g_lock;

using GetName = CUresult (*)(const char**, CUfunction);

// The driver's cuFuncGetName (CUDA 12.3), looked up once; null if absent.
GetName get_name() {
  static const GetName fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuFuncGetName", &p, 12030, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuFuncGetName", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) {
      cudaGetLastError();
      p = nullptr;
    }
    return reinterpret_cast<GetName>(p);
  }();
  return fn;
}

}  // namespace

void record_resources(const void* kernel, size_t dynamic) {
  ResourceEntry e = {};
  cudaFuncAttributes attrs = {};
  bool failed = cudaFuncGetAttributes(&attrs, kernel) != cudaSuccess;
  e.registers = attrs.numRegs;
  e.static_bytes = static_cast<int>(attrs.sharedSizeBytes);
  e.local_bytes = static_cast<int>(attrs.localSizeBytes);
  e.max_threads = attrs.maxThreadsPerBlock;
  e.dynamic_bytes = static_cast<long long>(dynamic);
  cudaFunction_t fn = nullptr;
  const GetName name_of = get_name();
  if (name_of != nullptr && cudaGetFuncBySymbol(&fn, kernel) == cudaSuccess) {
    const char* name = nullptr;
    if (name_of(&name, reinterpret_cast<CUfunction>(fn)) == CUDA_SUCCESS &&
        name != nullptr) {
      strncpy(e.name, name, sizeof(e.name) - 1);
    }
  } else {
    failed = failed || name_of != nullptr;
  }
  // the launch that follows reads cudaGetLastError: leave no error of ours
  if (failed) cudaGetLastError();
  std::lock_guard<std::mutex> hold(g_lock);
  if (g_count < kMaxEntries) g_entries[g_count++] = e;
}

// Turn the record on (emptied) or off; returns the entry size in bytes.
extern "C" int repro_resource_record(int on) {
  std::lock_guard<std::mutex> hold(g_lock);
  if (on) g_count = 0;
  repro_resource_record_on = on;
  return static_cast<int>(sizeof(ResourceEntry));
}

extern "C" int repro_resource_record_count() {
  std::lock_guard<std::mutex> hold(g_lock);
  return g_count;
}

// Copy entry `i` to `out` (sizeof(ResourceEntry) bytes); 0, or -1 past
// the end.
extern "C" int repro_resource_record_entry(int i, void* out) {
  std::lock_guard<std::mutex> hold(g_lock);
  if (i < 0 || i >= g_count) return -1;
  memcpy(out, &g_entries[i], sizeof(ResourceEntry));
  return 0;
}
