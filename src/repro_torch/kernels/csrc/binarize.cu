// Feature binarization: bins[n, f] = #{b : x[n, f] > borders[b, f]}.
//
// Replaces the TPU kernel src/repro/kernels/binarize.py:binarize
// (_binarize_kernel, the compare-accumulate over the border axis).
//
// The compare is strict '>', so NaN (which compares false) lands in bin 0
// and the +inf rows that pad a short border column are never crossed.
// The count does not assume sorted borders, like the reference.
//
// What bounds it on an H100: the bytes are 4 B of x read and 1 B (uint8)
// or 4 B (int32) of bins written per element.  Counting with B compares an
// element (63 at 63 borders) makes it issue-bound instead.  So:
//   * every border column the port builds is sorted (nondecreasing:
//     np.unique of quantiles, padded with +inf), and on such a column the
//     count is the number of borders `< x`, a prefix, found by a binary
//     search in ceil(log2(B + 1)) steps (6 at B = 63).  The same predicate
//     gives 0 for NaN, counts no +inf padding, and counts borders equal to
//     x and duplicate borders as the compare-sum does;
//   * a block stages the whole border table once in shared memory, as
//     stored, and checks each column's order as it stages it; a column
//     that is not sorted (or holds a NaN) is counted with the compare
//     loop, in this kernel, so any border table keeps the reference's
//     meaning.  A table past the opt-in limit (over 900 features at 63
//     borders; the port builds none) is read from global memory instead,
//     every column with the compare loop;
//   * the blocks are persistent: up to four of 512 threads an SM, as
//     many as its shared memory holds, each walking many elements, so
//     the table is staged a few hundred times a call, not once per 64
//     rows;
//   * threads walk the flattened (N * F) element axis four elements at a
//     time: 16-byte loads of x and one packed store of four bins.  Where
//     x or the bins are not aligned for that (a slice), and for the last
//     N * F % 4 elements, a thread takes one element a step.
// Its times on the card, about 3x the bytes bound at 139,440 x 54, are in
// PERF.md.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kBlocksPerSm = 4;           // 2,048 threads an SM
constexpr int kVec = 4;                   // elements a thread a step
constexpr int kReservedPerBlock = 1024;   // the runtime's shared memory
constexpr int kMaxDevices = 64;

// #{b : v > col[b * w]} for a column of nb borders, `w` apart; `top` is
// the largest power of two <= nb.  On a sorted column the borders below v
// form a prefix, whose length the search finds.
__device__ inline int count_below(const float* __restrict__ col, int w,
                                  int nb, int top, bool sorted, float v) {
  if (sorted) {
    int pos = 0;
    for (int step = top; step; step >>= 1) {
      const int next = pos + step;
      if (next <= nb && col[(next - 1) * w] < v) pos = next;
    }
    return pos;
  }
  int count = 0;
  for (int b = 0; b < nb; ++b) {
    count += v > col[static_cast<long long>(b) * w];
  }
  return count;
}

template <typename OutT>
struct Pack4;
template <>
struct Pack4<uint8_t> {
  __device__ static void store(uint8_t* out, long long i, const int c[4]) {
    *reinterpret_cast<uchar4*>(out + i) = make_uchar4(
        static_cast<unsigned char>(c[0]), static_cast<unsigned char>(c[1]),
        static_cast<unsigned char>(c[2]), static_cast<unsigned char>(c[3]));
  }
};
template <>
struct Pack4<int32_t> {
  __device__ static void store(int32_t* out, long long i, const int c[4]) {
    *reinterpret_cast<int4*>(out + i) = make_int4(c[0], c[1], c[2], c[3]);
  }
};

// `kStaged`: the (n_borders, n_feat) table fits the block's shared
// memory (a template parameter, so that the search's loads are known to
// be shared-memory loads).  `vec`: x and out are aligned for 4-element
// accesses.
template <typename OutT, bool kStaged>
__global__ void __launch_bounds__(kThreads)
binarize_kernel(const float* __restrict__ x, const float* __restrict__ borders,
                OutT* __restrict__ out, long long n_rows, int n_feat,
                int n_borders, int vec) {
  extern __shared__ float table[];          // (n_borders, n_feat), flags
  // the first four elements of x are loaded before the table is staged,
  // so the two loads' latencies overlap (small batches are all latency)
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long total = n_rows * n_feat;
  const long long n_vec = vec ? total / kVec : 0;
  float4 v_next = make_float4(0.f, 0.f, 0.f, 0.f);
  if (first < n_vec) v_next = reinterpret_cast<const float4*>(x)[first];
  const int nb = n_borders;
  int* sorted = reinterpret_cast<int*>(table + (kStaged ? nb * n_feat : 0));
  if (kStaged) {
    // the copy is unrolled so that a thread's loads are all in flight
    // together
    const int n4 = reinterpret_cast<uintptr_t>(borders) % sizeof(float4)
                       ? 0
                       : nb * n_feat / 4;
#pragma unroll 4
    for (int i = threadIdx.x; i < n4; i += blockDim.x) {
      reinterpret_cast<float4*>(table)[i] =
          reinterpret_cast<const float4*>(borders)[i];
    }
    for (int i = 4 * n4 + threadIdx.x; i < nb * n_feat; i += blockDim.x) {
      table[i] = borders[i];
    }
    for (int c = threadIdx.x; c < n_feat; c += blockDim.x) sorted[c] = 1;
    __syncthreads();
    // `<=` is false next to a NaN border: such a column takes the loop
#pragma unroll 4
    for (int i = threadIdx.x; i < (nb - 1) * n_feat; i += blockDim.x) {
      if (!(table[i] <= table[i + n_feat])) sorted[i % n_feat] = 0;
    }
    __syncthreads();
  }
  int top = 0;
  if (nb > 0) top = 1 << (31 - __clz(nb));
  auto bin = [&](int f, float v) {
    return kStaged ? count_below(table + f, n_feat, nb, top, sorted[f], v)
                   : count_below(borders + f, n_feat, nb, top, false, v);
  };

  // the element index advances by `stride` a step; its feature (column)
  // is carried along with 32-bit adds, not divided out each time
  const int f_step = static_cast<int>(stride % n_feat);
  const int f_vec_step = static_cast<int>((stride * kVec) % n_feat);
  int f_first = static_cast<int>((first * kVec) % n_feat);
  for (long long k = first; k < n_vec; k += stride) {
    const float4 v = v_next;
    if (k + stride < n_vec) {
      v_next = reinterpret_cast<const float4*>(x)[k + stride];
    }
    const float vs[kVec] = {v.x, v.y, v.z, v.w};
    int f = f_first;
    int c[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      c[j] = bin(f, vs[j]);
      f = f + 1 == n_feat ? 0 : f + 1;
    }
    Pack4<OutT>::store(out, k * kVec, c);
    f_first += f_vec_step;
    if (f_first >= n_feat) f_first -= n_feat;
  }
  const long long start = n_vec * kVec + first;
  int f = static_cast<int>(start % n_feat);
  for (long long i = start; i < total; i += stride) {
    out[i] = static_cast<OutT>(bin(f, x[i]));
    f += f_step;
    if (f >= n_feat) f -= n_feat;
  }
}

struct DeviceInfo {
  int sms, smem_per_sm, smem_optin;
};

// The device's SM count and shared memory, read once per device.
cudaError_t device_info(int device, DeviceInfo* info) {
  static DeviceInfo known[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidValue;
  DeviceInfo& d = known[device];
  if (!d.sms) {
    DeviceInfo got;
    cudaError_t err = cudaDeviceGetAttribute(
        &got.sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(
          &got.smem_per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor,
          device);
    }
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(
          &got.smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    }
    if (err != cudaSuccess) return err;
    d = got;
  }
  *info = d;
  return cudaSuccess;
}

template <typename OutT>
int launch(const float* x, const float* borders, OutT* out, long long n_rows,
           int n_feat, int n_borders, int device, cudaStream_t s) {
  DeviceInfo info;
  cudaError_t err = device_info(device, &info);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long table_bytes =
      (sizeof(float) * static_cast<long long>(n_borders) + sizeof(int)) *
      n_feat;
  const bool staged = table_bytes <= info.smem_optin;
  const size_t smem = staged ? static_cast<size_t>(table_bytes) : 0;
  const bool aligned =
      reinterpret_cast<uintptr_t>(x) % (sizeof(float) * kVec) == 0 &&
      reinterpret_cast<uintptr_t>(out) % (sizeof(OutT) * kVec) == 0;
  long long per_sm = info.smem_per_sm / (smem + kReservedPerBlock);
  per_sm = per_sm < 1 ? 1 : per_sm > kBlocksPerSm ? kBlocksPerSm : per_sm;
  const long long work = aligned ? (n_rows * n_feat + kVec - 1) / kVec
                                 : n_rows * n_feat;
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long cap = info.sms * per_sm;
  blocks = blocks < 1 ? 1 : blocks > cap ? cap : blocks;
  const unsigned grid = static_cast<unsigned>(blocks);
  const int vec = aligned ? 1 : 0;
  if (!staged) {
    note_launch(binarize_kernel<OutT, false>, 0);
    binarize_kernel<OutT, false><<<grid, kThreads, 0, s>>>(
        x, borders, out, n_rows, n_feat, n_borders, vec);
    return launch_status();
  }
  note_launch(binarize_kernel<OutT, true>, smem);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(binarize_kernel<OutT, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  binarize_kernel<OutT, true><<<grid, kThreads, smem, s>>>(
      x, borders, out, n_rows, n_feat, n_borders, vec);
  return launch_status();
}

}  // namespace

// x (n_rows, n_feat) f32, borders (n_borders, n_feat) f32, out (n_rows,
// n_feat) uint8 when out_u8 (the caller guarantees n_borders <= 255) else
// int32.  All row-major and contiguous.
extern "C" int repro_binarize(const void* x, const void* borders, void* out,
                              long long n_rows, int n_feat, int n_borders,
                              int out_u8, int device, void* stream) {
  cudaError_t err = select_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const float* bp = static_cast<const float*>(borders);
  if (out_u8) {
    return launch<uint8_t>(xp, bp, static_cast<uint8_t*>(out), n_rows,
                           n_feat, n_borders, device, s);
  }
  return launch<int32_t>(xp, bp, static_cast<int32_t*>(out), n_rows, n_feat,
                         n_borders, device, s);
}
