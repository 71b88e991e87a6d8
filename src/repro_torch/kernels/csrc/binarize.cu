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
// or 4 B (int32) of bins written per element; the work is B compares per
// element.  At B = 63 that is 63 compare-adds per 5 bytes, above the
// card's ~20 fp32 operations per byte of HBM bandwidth, so the kernel is
// issue-bound unless the border value it compares against costs no load:
//   * a block covers 32 features (one warp lane per feature, so a warp
//     reads 128 contiguous bytes of a row of x) and 64 rows;
//   * the block stages its 32 border columns in shared memory, up to 256
//     border rows per pass (32 KB);
//   * each thread keeps 8 rows of x in registers and compares all 8 against
//     each border value it loads, so one shared-memory load feeds 8
//     compare-adds.
#include "common.cuh"

namespace {

constexpr int kFeatTile = 32;       // features per block: one warp's lanes
constexpr int kRowGroups = 8;       // warps per block
constexpr int kRowsPerThread = 8;   // rows of x each thread holds in registers
constexpr int kRowsPerBlock = kRowGroups * kRowsPerThread;
constexpr int kBorderChunk = 256;   // border rows staged per pass (32 KB)

template <typename OutT>
__global__ void binarize_kernel(const float* __restrict__ x,
                                const float* __restrict__ borders,
                                OutT* __restrict__ out, long long n_rows,
                                int n_feat, int n_borders) {
  __shared__ float border_s[kBorderChunk * kFeatTile];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int f = blockIdx.y * kFeatTile + tx;
  const long long row0 =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + ty;

  float xv[kRowsPerThread];
  int count[kRowsPerThread];
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const long long r = row0 + static_cast<long long>(k) * kRowGroups;
    xv[k] = (f < n_feat && r < n_rows) ? x[r * n_feat + f] : 0.0f;
    count[k] = 0;
  }

  for (int b0 = 0; b0 < n_borders; b0 += kBorderChunk) {
    const int nb = min(kBorderChunk, n_borders - b0);
    __syncthreads();  // the previous chunk is fully consumed
    for (int i = ty; i < nb; i += kRowGroups) {
      border_s[i * kFeatTile + tx] =
          f < n_feat ? borders[static_cast<long long>(b0 + i) * n_feat + f]
                     : INFINITY;
    }
    __syncthreads();
    for (int i = 0; i < nb; ++i) {
      const float bv = border_s[i * kFeatTile + tx];
#pragma unroll
      for (int k = 0; k < kRowsPerThread; ++k) count[k] += xv[k] > bv;
    }
  }

  if (f >= n_feat) return;
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const long long r = row0 + static_cast<long long>(k) * kRowGroups;
    if (r < n_rows) out[r * n_feat + f] = static_cast<OutT>(count[k]);
  }
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
  const dim3 block(kFeatTile, kRowGroups);
  const dim3 grid(
      static_cast<unsigned>((n_rows + kRowsPerBlock - 1) / kRowsPerBlock),
      static_cast<unsigned>((n_feat + kFeatTile - 1) / kFeatTile));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const float* bp = static_cast<const float*>(borders);
  if (out_u8) {
    binarize_kernel<uint8_t><<<grid, block, 0, s>>>(
        xp, bp, static_cast<uint8_t*>(out), n_rows, n_feat, n_borders);
  } else {
    binarize_kernel<int32_t><<<grid, block, 0, s>>>(
        xp, bp, static_cast<int32_t*>(out), n_rows, n_feat, n_borders);
  }
  return launch_status();
}
