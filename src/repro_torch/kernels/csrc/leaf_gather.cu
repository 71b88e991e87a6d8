// Leaf-value accumulation: pred[n, c] = sum_t lv[t, idx[n, t], c].
//
// Replaces the TPU kernel src/repro/kernels/leaf_gather.py:leaf_gather
// (_leaf_gather_kernel).  The TPU kernel turns the gather into a one-hot
// matmul on the MXU and carries the sum over tree blocks from one serial
// grid step to the next in its output tile.  Neither carries over: Hopper
// gathers directly, and its blocks run in no order, so each block owns its
// rows outright and loops over every tree itself (no cross-block
// reduction, no atomics).  A row's sum is taken in tree order, one add per
// tree, exactly as the fused kernel takes it, so the staged and the fused
// path give bit-identical scores.
//
// What bounds it on an H100: bytes.  The (N, T) int32 idx is read once
// (558 MB at N = 139,440 and T = 1,000); the leaf table (7.2 MB for
// T = 1,000, depth 8, C = 7) stays resident in the 50 MB L2, so its
// gathers cost L2 bandwidth, not HBM.  The design:
//   * one thread per row, 128 rows per block, C accumulators in registers;
//   * idx is staged through shared memory 32 trees at a time, each warp
//     loading 128 contiguous bytes of a row, so the HBM reads coalesce even
//     though every thread walks its own row; the tile is padded to 33
//     columns so the per-row reads are free of bank conflicts;
//   * the C leaf values of a (tree, leaf) are contiguous, read via __ldg.
#include "common.cuh"

namespace {

constexpr int kRows = 128;    // rows per block, one per thread
constexpr int kTChunk = 32;   // trees of idx staged per pass (16.9 KB)

template <int MaxC>
__global__ void leaf_gather_kernel(const int32_t* __restrict__ idx,
                                   const float* __restrict__ lv,
                                   float* __restrict__ out, long long n_rows,
                                   int n_trees, int n_leaves, int n_out) {
  __shared__ int32_t idx_s[kRows][kTChunk + 1];
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const int rows =
      static_cast<int>(min(static_cast<long long>(kRows), n_rows - row0));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r = threadIdx.x;

  float acc[MaxC];
#pragma unroll
  for (int c = 0; c < MaxC; ++c) acc[c] = 0.0f;

  for (int t0 = 0; t0 < n_trees; t0 += kTChunk) {
    const int nt = min(kTChunk, n_trees - t0);
    __syncthreads();  // the previous chunk is fully consumed
    for (int rr = warp; rr < rows; rr += kRows / 32) {
      if (lane < nt) idx_s[rr][lane] = idx[(row0 + rr) * n_trees + t0 + lane];
    }
    __syncthreads();
    if (r < rows) {
      for (int j = 0; j < nt; ++j) {
        const float* leaf =
            lv + (static_cast<long long>(t0 + j) * n_leaves + idx_s[r][j]) *
                     n_out;
#pragma unroll
        for (int c = 0; c < MaxC; ++c) {
          if (c < n_out) acc[c] += __ldg(leaf + c);
        }
      }
    }
  }

  if (r >= rows) return;
#pragma unroll
  for (int c = 0; c < MaxC; ++c) {
    if (c < n_out) out[(row0 + r) * n_out + c] = acc[c];
  }
}

}  // namespace

// idx (n_rows, n_trees) int32 with every value in [0, n_leaves); lv
// (n_trees, n_leaves, n_out) f32; out (n_rows, n_out) f32; n_out <= 32.
extern "C" int repro_leaf_gather(const void* idx, const void* lv, void* out,
                                 long long n_rows, int n_trees, int n_leaves,
                                 int n_out, int device, void* stream) {
  cudaError_t err = select_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((n_rows + kRows - 1) / kRows));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* ip = static_cast<const int32_t*>(idx);
  const float* lp = static_cast<const float*>(lv);
  float* op = static_cast<float*>(out);
  if (n_out <= 8) {
    leaf_gather_kernel<8><<<grid, kRows, 0, s>>>(ip, lp, op, n_rows, n_trees,
                                                 n_leaves, n_out);
  } else {
    leaf_gather_kernel<32><<<grid, kRows, 0, s>>>(ip, lp, op, n_rows,
                                                  n_trees, n_leaves, n_out);
  }
  return launch_status();
}
