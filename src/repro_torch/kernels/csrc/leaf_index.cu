// Oblivious-tree leaf indexes:
//   idx[n, t] = sum_d 2^d * [bins[n, sf[t, d]] >= sb[t, d]]
//
// Replaces the TPU kernels src/repro/kernels/leaf_index.py:leaf_index and
// leaf_index_u8 (_leaf_index_kernel).  The TPU kernel gathers the split
// features with a one-hot matmul on the MXU; that is a TPU workaround and
// is not carried over: here each thread reads its bins straight from a
// tile in shared memory.
//
// The compare runs in int32.  Padded trees and truncated levels carry
// split bin 2^30 (PAD_SPLIT_BIN), which no bin reaches, so those levels
// always go left; narrowing the split bin to uint8 would turn 2^30 into 0
// and send every padded level right.
//
// What bounds it on an H100: bytes.  The (N, T) int32 output is 4 bytes a
// (row, tree) against 1 byte of uint8 bins a (row, feature), so writing idx
// dominates (558 MB at N = 139,440 and T = 1,000).  The design keeps the
// write at full rate and everything else on chip:
//   * a block covers up to 128 rows and 32 trees: lane t of a warp owns
//     tree t, so each warp writes 128 contiguous bytes of an idx row;
//   * the block copies its rows of bins (uint8 or int32) into shared memory
//     once: 128 rows x 54 B = 6.9 KB for a uint8 Covertype pool;
//   * each thread loads its tree's D split features and bins into registers
//     once (__ldg) and reuses them for every row of the block;
//   * the lanes of a warp read one row of the tile, which spans consecutive
//     banks, so the gathers are free of bank conflicts.
#include "common.cuh"

namespace {

constexpr int kTreeTile = 32;   // trees per block: one warp's lanes
constexpr int kRowGroups = 8;   // warps per block

template <typename BinT>
__global__ void leaf_index_kernel(const BinT* __restrict__ bins,
                                  const int32_t* __restrict__ sf,
                                  const int32_t* __restrict__ sb,
                                  int32_t* __restrict__ out,
                                  long long n_rows, int n_feat, int n_trees,
                                  int depth, int rows_per_block) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BinT* tile = reinterpret_cast<BinT*>(smem_raw);
  const long long row0 =
      static_cast<long long>(blockIdx.x) * rows_per_block;
  const int rows = static_cast<int>(
      min(static_cast<long long>(rows_per_block), n_rows - row0));
  const int tid = threadIdx.y * kTreeTile + threadIdx.x;
  const BinT* src = bins + row0 * n_feat;
  for (int i = tid; i < rows * n_feat; i += kTreeTile * kRowGroups) {
    tile[i] = src[i];
  }
  __syncthreads();

  const int t = blockIdx.y * kTreeTile + threadIdx.x;
  if (t >= n_trees) return;
  int feat[kMaxDepth];
  int split[kMaxDepth];
#pragma unroll
  for (int d = 0; d < kMaxDepth; ++d) {
    feat[d] = d < depth ? __ldg(sf + static_cast<long long>(t) * depth + d) : 0;
    split[d] = d < depth ? __ldg(sb + static_cast<long long>(t) * depth + d) : 0;
  }
  for (int r = threadIdx.y; r < rows; r += kRowGroups) {
    const BinT* row = tile + r * n_feat;
    int idx = 0;
#pragma unroll
    for (int d = 0; d < kMaxDepth; ++d) {
      if (d < depth) {
        idx |= (static_cast<int>(row[feat[d]]) >= split[d]) << d;
      }
    }
    out[(row0 + r) * n_trees + t] = idx;
  }
}

}  // namespace

// bins (n_rows, n_feat) uint8 when bins_u8 else int32; sf, sb (n_trees,
// depth) int32 with every sf in [0, n_feat) and depth <= kMaxDepth;
// out (n_rows, n_trees) int32.  rows_per_block is a multiple of kRowGroups
// chosen by the caller so the bins tile fits 48 KB of shared memory.
extern "C" int repro_leaf_index(const void* bins, const void* sf,
                                const void* sb, void* out, long long n_rows,
                                int n_feat, int n_trees, int depth,
                                int bins_u8, int rows_per_block, int device,
                                void* stream) {
  cudaError_t err = select_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(kTreeTile, kRowGroups);
  const dim3 grid(
      static_cast<unsigned>((n_rows + rows_per_block - 1) / rows_per_block),
      static_cast<unsigned>((n_trees + kTreeTile - 1) / kTreeTile));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* sfp = static_cast<const int32_t*>(sf);
  const int32_t* sbp = static_cast<const int32_t*>(sb);
  int32_t* op = static_cast<int32_t*>(out);
  if (bins_u8) {
    const size_t smem = static_cast<size_t>(rows_per_block) * n_feat;
    leaf_index_kernel<uint8_t><<<grid, block, smem, s>>>(
        static_cast<const uint8_t*>(bins), sfp, sbp, op, n_rows, n_feat,
        n_trees, depth, rows_per_block);
  } else {
    const size_t smem =
        static_cast<size_t>(rows_per_block) * n_feat * sizeof(int32_t);
    leaf_index_kernel<int32_t><<<grid, block, smem, s>>>(
        static_cast<const int32_t*>(bins), sfp, sbp, op, n_rows, n_feat,
        n_trees, depth, rows_per_block);
  }
  return launch_status();
}
