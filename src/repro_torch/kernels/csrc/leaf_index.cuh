// Oblivious-tree leaf indexes, shared by leaf_index.cu (soa: (T, D)
// splits) and leaf_index_dm.cu (depth_major: (D, T) planes):
//   idx[n, t] = sum_d w[d] * [bins[n, sf(t, d)] >= sb(t, d)],
// with the split of tree t at level d at t * tree_stride + d * level_stride
// and the level weights w[d] = 2^d (pow2 where the layout holds one).
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
//   * each thread loads its tree's D split features, bins and weights into
//     registers once (__ldg) and reuses them for every row of the block;
//   * the lanes of a warp read one row of the tile, which spans consecutive
//     banks, so the gathers are free of bank conflicts.
#pragma once

#include "common.cuh"

namespace {

constexpr int kTreeTile = 32;   // trees per block: one warp's lanes
constexpr int kRowGroups = 8;   // warps per block

template <typename BinT, bool kStaged>
__global__ void leaf_index_kernel(const BinT* __restrict__ bins,
                                  const int32_t* __restrict__ sf,
                                  const int32_t* __restrict__ sb,
                                  const float* __restrict__ pow2,
                                  int32_t* __restrict__ out,
                                  long long n_rows, int n_feat, int n_trees,
                                  int depth, int rows_per_block,
                                  int tree_stride, int level_stride) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BinT* staged = reinterpret_cast<BinT*>(smem_raw);
  const long long row0 =
      static_cast<long long>(blockIdx.x) * rows_per_block;
  const int rows = static_cast<int>(
      min(static_cast<long long>(rows_per_block), n_rows - row0));
  const int tid = threadIdx.y * kTreeTile + threadIdx.x;
  const BinT* src = bins + row0 * n_feat;
  if (kStaged) {
    for (int i = tid; i < rows * n_feat; i += kTreeTile * kRowGroups) {
      staged[i] = src[i];
    }
    __syncthreads();
  }
  const BinT* tile = kStaged ? staged : src;

  const int t = blockIdx.y * kTreeTile + threadIdx.x;
  if (t >= n_trees) return;
  int feat[kMaxDepth];
  int split[kMaxDepth];
  int weight[kMaxDepth];
#pragma unroll
  for (int d = 0; d < kMaxDepth; ++d) {
    const long long at = static_cast<long long>(t) * tree_stride +
                         static_cast<long long>(d) * level_stride;
    feat[d] = d < depth ? __ldg(sf + at) : 0;
    split[d] = d < depth ? __ldg(sb + at) : 0;
    weight[d] = pow2 != nullptr && d < depth
                    ? __float2int_rn(__ldg(pow2 + d)) : 1 << d;
  }
  for (int r = threadIdx.y; r < rows; r += kRowGroups) {
    const BinT* row = tile + r * n_feat;
    int idx = 0;
#pragma unroll
    for (int d = 0; d < kMaxDepth; ++d) {
      if (d < depth && static_cast<int>(row[feat[d]]) >= split[d]) {
        idx += weight[d];
      }
    }
    out[(row0 + r) * n_trees + t] = idx;
  }
}

template <typename BinT>
int launch_typed(dim3 grid, dim3 block, cudaStream_t s, const BinT* bins,
                 const int32_t* sf, const int32_t* sb, const float* pow2,
                 int32_t* out, long long n_rows, int n_feat, int n_trees,
                 int depth, int rows_per_block, int from_global,
                 int tree_stride, int level_stride) {
  const size_t smem = from_global ? 0
      : static_cast<size_t>(rows_per_block) * n_feat * sizeof(BinT);
  auto kernel = from_global ? leaf_index_kernel<BinT, false>
                            : leaf_index_kernel<BinT, true>;
  const cudaError_t err = allow_shared_memory(kernel, smem, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, block, smem, s>>>(bins, sf, sb, pow2, out, n_rows, n_feat,
                                   n_trees, depth, rows_per_block,
                                   tree_stride, level_stride);
  return launch_status();
}

// Launch over uint8 (bins_u8) or int32 bins; rows_per_block is a multiple
// of kRowGroups chosen by the caller (kernels/tuning.py tile_rows), with
// the bins tile in shared memory unless from_global.
inline int launch_leaf_index(const void* bins, const void* sf,
                             const void* sb, const void* pow2, void* out,
                             long long n_rows, int n_feat, int n_trees,
                             int depth, int bins_u8, int rows_per_block,
                             int from_global, int tree_stride,
                             int level_stride, int device, void* stream) {
  cudaError_t err = select_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(kTreeTile, kRowGroups);
  const dim3 grid(
      static_cast<unsigned>((n_rows + rows_per_block - 1) / rows_per_block),
      static_cast<unsigned>((n_trees + kTreeTile - 1) / kTreeTile));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* sfp = static_cast<const int32_t*>(sf);
  const int32_t* sbp = static_cast<const int32_t*>(sb);
  const float* wp = static_cast<const float*>(pow2);
  int32_t* op = static_cast<int32_t*>(out);
  if (bins_u8) {
    return launch_typed<uint8_t>(grid, block, s,
                                 static_cast<const uint8_t*>(bins), sfp, sbp,
                                 wp, op, n_rows, n_feat, n_trees, depth,
                                 rows_per_block, from_global, tree_stride,
                                 level_stride);
  }
  return launch_typed<int32_t>(grid, block, s,
                               static_cast<const int32_t*>(bins), sfp, sbp,
                               wp, op, n_rows, n_feat, n_trees, depth,
                               rows_per_block, from_global, tree_stride,
                               level_stride);
}

}  // namespace
