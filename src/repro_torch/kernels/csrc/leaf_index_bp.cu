// Oblivious-tree leaf indexes over the bitpacked layout:
//   idx[n, t] = OR_d [bins[n, sf_bp[d, t]] >= sb_bp[d, t]] << d,
// with the splits held as (D, T) planes: int32 split features and uint8
// or int32 thresholds (uint8 where every threshold of the depth group fits
// a byte, int32 where the group holds PAD_SPLIT_BIN).
//
// Replaces the TPU kernel src/repro/kernels/leaf_index.py:leaf_index_bp
// (_leaf_index_bp_kernel, with _bp_compare_planes).  The TPU kernel is
// integer only: per level it compares a block of docs against the
// threshold plane, packs each 32 docs' compare bits into a uint32 lane
// word (the paper's vmsgeu mask register), unpacks the word again and ors
// bit d into the index.  Here a warp's 32 lanes are 32 rows, so that word
// is exactly __ballot_sync of the compare, and each lane takes its own bit
// back out of it: the same round trip, the identity on the result.
//
// The bins tile stays in its own type in shared memory (uint8 for a pool:
// 54 bytes a Covertype row); widening it is what the TPU kernel avoids,
// and it is the only widening that costs anything here.  A bin and its
// threshold meet in int32 registers, so the 2^30 sentinel of an int32
// plane never goes right.  One template takes uint8 or int32 bins against
// uint8 or int32 planes: four instantiations.
//
// Lanes as rows would make each (N, T) idx store hit 32 separate rows, so
// a warp transposes through shared memory: it assembles a 32 x 32 block
// of idx (rows x trees) in a 33-word-stride tile, then writes it out with
// lanes as trees, 128 contiguous bytes of a row per store.
//
// What bounds it on an H100: bytes, as for leaf_index.cu: the (N, T) int32
// output (558 MB at N = 139,440 and T = 1,000).  The design:
//   * a block covers up to 128 rows (4 warps of 32) and 32 trees;
//   * the rows of bins go into shared memory once, at an odd-word row
//     stride, so the 32 rows a warp reads at one feature sit in 32 banks;
//   * lane j loads tree j's D splits once (lanes as trees: one coalesced
//     128-byte line per plane and level) and __shfl_sync hands tree j's
//     split to every lane when the warp works on tree j.
#include "common.cuh"

namespace {

constexpr int kTreeTile = 32;   // trees per block
constexpr int kWarps = 4;       // warps per block, 32 rows each per pass
constexpr unsigned kFull = 0xffffffffu;

template <typename BinT, typename PlaneT>
__global__ void leaf_index_bp_kernel(const BinT* __restrict__ bins,
                                     const int32_t* __restrict__ sf_bp,
                                     const PlaneT* __restrict__ sb_bp,
                                     int32_t* __restrict__ out,
                                     long long n_rows, int n_feat,
                                     int n_trees, int depth, int stride,
                                     int rows_per_block) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BinT* tile = reinterpret_cast<BinT*>(smem_raw);
  __shared__ int32_t idx_s[kWarps][32][33];
  const long long row0 =
      static_cast<long long>(blockIdx.x) * rows_per_block;
  const int rows = static_cast<int>(
      min(static_cast<long long>(rows_per_block), n_rows - row0));
  const BinT* src = bins + row0 * n_feat;
  for (int i = threadIdx.x; i < rows * n_feat; i += kWarps * 32) {
    const int r = i / n_feat;
    tile[r * stride + (i - r * n_feat)] = src[i];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t0 = blockIdx.y * kTreeTile;
  const int nt = min(kTreeTile, n_trees - t0);
  int feat[kMaxDepth];
  int split[kMaxDepth];
#pragma unroll
  for (int d = 0; d < kMaxDepth; ++d) {
    const long long at = static_cast<long long>(d) * n_trees + t0 + lane;
    const bool has = d < depth && lane < nt;
    feat[d] = has ? __ldg(sf_bp + at) : 0;
    split[d] = has ? static_cast<int>(__ldg(sb_bp + at)) : 0;
  }

  for (int g = warp * 32; g < rows; g += kWarps * 32) {
    // lane = row g + lane; a lane past the block's rows reads row g and
    // its bits are never stored
    const int r = g + lane < rows ? g + lane : g;
    const BinT* row = tile + r * stride;
    for (int j = 0; j < nt; ++j) {
      unsigned idx = 0;
#pragma unroll
      for (int d = 0; d < kMaxDepth; ++d) {
        if (d < depth) {
          const int f = __shfl_sync(kFull, feat[d], j);
          const int s = __shfl_sync(kFull, split[d], j);
          // the 32 rows' compare bits as one word, then this row's bit
          const unsigned word =
              __ballot_sync(kFull, static_cast<int>(row[f]) >= s);
          idx |= ((word >> lane) & 1u) << d;
        }
      }
      idx_s[warp][lane][j] = static_cast<int32_t>(idx);
    }
    __syncwarp();
    const int n_out = min(32, rows - g);
    for (int rr = 0; rr < n_out; ++rr) {
      if (lane < nt) {
        out[(row0 + g + rr) * n_trees + t0 + lane] = idx_s[warp][rr][lane];
      }
    }
    __syncwarp();
  }
}

template <typename BinT>
void launch(dim3 grid, size_t smem, cudaStream_t s, const BinT* bins,
            const int32_t* sf, const void* sb, int planes_u8, int32_t* out,
            long long n_rows, int n_feat, int n_trees, int depth, int stride,
            int rows_per_block) {
  if (planes_u8) {
    leaf_index_bp_kernel<BinT, uint8_t><<<grid, kWarps * 32, smem, s>>>(
        bins, sf, static_cast<const uint8_t*>(sb), out, n_rows, n_feat,
        n_trees, depth, stride, rows_per_block);
  } else {
    leaf_index_bp_kernel<BinT, int32_t><<<grid, kWarps * 32, smem, s>>>(
        bins, sf, static_cast<const int32_t*>(sb), out, n_rows, n_feat,
        n_trees, depth, stride, rows_per_block);
  }
}

}  // namespace

// bins (n_rows, n_feat) uint8 when bins_u8 else int32; sf_bp (depth,
// n_trees) int32 with every sf in [0, n_feat) and depth <= kMaxDepth;
// sb_bp (depth, n_trees) uint8 when planes_u8 else int32; out (n_rows,
// n_trees) int32.  The bins tile holds rows_per_block rows (a multiple of
// 32) of `stride` bins each (an odd number of 4-byte words); with the
// 16.5 KB transpose tiles it fits 48 KB of shared memory.
extern "C" int repro_leaf_index_bp(const void* bins, const void* sf_bp,
                                   const void* sb_bp, void* out,
                                   long long n_rows, int n_feat, int n_trees,
                                   int depth, int bins_u8, int planes_u8,
                                   int stride, int rows_per_block, int device,
                                   void* stream) {
  cudaError_t err = select_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(
      static_cast<unsigned>((n_rows + rows_per_block - 1) / rows_per_block),
      static_cast<unsigned>((n_trees + kTreeTile - 1) / kTreeTile));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* sfp = static_cast<const int32_t*>(sf_bp);
  int32_t* op = static_cast<int32_t*>(out);
  if (bins_u8) {
    const size_t smem = static_cast<size_t>(rows_per_block) * stride;
    launch<uint8_t>(grid, smem, s, static_cast<const uint8_t*>(bins), sfp,
                    sb_bp, planes_u8, op, n_rows, n_feat, n_trees, depth,
                    stride, rows_per_block);
  } else {
    const size_t smem =
        static_cast<size_t>(rows_per_block) * stride * sizeof(int32_t);
    launch<int32_t>(grid, smem, s, static_cast<const int32_t*>(bins), sfp,
                    sb_bp, planes_u8, op, n_rows, n_feat, n_trees, depth,
                    stride, rows_per_block);
  }
  return launch_status();
}
