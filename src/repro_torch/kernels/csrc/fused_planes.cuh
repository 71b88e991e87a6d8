// The row route of the fused kernels over (D, T) split planes:
// fused_predict_bp.cu's (bitpacked: int32 features, uint8 or int32
// thresholds, 32-row compare words) and fused_predict_dm.cu's
// (depth_major: int32 planes, level weights pow2), whose serving buckets
// take fused_spread.cuh instead.  Both layouts hold
// the splits as planes, row d = every tree's level-d split; they differ
// only in how a level's compare enters the index, which `kBitpacked`
// selects.
//
// The structure is fused_predict.cu's row route: a block binarizes its rows
// of x into a shared bins tile once (uint8 when <= 255 borders, int32
// otherwise; odd-word row stride, so a warp's 32 rows at one feature sit
// in 32 banks), then each thread walks every tree for its own row, sums
// the leaf values in tree order, one add per tree, and writes its C
// outputs: no atomics, and the same sums, bit for bit, as fused_predict.cu,
// fused_spread.cuh and leaf_gather.cu give the same model.
//
// What the planes change: a thread reads tree t's level-d split at
// plane[d * T + t], T * 4 bytes from tree t's next level, so reading the
// splits from device memory would cost a sector per (tree, level).  The
// block stages a chunk of trees' planes in shared memory with coalesced
// loads instead (kPlaneWords entries a plane: 256 trees at D = 8, 16 KB for
// both planes), and every thread then reads the split of the tree it is
// on as a broadcast.
//
// What bounds it on an H100: operations in bulk, as fused_predict.cu: D
// shared loads and compares plus C leaf loads per (row, tree), about 2.6e9
// at N = 139,440, T = 1,000, D = 8, C = 7, against 41 MB of bytes.  At a
// serving bucket a block costs one thread's serial walk of the T trees,
// so a 1,024-row bucket (8 blocks on 132 SMs) takes about as long as the
// bulk call: what the spread route is for.
//
// Any C and any F, as fused_predict.cu: the block walks its rows' output
// slabs in turn (each summed in tree order, the planes restaged a slab),
// and a bins tile too wide for the opt-in limit goes through an (N, F)
// scratch array in global memory (kStaged false).
#pragma once

#include "common.cuh"

namespace {

// Entries of each staged plane: a chunk is kPlaneWords / depth trees.
constexpr int kPlaneWords = 2048;

template <typename BinT, typename PlaneT, bool kBitpacked, int MaxC,
          bool kStaged>
__global__ void fused_planes_kernel(
    const float* __restrict__ x, const float* __restrict__ borders,
    const int32_t* __restrict__ sf, const PlaneT* __restrict__ sb,
    const float* __restrict__ pow2, const float* __restrict__ lv,
    float* __restrict__ out, BinT* __restrict__ scratch, long long n_rows,
    int n_feat, int n_borders, int n_trees, int depth, int n_out,
    int stride, int slab) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int32_t sf_s[kPlaneWords];
  __shared__ PlaneT sb_s[kPlaneWords];
  __shared__ int32_t weight_s[kMaxDepth];
  const int rows_per_block = blockDim.x;
  const int tid = threadIdx.x;
  const long long row0 =
      static_cast<long long>(blockIdx.x) * rows_per_block;
  BinT* tile = kStaged ? reinterpret_cast<BinT*>(smem_raw)
                       : scratch + row0 * stride;
  const int rows = static_cast<int>(
      min(static_cast<long long>(rows_per_block), n_rows - row0));

  // Stage 1: binarize the block's rows of x into the bins tile.
  const float* xsrc = x + row0 * n_feat;
  for (int i = tid; i < rows * n_feat; i += rows_per_block) {
    const int r = i / n_feat;
    const int f = i - r * n_feat;
    const float v = xsrc[i];
    int count = 0;
    for (int b = 0; b < n_borders; ++b) {
      count += v > __ldg(borders + static_cast<long long>(b) * n_feat + f);
    }
    tile[static_cast<long long>(r) * stride + f] = static_cast<BinT>(count);
  }
  if (!kBitpacked && tid < depth) {
    weight_s[tid] = __float2int_rn(__ldg(pow2 + tid));
  }

  // Stage 2: every tree for this thread's row, a slab of outputs at a
  // time.  Every thread stays in the loops for the chunk barriers (and,
  // bitpacked, the ballots); a thread past the block's rows reads row 0
  // and stores nothing.
  const int lane = tid & 31;
  const bool live = tid < rows;
  const BinT* row = tile + static_cast<long long>(live ? tid : 0) * stride;
  const int n_leaves = 1 << depth;
  const int chunk = kPlaneWords / max(depth, 1);
  for (int c0 = 0; c0 < n_out; c0 += slab) {
    const int nc = min(slab, n_out - c0);
    float acc[MaxC];
#pragma unroll
    for (int c = 0; c < MaxC; ++c) acc[c] = 0.0f;
    for (int t0 = 0; t0 < n_trees; t0 += chunk) {
      const int nt = min(chunk, n_trees - t0);
      __syncthreads();  // the tile is written, the previous chunk consumed
      for (int i = tid; i < depth * nt; i += rows_per_block) {
        const int d = i / nt;
        const long long at = static_cast<long long>(d) * n_trees + t0 +
                             (i - d * nt);
        sf_s[i] = sf[at];
        sb_s[i] = sb[at];
      }
      __syncthreads();
      for (int j = 0; j < nt; ++j) {
        int idx = 0;
        for (int d = 0; d < depth; ++d) {
          // int32 compare: the 2^30 PAD_SPLIT_BIN never goes right
          const bool go = static_cast<int>(row[sf_s[d * nt + j]]) >=
                          static_cast<int>(sb_s[d * nt + j]);
          if (kBitpacked) {
            const unsigned word = __ballot_sync(0xffffffffu, go);
            idx |= static_cast<int>((word >> lane) & 1u) << d;
          } else if (go) {
            idx += weight_s[d];
          }
        }
        if (live) {
          const float* leaf =
              lv + (static_cast<long long>(t0 + j) * n_leaves + idx) * n_out
              + c0;
#pragma unroll
          for (int c = 0; c < MaxC; ++c) {
            if (c < nc) acc[c] += __ldg(leaf + c);
          }
        }
      }
    }
    if (live) {
#pragma unroll
      for (int c = 0; c < MaxC; ++c) {
        if (c < nc) out[(row0 + tid) * n_out + c0 + c] = acc[c];
      }
    }
  }
}

template <typename BinT, typename PlaneT, bool kBitpacked, int MaxC>
int launch_fused_tile(unsigned blocks, int rows_per_block, size_t smem,
                      cudaStream_t s, const float* x, const float* borders,
                      const int32_t* sf, const PlaneT* sb, const float* pow2,
                      const float* lv, float* out, BinT* scratch,
                      long long n_rows, int n_feat, int n_borders,
                      int n_trees, int depth, int n_out, int stride,
                      int slab) {
  auto kernel = scratch != nullptr
      ? fused_planes_kernel<BinT, PlaneT, kBitpacked, MaxC, false>
      : fused_planes_kernel<BinT, PlaneT, kBitpacked, MaxC, true>;
  // the staged planes and level weights are static shared memory
  const size_t planes = sizeof(int32_t) * kPlaneWords +
                        sizeof(PlaneT) * kPlaneWords +
                        sizeof(int32_t) * kMaxDepth;
  const cudaError_t err = allow_shared_memory(kernel, smem + planes, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, rows_per_block, smem, s>>>(
      x, borders, sf, sb, pow2, lv, out, scratch, n_rows, n_feat, n_borders,
      n_trees, depth, n_out, stride, slab);
  return launch_status();
}

// The launch over a bins tile of rows_per_block rows of `stride` bins in
// shared memory, or the block's rows of an (n_rows, n_feat) scratch
// array when `scratch` is not null; outputs in slabs of `slab` <= 32.
template <typename BinT, typename PlaneT, bool kBitpacked>
int launch_fused_planes(unsigned blocks, int rows_per_block, cudaStream_t s,
                        const float* x, const float* borders,
                        const int32_t* sf, const PlaneT* sb,
                        const float* pow2, const float* lv, float* out,
                        void* scratch, long long n_rows, int n_feat,
                        int n_borders, int n_trees, int depth, int n_out,
                        int stride, int slab) {
  const size_t smem = scratch != nullptr
      ? 0 : static_cast<size_t>(rows_per_block) * stride * sizeof(BinT);
  BinT* sp = static_cast<BinT*>(scratch);
  if (slab <= 8) {
    return launch_fused_tile<BinT, PlaneT, kBitpacked, 8>(
        blocks, rows_per_block, smem, s, x, borders, sf, sb, pow2, lv, out,
        sp, n_rows, n_feat, n_borders, n_trees, depth, n_out, stride, slab);
  }
  return launch_fused_tile<BinT, PlaneT, kBitpacked, 32>(
      blocks, rows_per_block, smem, s, x, borders, sf, sb, pow2, lv, out, sp,
      n_rows, n_feat, n_borders, n_trees, depth, n_out, stride, slab);
}

}  // namespace
