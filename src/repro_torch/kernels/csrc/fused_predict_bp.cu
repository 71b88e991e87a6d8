// Fused prediction over one depth group of the bitpacked layout:
//   pred[n, c] = sum_t lv[t, idx(bins[n], t), c],  bins = binarize(x),
//   idx(b, t) = OR_d [b[sf_bp[d, t]] >= sb_bp[d, t]] << d.
//
// Replaces the TPU kernel src/repro/kernels/fused_predict.py:
// fused_predict_bp (_fused_bp_kernel), whose index stage packs the compare
// bits of 32 rows into one uint32 lane word and whose leaf stage is a
// one-hot matmul.  Here the leaf stage is a direct gather, bins and
// thresholds meet in int32 registers (so an int32 plane's PAD_SPLIT_BIN
// never goes right), and kernels/tuning.py fused_plan (splits="bitpacked")
// picks one of two routes from the shape, as for soa and depth_major:
//   * row (many rows): fused_planes.cuh over int32 split features and
//     uint8 or int32 thresholds, a thread a row walking every tree; per
//     level the 32 rows of a warp put their compare bits into one word with
//     __ballot_sync (the TPU's 32-doc lane word) and each row ors its own
//     bit into its index;
//   * spread (a serving bucket): fused_spread.cuh with Splits::kBitpacked,
//     N / 132 rows a block, row d of a chunk's splits taken from the
//     contiguous slice of each plane (uint8 thresholds by byte loads), the
//     level's bit or-ed in as soa's is: the same idx per (row, tree) pair,
//     without the ballot words.
// Each route has four instantiations (uint8 or int32 bins, uint8 or int32
// thresholds).  Their designs and what bounds them are described in the
// two headers.  Both sum every (row, output) in tree order, one add a tree
// from 0.0f, so on a one-group model (trees in model order) both give
// soa's scores bit for bit.  BitpackedLayout.fused_raw calls it for a
// model of one depth group; with more it binarizes once and runs
// leaf_index_bp per group, as the JAX package does.
#include "fused_planes.cuh"
#include "fused_spread.cuh"

namespace {

template <typename BinT>
int launch(unsigned blocks, int rows_per_block, cudaStream_t s,
           const float* x, const float* borders, const int32_t* sf,
           const void* sb, int planes_u8, const float* lv, float* out,
           void* scratch, long long n_rows, int n_feat, int n_borders,
           int n_trees, int depth, int n_out, int stride, int slab) {
  if (planes_u8) {
    return launch_fused_planes<BinT, uint8_t, true>(
        blocks, rows_per_block, s, x, borders, sf,
        static_cast<const uint8_t*>(sb), nullptr, lv, out, scratch, n_rows,
        n_feat, n_borders, n_trees, depth, n_out, stride, slab);
  }
  return launch_fused_planes<BinT, int32_t, true>(
      blocks, rows_per_block, s, x, borders, sf,
      static_cast<const int32_t*>(sb), nullptr, lv, out, scratch, n_rows,
      n_feat, n_borders, n_trees, depth, n_out, stride, slab);
}

}  // namespace

// x (n_rows, n_feat) f32; borders (n_borders, n_feat) f32; sf_bp (depth,
// n_trees) int32 with every sf in [0, n_feat) and depth <= kMaxDepth;
// sb_bp (depth, n_trees) uint8 when planes_u8 else int32; lv (n_trees,
// 2^depth, n_out) f32; out (n_rows, n_out) f32, summed in slabs of `slab`
// <= 32 outputs.  The bins are uint8 when bins_u8 (the caller guarantees
// n_borders <= 255) else int32: a tile of rows_per_block rows (a multiple
// of 32: whole warps for the ballots) of `stride` in shared memory
// (kernels/tuning.py tile_shape), or, when `scratch` is not null, the
// block's rows of an (n_rows, n_feat) scratch array.
extern "C" int repro_fused_predict_bp(const void* x, const void* borders,
                                      const void* sf_bp, const void* sb_bp,
                                      const void* lv, void* out,
                                      void* scratch, long long n_rows,
                                      int n_feat, int n_borders, int n_trees,
                                      int depth, int n_out, int bins_u8,
                                      int planes_u8, int stride,
                                      int rows_per_block, int slab,
                                      int device, void* stream) {
  cudaError_t err = select_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (slab < 1 || slab > 32) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>(
      (n_rows + rows_per_block - 1) / rows_per_block);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const float* bp = static_cast<const float*>(borders);
  const int32_t* sfp = static_cast<const int32_t*>(sf_bp);
  const float* lp = static_cast<const float*>(lv);
  float* op = static_cast<float*>(out);
  if (bins_u8) {
    return launch<uint8_t>(blocks, rows_per_block, s, xp, bp, sfp, sb_bp,
                           planes_u8, lp, op, scratch, n_rows, n_feat,
                           n_borders, n_trees, depth, n_out, stride, slab);
  }
  return launch<int32_t>(blocks, rows_per_block, s, xp, bp, sfp, sb_bp,
                         planes_u8, lp, op, scratch, n_rows, n_feat,
                         n_borders, n_trees, depth, n_out, stride, slab);
}

// The spread route (fused_spread.cuh): the arguments of
// repro_fused_predict_dm_spread without pow2, with (depth, n_trees) planes
// and sb_bp uint8 when planes_u8 else int32; `rows_per_block` rows and
// `threads` threads a block, the trees in chunks of `chunk`, outputs in
// slabs of `slab` <= 32 (kernels/tuning.py fused_plan).
extern "C" int repro_fused_predict_bp_spread(
    const void* x, const void* borders, const void* sf_bp, const void* sb_bp,
    const void* lv, void* out, long long n_rows, int n_feat, int n_borders,
    int n_trees, int depth, int n_out, int bins_u8, int planes_u8,
    int rows_per_block, int threads, int chunk, int slab, int device,
    void* stream) {
  if (planes_u8) {
    return spread_launcher<Splits::kBitpacked, uint8_t>(
        x, borders, sf_bp, sb_bp, nullptr, lv, out, n_rows, n_feat,
        n_borders, n_trees, depth, n_out, bins_u8, rows_per_block, threads,
        chunk, slab, device, stream);
  }
  return spread_launcher<Splits::kBitpacked, int32_t>(
      x, borders, sf_bp, sb_bp, nullptr, lv, out, n_rows, n_feat, n_borders,
      n_trees, depth, n_out, bins_u8, rows_per_block, threads, chunk, slab,
      device, stream);
}
