// Fused prediction over the depth-major layout:
//   pred[n, c] = sum_t lv[t, idx(bins[n], t), c],  bins = binarize(x),
//   idx(b, t) = sum_d pow2[d] * [b[sf_dm[d, t]] >= sb_dm[d, t]].
//
// Replaces the TPU kernel src/repro/kernels/fused_predict.py:
// fused_predict_dm (_fused_dm_kernel).  The TPU kernel gathers each split
// feature with a matmul against the lowered (T, D, F) f32 one-hot and
// weighs the compare bits with the f32 pow2 vector on the MXU; here a
// thread reads its bins from shared memory at the split feature itself
// (the port lowers no one-hot) and adds the weights as integers.
//
// It computes soa's function from soa's model (the lowering sets pow2[d]
// = 2^d), so it has soa's two routes, which kernels/tuning.py fused_plan
// (splits="planes") picks from the shape:
//   * row (many rows): fused_planes.cuh with int32 planes, a thread a row
//     walking every tree, the planes staged a chunk of trees at a time;
//   * spread (a serving bucket): fused_spread.cuh with Splits::kPlanes,
//     N / 132 rows a block, row d of a chunk's splits copied from the
//     contiguous slice of plane d.
// Their designs and what bounds them are described in the two headers.
// Both sum every (row, output) in tree order, one add a tree from 0.0f, so
// both routes give soa's scores bit for bit.
#include "fused_planes.cuh"
#include "fused_spread.cuh"

// x (n_rows, n_feat) f32; borders (n_borders, n_feat) f32; sf_dm, sb_dm
// (depth, n_trees) int32 with every sf in [0, n_feat) and depth <=
// kMaxDepth; pow2 (depth, 1) f32; lv (n_trees, 2^depth, n_out) f32; out
// (n_rows, n_out) f32, summed in slabs of `slab` <= 32 outputs.  The bins
// are uint8 when bins_u8 (the caller guarantees n_borders <= 255) else
// int32: a tile of rows_per_block rows of `stride` in shared memory
// (kernels/tuning.py tile_shape), or, when `scratch` is not null, the
// block's rows of an (n_rows, n_feat) scratch array.
extern "C" int repro_fused_predict_dm(const void* x, const void* borders,
                                      const void* sf_dm, const void* sb_dm,
                                      const void* pow2, const void* lv,
                                      void* out, void* scratch,
                                      long long n_rows, int n_feat,
                                      int n_borders, int n_trees, int depth,
                                      int n_out, int bins_u8, int stride,
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
  const int32_t* sfp = static_cast<const int32_t*>(sf_dm);
  const int32_t* sbp = static_cast<const int32_t*>(sb_dm);
  const float* wp = static_cast<const float*>(pow2);
  const float* lp = static_cast<const float*>(lv);
  float* op = static_cast<float*>(out);
  if (bins_u8) {
    return launch_fused_planes<uint8_t, int32_t, false>(
        blocks, rows_per_block, s, xp, bp, sfp, sbp, wp, lp, op, scratch,
        n_rows, n_feat, n_borders, n_trees, depth, n_out, stride, slab);
  }
  return launch_fused_planes<int32_t, int32_t, false>(
      blocks, rows_per_block, s, xp, bp, sfp, sbp, wp, lp, op, scratch,
      n_rows, n_feat, n_borders, n_trees, depth, n_out, stride, slab);
}

// The spread route (fused_spread.cuh): the arguments of
// repro_fused_predict_spread, with (depth, n_trees) planes and the (depth,
// 1) f32 level weights pow2; `rows_per_block` rows and `threads` threads a
// block, the trees in chunks of `chunk`, outputs in slabs of `slab` <= 32
// (kernels/tuning.py fused_plan).
extern "C" int repro_fused_predict_dm_spread(
    const void* x, const void* borders, const void* sf_dm, const void* sb_dm,
    const void* pow2, const void* lv, void* out, long long n_rows,
    int n_feat, int n_borders, int n_trees, int depth, int n_out,
    int bins_u8, int rows_per_block, int threads, int chunk, int slab,
    int device, void* stream) {
  return spread_launcher<Splits::kPlanes>(
      x, borders, sf_dm, sb_dm, pow2, lv, out, n_rows, n_feat, n_borders,
      n_trees, depth, n_out, bins_u8, rows_per_block, threads, chunk, slab,
      device, stream);
}
