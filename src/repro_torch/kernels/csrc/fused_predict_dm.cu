// Fused prediction over the depth-major layout:
//   pred[n, c] = sum_t lv[t, idx(bins[n], t), c],  bins = binarize(x),
//   idx(b, t) = sum_d pow2[d] * [b[sf_dm[d, t]] >= sb_dm[d, t]].
//
// Replaces the TPU kernel src/repro/kernels/fused_predict.py:
// fused_predict_dm (_fused_dm_kernel).  The TPU kernel gathers each split
// feature with a matmul against the lowered (T, D, F) f32 one-hot and
// weighs the compare bits with the f32 pow2 vector on the MXU; here a
// thread reads its bins from shared memory at the split feature itself
// (the port lowers no one-hot) and adds the weights as integers.  The
// kernel is fused_planes.cuh with int32 planes; its design and what bounds
// it are described there.
#include "fused_planes.cuh"

namespace {

template <typename BinT>
void launch(unsigned blocks, int rows_per_block, cudaStream_t s,
            const float* x, const float* borders, const int32_t* sf,
            const int32_t* sb, const float* pow2, const float* lv,
            float* out, long long n_rows, int n_feat, int n_borders,
            int n_trees, int depth, int n_out, int stride) {
  launch_fused_planes<BinT, int32_t, false>(
      blocks, rows_per_block, s, x, borders, sf, sb, pow2, lv, out, n_rows,
      n_feat, n_borders, n_trees, depth, n_out, stride);
}

}  // namespace

// x (n_rows, n_feat) f32; borders (n_borders, n_feat) f32; sf_dm, sb_dm
// (depth, n_trees) int32 with every sf in [0, n_feat) and depth <=
// kMaxDepth; pow2 (depth, 1) f32; lv (n_trees, 2^depth, n_out) f32 with
// n_out <= 32; out (n_rows, n_out) f32.  The bins tile is uint8 when
// bins_u8 (the caller guarantees n_borders <= 255) else int32, with
// `stride` elements a row; with the 16 KB of staged planes it fits 48 KB.
extern "C" int repro_fused_predict_dm(const void* x, const void* borders,
                                      const void* sf_dm, const void* sb_dm,
                                      const void* pow2, const void* lv,
                                      void* out, long long n_rows,
                                      int n_feat, int n_borders, int n_trees,
                                      int depth, int n_out, int bins_u8,
                                      int stride, int rows_per_block,
                                      int device, void* stream) {
  cudaError_t err = select_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
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
    launch<uint8_t>(blocks, rows_per_block, s, xp, bp, sfp, sbp, wp, lp, op,
                    n_rows, n_feat, n_borders, n_trees, depth, n_out, stride);
  } else {
    launch<int32_t>(blocks, rows_per_block, s, xp, bp, sfp, sbp, wp, lp, op,
                    n_rows, n_feat, n_borders, n_trees, depth, n_out, stride);
  }
  return launch_status();
}
