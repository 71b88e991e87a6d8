// Oblivious-tree leaf indexes over the depth-major layout:
//   idx[n, t] = sum_d pow2[d] * [bins[n, sf_dm[d, t]] >= sb_dm[d, t]],
// with the splits held as (D, T) planes: row d of sf_dm and sb_dm holds
// every tree's level-d split.
//
// Replaces the TPU kernel src/repro/kernels/leaf_index.py:leaf_index_dm
// (_leaf_index_dm_kernel).  The TPU kernel gathers each split feature with
// a matmul against a (T, D, F) f32 one-hot that the lowering precomputes,
// and sums the compare bits against the f32 `pow2` vector on the MXU.
// Neither carries over: the port lowers no one-hot (it would be 1.73 MB
// of f32 at Covertype width, read only to select one feature), each thread
// reads its bins straight from a shared-memory tile, and the weights are
// exact integers (pow2 is converted to int once per thread).
//
// What depth-major order buys on a GPU is the load of the splits: lane t
// of a warp owns tree t, so at each level the warp's 32 lanes read 32
// consecutive int32 of sf_dm[d] and of sb_dm[d], one 128-byte line each.
// The kernel is leaf_index.cuh's, with tree t's level-d split at d * T + t;
// its design and what bounds it (bytes: the (N, T) int32 output) are
// described there.
#include "leaf_index.cuh"

// bins (n_rows, n_feat) uint8 when bins_u8 else int32; sf_dm, sb_dm
// (depth, n_trees) int32 with every sf in [0, n_feat) and depth <=
// kMaxDepth; pow2 (depth, 1) f32; out (n_rows, n_trees) int32.
// rows_per_block is a multiple of kRowGroups chosen by the caller
// (kernels/tuning.py tile_rows); the rows are staged in shared memory
// unless from_global.
extern "C" int repro_leaf_index_dm(const void* bins, const void* sf_dm,
                                   const void* sb_dm, const void* pow2,
                                   void* out, long long n_rows, int n_feat,
                                   int n_trees, int depth, int bins_u8,
                                   int rows_per_block, int from_global,
                                   int device, void* stream) {
  return launch_leaf_index(bins, sf_dm, sb_dm, pow2, out, n_rows, n_feat,
                           n_trees, depth, bins_u8, rows_per_block,
                           from_global, 1, n_trees, device, stream);
}
