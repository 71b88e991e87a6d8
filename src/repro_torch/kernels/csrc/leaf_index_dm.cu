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
// exact integers (pow2 is truncated to int once per thread and read only
// where it is not 2^d, which no lowering gives).
//
// What depth-major order buys on a GPU is the load of the splits: thread j
// of a block stages tree t0 + j of a round, so at each level a warp's 32
// threads read 32 consecutive int32 of sf_dm[d] and of sb_dm[d], one
// 128-byte line each.  The kernel is leaf_index.cuh's, with tree t's
// level-d split at d * T + t; its design and what bounds it (bytes: the
// (N, T) int32 output) are described there.
#include "leaf_index.cuh"

// bins (n_rows, n_feat) uint8 when bins_u8 else int32; sf_dm, sb_dm
// (depth, n_trees) int32 with every sf in [0, n_feat) and depth <=
// kMaxDepth; pow2 (depth, 1) f32; out (n_rows, n_trees) int32.  The plan
// is the caller's (kernels/tuning.py index_plan), as for repro_leaf_index.
extern "C" int repro_leaf_index_dm(const void* bins, const void* sf_dm,
                                   const void* sb_dm, const void* pow2,
                                   void* out, long long n_rows, int n_feat,
                                   int n_trees, int depth, int bins_u8,
                                   int rows_per_block, int from_global,
                                   int tree_groups, int rounds_per_group,
                                   int device, void* stream) {
  return launch_leaf_index<true>(bins, sf_dm, sb_dm, pow2, out, n_rows,
                                 n_feat, n_trees, depth, bins_u8,
                                 rows_per_block, from_global, tree_groups,
                                 rounds_per_group, 1, n_trees, device,
                                 stream);
}
