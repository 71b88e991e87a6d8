// Oblivious-tree leaf indexes over the soa layout's (T, D) splits:
//   idx[n, t] = sum_d 2^d * [bins[n, sf[t, d]] >= sb[t, d]]
//
// Replaces the TPU kernels src/repro/kernels/leaf_index.py:leaf_index and
// leaf_index_u8 (_leaf_index_kernel).  The TPU kernel gathers the split
// features with a one-hot matmul on the MXU; that is a TPU workaround and
// is not carried over: here each thread reads its bins straight from a
// tile in shared memory.  The kernel is leaf_index.cuh's, with tree t's
// level-d split at t * D + d, staged into the round's split pairs; its
// design and what bounds it are described there.
#include "leaf_index.cuh"

// bins (n_rows, n_feat) uint8 when bins_u8 else int32; sf, sb (n_trees,
// depth) int32 with every sf in [0, n_feat) and depth <= kMaxDepth;
// out (n_rows, n_trees) int32.  The plan is the caller's
// (kernels/tuning.py index_plan): rows_per_block rows a block, staged in
// shared memory unless from_global, and tree_groups groups (grid.y) of
// rounds_per_group 256-tree rounds.
extern "C" int repro_leaf_index(const void* bins, const void* sf,
                                const void* sb, void* out, long long n_rows,
                                int n_feat, int n_trees, int depth,
                                int bins_u8, int rows_per_block,
                                int from_global, int tree_groups,
                                int rounds_per_group, int device,
                                void* stream) {
  return launch_leaf_index<false>(bins, sf, sb, nullptr, out, n_rows,
                                  n_feat, n_trees, depth, bins_u8,
                                  rows_per_block, from_global, tree_groups,
                                  rounds_per_group, depth, 1, device, stream);
}
