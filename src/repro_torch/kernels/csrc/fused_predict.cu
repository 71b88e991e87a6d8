// Fused prediction: binarize -> leaf index -> leaf gather in one pass,
//   pred[n, c] = sum_t lv[t, idx(bins[n], t), c],  bins = binarize(x).
//
// Replaces the TPU kernel src/repro/kernels/fused_predict.py:fused_predict
// (_fused_kernel).  The TPU kernel binarizes a row block once into VMEM
// scratch, then walks tree blocks as a serial grid axis, gathering with
// one-hot matmuls and carrying the sum in its output tile.  Hopper's blocks
// run in no order, so each block owns its rows outright and walks every
// tree itself: no cross-block reduction, no atomics, no one-hot.  Every
// (row, output) sum is taken in tree order, one add per tree from 0.0f,
// exactly as leaf_gather takes it, so fused and staged scores are
// bit-identical on either route.
//
// What bounds it on an H100: at the bulk shape, operations (each (row,
// tree) costs D shared-memory loads and compares plus C leaf loads: about
// 2.6e9 at N = 139,440, T = 1,000, D = 8, C = 7, against ~41 MB of bytes);
// at a serving bucket, neither: latency, unless the bucket's few rows are
// spread over the card.  kernels/tuning.py fused_plan picks one of two
// routes:
//
//   * row (many rows): one thread a row, 128 rows a block, C accumulators
//     in registers; every thread walks all T trees for its own row.  The
//     bins tile is uint8 when the ensemble has at most 255 borders (the
//     quantized-pool representation, as src/repro/kernels/ops.py picks for
//     the TPU scratch), int32 otherwise; its row stride is an odd number
//     of 4-byte words, so the 32 rows a warp reads at one feature fall in
//     32 distinct banks; split features and bins are the same for every
//     thread of a warp (one broadcast __ldg each); the leaf table stays in
//     L2.  A block costs one thread's serial walk of the T trees (a chain
//     of D dependent shared loads, then C loads from L2, a tree), so a
//     1,024-row bucket (8 blocks on 132 SMs) took as long as the bulk call
//     would on a full card.
//   * spread (a serving bucket, up to tuning.SPREAD_MAX_ROWS rows): N / 132
//     rows a block, so the bucket fills the SMs; the block binarizes its
//     rows once, then walks the trees in chunks whose leaf values it copies
//     into shared memory with cp.async and sums in tree order.  The route
//     is fused_spread.cuh, shared with fused_predict_dm.cu and
//     fused_predict_bp.cu; its design and what bounds it are described
//     there.
//
// Any C and any F (kernels/tuning.py tile_shape, output_slabs, fused_plan):
// a block walks its rows' outputs in slabs of at most 32, every slab summed
// over the trees in tree order (the leaf index recomputed a slab, from the
// bins staged once), so every (row, output) is one add a tree in tree
// order at any C.  A row-route bins tile past the default 48 KB opts in to
// up to the 227 KB limit; rows too wide for 32 of them there go through an
// (N, F) scratch array in global memory that stage 1 writes and stage 2
// reads (kStaged false).  That is the simpler of the two global routes:
// binarizing a split's feature from x where a split needs it would put B
// border compares (or a search) inside the tree loop.
#include "fused_spread.cuh"

namespace {

template <typename BinT, int MaxC, bool kStaged>
__global__ void fused_predict_kernel(
    const float* __restrict__ x, const float* __restrict__ borders,
    const int32_t* __restrict__ sf, const int32_t* __restrict__ sb,
    const float* __restrict__ lv, float* __restrict__ out,
    BinT* __restrict__ scratch, long long n_rows, int n_feat, int n_borders,
    int n_trees, int depth, int n_out, int stride, int slab) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rows_per_block = blockDim.x;
  const long long row0 =
      static_cast<long long>(blockIdx.x) * rows_per_block;
  BinT* tile = kStaged ? reinterpret_cast<BinT*>(smem_raw)
                       : scratch + row0 * stride;
  const int rows = static_cast<int>(
      min(static_cast<long long>(rows_per_block), n_rows - row0));

  // Stage 1: binarize the block's rows of x into the bins tile.
  const float* xsrc = x + row0 * n_feat;
  for (int i = threadIdx.x; i < rows * n_feat; i += rows_per_block) {
    const int r = i / n_feat;
    const int f = i - r * n_feat;
    const float v = xsrc[i];
    int count = 0;
    for (int b = 0; b < n_borders; ++b) {
      count += v > __ldg(borders + static_cast<long long>(b) * n_feat + f);
    }
    tile[static_cast<long long>(r) * stride + f] = static_cast<BinT>(count);
  }
  __syncthreads();

  // Stage 2: every tree for this thread's row, index then gather, a slab
  // of outputs at a time.
  const int r = threadIdx.x;
  if (r >= rows) return;
  const BinT* row = tile + static_cast<long long>(r) * stride;
  const int n_leaves = 1 << depth;
  for (int c0 = 0; c0 < n_out; c0 += slab) {
    const int nc = min(slab, n_out - c0);
    float acc[MaxC];
#pragma unroll
    for (int c = 0; c < MaxC; ++c) acc[c] = 0.0f;
    for (int t = 0; t < n_trees; ++t) {
      const int32_t* tsf = sf + static_cast<long long>(t) * depth;
      const int32_t* tsb = sb + static_cast<long long>(t) * depth;
      int idx = 0;
      for (int d = 0; d < depth; ++d) {
        // int32 compare: the 2^30 PAD_SPLIT_BIN never goes right
        idx |= (static_cast<int>(row[__ldg(tsf + d)]) >= __ldg(tsb + d))
               << d;
      }
      const float* leaf =
          lv + (static_cast<long long>(t) * n_leaves + idx) * n_out + c0;
#pragma unroll
      for (int c = 0; c < MaxC; ++c) {
        if (c < nc) acc[c] += __ldg(leaf + c);
      }
    }
#pragma unroll
    for (int c = 0; c < MaxC; ++c) {
      if (c < nc) out[(row0 + r) * n_out + c0 + c] = acc[c];
    }
  }
}

template <typename BinT, int MaxC>
int launch_tile(dim3 grid, int rows_per_block, size_t smem, cudaStream_t s,
                const float* x, const float* borders, const int32_t* sf,
                const int32_t* sb, const float* lv, float* out,
                BinT* scratch, long long n_rows, int n_feat, int n_borders,
                int n_trees, int depth, int n_out, int stride, int slab) {
  auto kernel = scratch != nullptr ? fused_predict_kernel<BinT, MaxC, false>
                                   : fused_predict_kernel<BinT, MaxC, true>;
  const cudaError_t err = allow_shared_memory(kernel, smem, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, rows_per_block, smem, s>>>(
      x, borders, sf, sb, lv, out, scratch, n_rows, n_feat, n_borders,
      n_trees, depth, n_out, stride, slab);
  return launch_status();
}

template <typename BinT>
int launch(dim3 grid, int rows_per_block, cudaStream_t s, const float* x,
           const float* borders, const int32_t* sf, const int32_t* sb,
           const float* lv, float* out, void* scratch, long long n_rows,
           int n_feat, int n_borders, int n_trees, int depth, int n_out,
           int stride, int slab) {
  const size_t smem = scratch != nullptr
      ? 0 : static_cast<size_t>(rows_per_block) * stride * sizeof(BinT);
  BinT* sp = static_cast<BinT*>(scratch);
  if (slab <= 8) {
    return launch_tile<BinT, 8>(grid, rows_per_block, smem, s, x, borders,
                                sf, sb, lv, out, sp, n_rows, n_feat,
                                n_borders, n_trees, depth, n_out, stride,
                                slab);
  }
  return launch_tile<BinT, 32>(grid, rows_per_block, smem, s, x, borders, sf,
                               sb, lv, out, sp, n_rows, n_feat, n_borders,
                               n_trees, depth, n_out, stride, slab);
}

}  // namespace

// x (n_rows, n_feat) f32; borders (n_borders, n_feat) f32; sf, sb
// (n_trees, depth) int32 with every sf in [0, n_feat) and depth <=
// kMaxDepth; lv (n_trees, 2^depth, n_out) f32; out (n_rows, n_out) f32,
// summed in slabs of `slab` <= 32 outputs.  The bins are uint8 when
// bins_u8 (the caller guarantees n_borders <= 255) else int32, with
// `stride` elements a row: a tile of rows_per_block rows in shared memory
// (kernels/tuning.py tile_shape), or, when `scratch` is not null, the
// block's rows of an (n_rows, stride = n_feat) scratch array.
extern "C" int repro_fused_predict(const void* x, const void* borders,
                                   const void* sf, const void* sb,
                                   const void* lv, void* out, void* scratch,
                                   long long n_rows, int n_feat,
                                   int n_borders, int n_trees, int depth,
                                   int n_out, int bins_u8, int stride,
                                   int rows_per_block, int slab, int device,
                                   void* stream) {
  cudaError_t err = select_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (slab < 1 || slab > 32) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(
      (n_rows + rows_per_block - 1) / rows_per_block));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const float* bp = static_cast<const float*>(borders);
  const int32_t* sfp = static_cast<const int32_t*>(sf);
  const int32_t* sbp = static_cast<const int32_t*>(sb);
  const float* lp = static_cast<const float*>(lv);
  float* op = static_cast<float*>(out);
  if (bins_u8) {
    return launch<uint8_t>(grid, rows_per_block, s, xp, bp, sfp, sbp, lp, op,
                           scratch, n_rows, n_feat, n_borders, n_trees,
                           depth, n_out, stride, slab);
  }
  return launch<int32_t>(grid, rows_per_block, s, xp, bp, sfp, sbp, lp, op,
                         scratch, n_rows, n_feat, n_borders, n_trees, depth,
                         n_out, stride, slab);
}

// The spread route (fused_spread.cuh): the same function and arguments,
// `rows_per_block` rows and `threads` threads a block (a multiple of 32 up
// to kSpreadMaxThreads, rows_per_block * slab <= kSpreadMaxAcc * threads),
// the trees in chunks of `chunk`, outputs in slabs of `slab` <= 32
// (kernels/tuning.py fused_plan); the block's bins stay in shared memory.
extern "C" int repro_fused_predict_spread(
    const void* x, const void* borders, const void* sf, const void* sb,
    const void* lv, void* out, long long n_rows, int n_feat, int n_borders,
    int n_trees, int depth, int n_out, int bins_u8, int rows_per_block,
    int threads, int chunk, int slab, int device, void* stream) {
  return spread_launcher<Splits::kRows>(
      x, borders, sf, sb, nullptr, lv, out, n_rows, n_feat, n_borders,
      n_trees, depth, n_out, bins_u8, rows_per_block, threads, chunk, slab,
      device, stream);
}
