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
//   * spread (a serving bucket, up to tuning.SPREAD_MAX_ROWS rows): R =
//     N / 132 rows a block (1 at a 16-row bucket, 7 at 1,024), so the
//     bucket fills the SMs.  The block binarizes its R rows into a shared
//     bins tile (the compare loop, a thread a feature of 8 rows, so each
//     border it loads serves 8 compares; a feature's borders split over a
//     few lanes where features are fewer than threads), then walks the
//     trees in chunks of Tc (tuning.fused_plan): the chunk's splits go to
//     shared memory as a (D, Tc) plane of (feature, bin) pairs (cp.async,
//     coalesced reads); threads over the (row, tree) pairs
//     compute each idx from the staged bins; lane groups over (row, tree),
//     a lane an output of the slab, gather lv[t, idx, c0 + c] into a
//     shared (R, Tc, slab) buffer with 4-byte cp.async, every copy of the
//     chunk in flight at once (a warp's copies fall on a few (row, tree)
//     leaf rows, so L1 serves each instruction in a few wavefronts); and
//     lanes over (row, output) add the chunk's Tc values, in tree order,
//     to a register accumulator that lives across chunks.  The buffers are
//     doubled: chunk k's copies are in flight while the lanes sum chunk
//     k - 1 and the threads index chunk k + 1.  Parallelism comes from
//     rows x trees for the compares and the copies and from rows x outputs
//     for the adds; a row's tree sum is never split.  On the card
//     (scripts/fused_spread_probe.py, PERF.md) a 1,024-row bucket's block
//     spends about half of each chunk issuing the 4-byte copies (plain
//     loads through registers were slower), a quarter indexing and a fifth
//     summing; the compares of stage 1 take most of a block at the kNN
//     head's 533 features.
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
// border compares (or a search) inside the tree loop.  The spread route
// takes a shape only where its R rows of bins fit shared memory with the
// smallest chunk; past that the plan keeps the row route.
#include "common.cuh"

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

// ---------------------------------------------------------------------------
// The spread route
// ---------------------------------------------------------------------------
constexpr int kSpreadMaxAcc = 4;   // (row, output) sums a thread holds
// Threads a spread block has at most: 128 registers a thread, so the sums
// and a pass's rows stay out of local memory.
constexpr int kSpreadMaxThreads = 512;
constexpr int kBinarizeRows = 8;   // rows a border load serves in stage 1

// An asynchronous 4-byte copy from global to shared memory (sm_80+), and
// the calls that close a group of them and wait for every group.
__device__ inline void copy_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}
__device__ inline void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ inline void copy_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}
// Wait for all but the most recent group.
__device__ inline void copy_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__host__ __device__ inline size_t align16(size_t bytes) {
  return (bytes + 15) & ~static_cast<size_t>(15);
}

// Words of one row's leaf values in a buffer, padded to slab (mod 32) so
// that a warp's lanes, summing consecutive (row, output) pairs at one tree,
// read 32 distinct banks (kernels/tuning.py spread_pitch).
__host__ __device__ inline int spread_pitch(int chunk, int slab) {
  const int words = chunk * slab;
  return words + ((slab - words) % 32 + 32) % 32;
}

// Byte offsets of a spread block's shared memory (tuning.py
// spread_smem_bytes): two leaf-value buffers of `buf` bytes each, the
// chunk's (row, tree) indexes, its (D, chunk) plane of (split feature,
// split bin) pairs, the bins tile.
struct SpreadLayout {
  size_t buf, idx, split, tile, total;
};

__host__ __device__ inline SpreadLayout spread_layout(int rows, int chunk,
                                                      int slab, int depth,
                                                      int n_feat,
                                                      int bin_bytes) {
  SpreadLayout l;
  l.buf = align16(static_cast<size_t>(rows) * spread_pitch(chunk, slab) *
                  sizeof(float));
  l.idx = 2 * l.buf;
  l.split = l.idx + align16(static_cast<size_t>(rows) * chunk * 4);
  l.tile = l.split + align16(static_cast<size_t>(2) * depth * chunk * 4);
  l.total = l.tile + align16(static_cast<size_t>(rows) * n_feat * bin_bytes);
  return l;
}

// Adds a buffer's tc trees, in tree order, to this thread's first N sums
// (all of them live): eight trees' values of every sum loaded ahead of
// their adds, so a sum waits on one shared load every eight trees, not
// every tree.  Inlined so the sums stay in registers.
template <int N>
__device__ __forceinline__ void sum_trees(float (&acc)[kSpreadMaxAcc],
                                          const int (&off)[kSpreadMaxAcc],
                                          const float* buf, int tc, int nc) {
  int t = 0;
#pragma unroll 2
  for (; t + 8 <= tc; t += 8) {
    float v[N][8];
#pragma unroll
    for (int j = 0; j < N; ++j) {
#pragma unroll
      for (int u = 0; u < 8; ++u) v[j][u] = buf[off[j] + (t + u) * nc];
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
#pragma unroll
      for (int j = 0; j < N; ++j) acc[j] += v[j][u];
    }
  }
  for (; t < tc; ++t) {
#pragma unroll
    for (int j = 0; j < N; ++j) acc[j] += buf[off[j] + t * nc];
  }
}

// Stage 1 of a spread block: its `rows` rows of x binarized into the tile
// (row stride n_feat).  A work item is one feature of a pass of up to
// kRows rows: each border a thread loads serves that many compares.  Where
// the items leave threads idle, an item's borders are split over a group
// of lanes (a power of two) and the counts summed with shuffles.
template <int kRows, typename BinT>
__device__ __forceinline__ void binarize_rows(
    const float* __restrict__ xsrc, const float* __restrict__ borders,
    BinT* tile, int rows, int n_feat, int n_borders, int tid,
    int n_threads) {
  const int n_items = (rows + kRows - 1) / kRows * n_feat;
  int shift = 0;
  while (shift < 5 && (n_items << (shift + 1)) <= n_threads &&
         (8 << (shift + 1)) <= n_borders) {
    ++shift;
  }
  const int group = 1 << shift;
  const int total = n_items << shift;
  for (int q0 = 0; q0 < total; q0 += n_threads) {   // uniform trip count
    const int q = q0 + tid;
    const bool on = q < total;
    const int item = q >> shift;
    const int pass = item / n_feat;
    const int f = item - pass * n_feat;
    const int r0 = pass * kRows;
    const int nr = min(kRows, rows - r0);
    float v[kRows];
    int count[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      count[r] = 0;
      v[r] = on && r < nr
                 ? xsrc[static_cast<long long>(r0 + r) * n_feat + f]
                 : 0.0f;
    }
    if (on) {
#pragma unroll 8
      for (int b = q & (group - 1); b < n_borders; b += group) {
        const float border =
            __ldg(borders + static_cast<long long>(b) * n_feat + f);
#pragma unroll
        for (int r = 0; r < kRows; ++r) count[r] += v[r] > border;
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      for (int o = group >> 1; o > 0; o >>= 1) {
        count[r] += __shfl_xor_sync(0xffffffffu, count[r], o);
      }
      if (on && r < nr && (q & (group - 1)) == 0) {
        tile[(r0 + r) * n_feat + f] = static_cast<BinT>(count[r]);
      }
    }
  }
}

template <typename BinT>
__global__ void __launch_bounds__(kSpreadMaxThreads) fused_spread_kernel(
    const float* __restrict__ x, const float* __restrict__ borders,
    const int32_t* __restrict__ sf, const int32_t* __restrict__ sb,
    const float* __restrict__ lv, float* __restrict__ out, long long n_rows,
    int n_feat, int n_borders, int n_trees, int depth, int n_out,
    int rows_per_block, int chunk, int slab) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const SpreadLayout lay = spread_layout(rows_per_block, chunk, slab, depth,
                                         n_feat, sizeof(BinT));
  float* bufs = reinterpret_cast<float*>(smem_raw);
  const size_t buf_words = lay.buf / sizeof(float);
  int* s_idx = reinterpret_cast<int*>(smem_raw + lay.idx);
  int2* s_split = reinterpret_cast<int2*>(smem_raw + lay.split);
  BinT* tile = reinterpret_cast<BinT*>(smem_raw + lay.tile);
  const int pitch = spread_pitch(chunk, slab);

  const int tid = threadIdx.x;
  const int n_threads = blockDim.x;
  const long long row0 =
      static_cast<long long>(blockIdx.x) * rows_per_block;
  const int rows = static_cast<int>(
      min(static_cast<long long>(rows_per_block), n_rows - row0));
  const int n_leaves = 1 << depth;
  const int n_chunks = (n_trees + chunk - 1) / chunk;

  // Stage 1: binarize the block's rows of x into the bins tile.
  const float* xsrc = x + row0 * n_feat;
  if (rows == 1) {
    binarize_rows<1>(xsrc, borders, tile, rows, n_feat, n_borders, tid,
                     n_threads);
  } else {
    binarize_rows<kBinarizeRows>(xsrc, borders, tile, rows, n_feat,
                                 n_borders, tid, n_threads);
  }

  // A chunk's splits, as a (D, chunk) plane of (feature, bin) pairs copied
  // asynchronously from the (T, D) arrays (coalesced reads), one commit
  // group.
  auto stage_splits = [&](int k) {
    const int t0 = k * chunk;
    const int tc = min(chunk, n_trees - t0);
    const long long base = static_cast<long long>(t0) * depth;
    for (int i = tid; i < tc * depth; i += n_threads) {
      const int t = i / depth;
      int2* dst = s_split + (i - t * depth) * chunk + t;
      copy_async4(&dst->x, sf + base + i);
      copy_async4(&dst->y, sb + base + i);
    }
    copy_commit();
  };
  // A chunk's (row, tree) indexes from the staged bins and splits: pairs
  // p = tid + i * n_threads, (row p / tc, tree p % tc).
  auto index_chunk = [&](int k) {
    const int tc = min(chunk, n_trees - k * chunk);
    const int n_pairs = rows * tc;
    const int n_mine = tid < n_pairs ? (n_pairs - tid - 1) / n_threads + 1
                                     : 0;
    int r = tid / tc;
    int t = tid - r * tc;
    const int step_r = n_threads / tc;
    const int step_t = n_threads - step_r * tc;
#pragma unroll 2
    for (int i = 0; i < n_mine; ++i) {
      const BinT* row = tile + r * n_feat;
      int idx = 0;
#pragma unroll 4
      for (int d = 0; d < depth; ++d) {
        const int2 split = s_split[d * chunk + t];
        // int32 compare: the 2^30 PAD_SPLIT_BIN never goes right
        idx |= (static_cast<int>(row[split.x]) >= split.y) << d;
      }
      s_idx[r * chunk + t] = idx;
      r += step_r;
      t += step_t;
      if (t >= tc) {
        t -= tc;
        ++r;
      }
    }
  };

  for (int c0 = 0; c0 < n_out; c0 += slab) {
    const int nc = min(slab, n_out - c0);
    // Lane groups of `lanes` (the slab rounded up to a power of two) copy
    // one (row, tree) pair's nc leaf values, lane c output c0 + c.
    int lane_shift = 0;
    while ((1 << lane_shift) < nc) ++lane_shift;
    const int lanes = 1 << lane_shift;
    const int slots = n_threads >> lane_shift;
    // This thread's sums: s = tid + j * n_threads < rows * nc is (row
    // s / nc, output s % nc), at offset r * pitch + c of a buffer.
    float acc[kSpreadMaxAcc];
    int acc_off[kSpreadMaxAcc];
    int n_acc = 0;                     // this thread's live sums come first
#pragma unroll
    for (int j = 0; j < kSpreadMaxAcc; ++j) {
      const int s = tid + j * n_threads;
      acc[j] = 0.0f;
      acc_off[j] = s < rows * nc ? (s / nc) * pitch + s % nc : 0;
      n_acc += s < rows * nc;
    }
    auto gather_chunk = [&](int k) {
      const int t0 = k * chunk;
      const int tc = min(chunk, n_trees - t0);
      float* buf = bufs + (k & 1) * buf_words;
      const int c = tid & (lanes - 1);
      const int p = tid >> lane_shift;
      const int n_pairs = rows * tc;
      const int n_mine =
          c < nc && p < n_pairs ? (n_pairs - p - 1) / slots + 1 : 0;
      int r = p / tc;
      int t = p - r * tc;
      const int step_r = slots / tc;
      const int step_t = slots - step_r * tc;
#pragma unroll 4
      for (int i = 0; i < n_mine; ++i) {
        const float* src =
            lv + (static_cast<long long>(t0 + t) * n_leaves +
                  s_idx[r * chunk + t]) * n_out + c0 + c;
        copy_async4(buf + r * pitch + t * nc + c, src);
        r += step_r;
        t += step_t;
        if (t >= tc) {
          t -= tc;
          ++r;
        }
      }
      copy_commit();
    };
    // Tree order: each sum adds the chunk's trees one at a time.
    auto sum_chunk = [&](int k) {
      const float* buf = bufs + (k & 1) * buf_words;
      const int tc = min(chunk, n_trees - k * chunk);
      switch (n_acc) {
        case 1: sum_trees<1>(acc, acc_off, buf, tc, nc); break;
        case 2: sum_trees<2>(acc, acc_off, buf, tc, nc); break;
        case 3: sum_trees<3>(acc, acc_off, buf, tc, nc); break;
        case 4: sum_trees<4>(acc, acc_off, buf, tc, nc); break;
        default: break;
      }
    };

    stage_splits(0);
    copy_wait_all();
    __syncthreads();                   // the bins tile and chunk 0's splits
    index_chunk(0);
    __syncthreads();
    for (int k = 0; k < n_chunks; ++k) {
      // Chunk k + 1's splits, then chunk k's leaf values: two commit
      // groups in flight while the lanes sum chunk k - 1.
      if (k + 1 < n_chunks) {
        stage_splits(k + 1);
      } else {
        copy_commit();                 // an empty group keeps the count
      }
      gather_chunk(k);
      if (k > 0) sum_chunk(k - 1);
      copy_wait_one();                 // this thread's split copies
      __syncthreads();                 // splits staged; chunk k's idx read
      if (k + 1 < n_chunks) index_chunk(k + 1);
      copy_wait_all();
      __syncthreads();                 // chunk k's values and k + 1's idx
    }
    sum_chunk(n_chunks - 1);
#pragma unroll
    for (int j = 0; j < kSpreadMaxAcc; ++j) {
      const int s = tid + j * n_threads;
      if (j < n_acc) out[(row0 + s / nc) * n_out + c0 + s % nc] = acc[j];
    }
    // The next slab's first chunk reuses buffer 0 after the two barriers
    // of its prologue.
  }
}

template <typename BinT>
int launch_spread(int rows_per_block, int threads, int chunk, int slab,
                  cudaStream_t s, const float* x, const float* borders,
                  const int32_t* sf, const int32_t* sb, const float* lv,
                  float* out, long long n_rows, int n_feat, int n_borders,
                  int n_trees, int depth, int n_out) {
  const SpreadLayout lay = spread_layout(rows_per_block, chunk, slab, depth,
                                         n_feat, sizeof(BinT));
  auto kernel = fused_spread_kernel<BinT>;
  const cudaError_t err = allow_shared_memory(kernel, lay.total, lay.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(
      (n_rows + rows_per_block - 1) / rows_per_block));
  kernel<<<grid, threads, lay.total, s>>>(
      x, borders, sf, sb, lv, out, n_rows, n_feat, n_borders, n_trees,
      depth, n_out, rows_per_block, chunk, slab);
  return launch_status();
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

// The spread route: the same function and arguments, `rows_per_block` rows
// and `threads` threads a block (a multiple of 32 up to kSpreadMaxThreads,
// rows_per_block * slab <= kSpreadMaxAcc * threads), the trees in chunks of
// `chunk`, outputs in slabs of `slab` <= 32 (kernels/tuning.py
// fused_plan); the block's bins stay in shared memory.
extern "C" int repro_fused_predict_spread(
    const void* x, const void* borders, const void* sf, const void* sb,
    const void* lv, void* out, long long n_rows, int n_feat, int n_borders,
    int n_trees, int depth, int n_out, int bins_u8, int rows_per_block,
    int threads, int chunk, int slab, int device, void* stream) {
  cudaError_t err = select_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (slab < 1 || slab > 32 || chunk < 1 || rows_per_block < 1 ||
      threads < 32 || threads > kSpreadMaxThreads || threads % 32 != 0 ||
      rows_per_block * slab > kSpreadMaxAcc * threads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const float* bp = static_cast<const float*>(borders);
  const int32_t* sfp = static_cast<const int32_t*>(sf);
  const int32_t* sbp = static_cast<const int32_t*>(sb);
  const float* lp = static_cast<const float*>(lv);
  float* op = static_cast<float*>(out);
  if (bins_u8) {
    return launch_spread<uint8_t>(rows_per_block, threads, chunk, slab, s,
                                  xp, bp, sfp, sbp, lp, op, n_rows, n_feat,
                                  n_borders, n_trees, depth, n_out);
  }
  return launch_spread<int32_t>(rows_per_block, threads, chunk, slab, s, xp,
                                bp, sfp, sbp, lp, op, n_rows, n_feat,
                                n_borders, n_trees, depth, n_out);
}
