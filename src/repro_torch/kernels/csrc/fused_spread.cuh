// The spread route of the fused kernels, for a serving bucket:
//   pred[n, c] = sum_t lv[t, idx(bins[n], t), c],  bins = binarize(x),
// shared by fused_predict.cu (soa: (T, D) split rows, level d weighs
// 1 << d), fused_predict_dm.cu (depth_major: (D, T) int32 split planes,
// level d weighs pow2[d]) and fused_predict_bp.cu (bitpacked: (D, T)
// planes with uint8 or int32 thresholds, level d weighs 1 << d).  The
// template parameters Splits and SplitT (the threshold type) say which.
//
// A bucket, up to tuning.SPREAD_MAX_ROWS rows (SPREAD_MAX_ROWS_DM and
// SPREAD_MAX_ROWS_BP for the planes), is spread over the card:
// R = N / 132 rows a block (1 at a 16-row bucket, 7 at 1,024), so the
// bucket fills the SMs.  The block binarizes its R rows into a shared bins
// tile (the compare loop, a thread a feature of 8 rows, so each border it
// loads serves 8 compares; a feature's borders split over a few lanes
// where features are fewer than threads), then walks the trees in chunks
// of Tc (tuning.fused_plan): the chunk's splits go to shared memory as a
// (D, Tc) plane of (feature, bin) pairs (cp.async, coalesced reads);
// threads over the (row, tree) pairs compute each idx from the staged bins;
// lane groups over (row, tree), a lane an output of the slab, gather
// lv[t, idx, c0 + c] into a shared (R, Tc, slab) buffer with 4-byte
// cp.async, every copy of the chunk in flight at once (a warp's copies fall
// on a few (row, tree) leaf rows, so L1 serves each instruction in a few
// wavefronts); and lanes over (row, output) add the chunk's Tc values, in
// tree order, to a register accumulator that lives across chunks.  The
// buffers are doubled: chunk k's copies are in flight while the lanes sum
// chunk k - 1 and the threads index chunk k + 1.  Parallelism comes from
// rows x trees for the compares and the copies and from rows x outputs for
// the adds; a row's tree sum is never split, so every (row, output) is one
// add a tree in tree order from 0.0f, as on the row routes and in
// leaf_gather.cu.  On the card (scripts/fused_spread_probe.py, PERF.md) a
// 1,024-row bucket's block spends about half of each chunk issuing the
// 4-byte copies (plain loads through registers were slower), a quarter
// indexing and a fifth summing; the compares of stage 1 take most of a
// block at the kNN head's 533 features.
//
// Where a chunk's splits come from is all that Splits changes:
//   * kRows (soa): tree t's D splits are the row sf[t * D, t * D + D);
//     consecutive threads copy consecutive (tree, level) entries, each to
//     its level's row of the plane.  Level d weighs 1 << d.
//   * kPlanes (depth_major): row d of the chunk is the contiguous slice
//     sf_dm[d * T + t0, d * T + t0 + Tc), copied by consecutive threads
//     into row d of the same plane.  Level d weighs weight_s[d] =
//     __float2int_rn(pow2[d]), 64 bytes of static shared memory
//     (tuning.SPREAD_WEIGHT_BYTES), as fused_planes.cuh's row kernel
//     weighs it; the lowering sets pow2[d] = 2^d, so both layouts give
//     one idx and one sum, bit for bit.
//   * kBitpacked: kPlanes' slices, and soa's 1 << d (no weights, so no
//     static shared memory).  An int32 threshold plane is copied as
//     kPlanes copies it; a uint8 one with plain byte loads widened to
//     int32: cp.async copies only aligned 4, 8 or 16 bytes, and a byte
//     slice starts at d * T + t0, aligned only when T % 4 == 0.  A chunk
//     holds D * Tc <= 1,024 thresholds at the bucket against R * Tc * C
//     = 6,272 leaf copies, so the loads cost little.  One-group bitpacked
//     keeps the trees in model order, so it gives soa's sums bit for bit.
//
// A shape takes this route only where its R rows of bins fit shared
// memory with the smallest chunk (tuning.fused_plan); past that the plan
// keeps the row route.
#pragma once

#include "common.cuh"

namespace {

// Where a spread block's chunk of splits comes from (see above).
enum class Splits { kRows, kPlanes, kBitpacked };

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

// Byte offsets of a spread block's dynamic shared memory (tuning.py
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

// sf, sb: (T, D) rows for kRows, (D, T) planes otherwise; sb is int32
// but for a uint8 bitpacked plane; pow2 (D, 1) f32 level weights, read
// only for kPlanes.
template <typename BinT, Splits kSplits, typename SplitT>
__global__ void __launch_bounds__(kSpreadMaxThreads) fused_spread_kernel(
    const float* __restrict__ x, const float* __restrict__ borders,
    const int32_t* __restrict__ sf, const SplitT* __restrict__ sb,
    const float* __restrict__ pow2, const float* __restrict__ lv,
    float* __restrict__ out, long long n_rows, int n_feat, int n_borders,
    int n_trees, int depth, int n_out, int rows_per_block, int chunk,
    int slab) {
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

  // The level weights of the planes (read after the first barrier).
  int32_t* weight_s = nullptr;
  if constexpr (kSplits == Splits::kPlanes) {
    __shared__ int32_t weights[kMaxDepth];
    if (tid < depth) weights[tid] = __float2int_rn(__ldg(pow2 + tid));
    weight_s = weights;
  }

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
  // asynchronously (coalesced reads), one commit group.
  auto stage_splits = [&](int k) {
    const int t0 = k * chunk;
    const int tc = min(chunk, n_trees - t0);
    if constexpr (kSplits == Splits::kBitpacked && sizeof(SplitT) == 1) {
      // the planes' entries as below; each uint8 threshold a byte load
      // widened into the pair (read after the barrier that follows this
      // chunk's wait).  Not unrolled: unrolled four times the kernel took
      // 110-112 registers, so one block an SM and 147 blocks in two waves
      // at the 1,024-row bucket (PERF.md §6)
      for (int i = tid; i < tc * depth; i += n_threads) {
        const int d = i / tc;
        const int t = i - d * tc;
        const long long at = static_cast<long long>(d) * n_trees + t0 + t;
        const int bin = __ldg(sb + at);
        int2* dst = s_split + d * chunk + t;
        copy_async4(&dst->x, sf + at);
        dst->y = bin;
      }
    } else if constexpr (kSplits != Splits::kRows) {
      // entry i is (level i / tc, tree i % tc): row d of the chunk is
      // contiguous in each plane
      for (int i = tid; i < tc * depth; i += n_threads) {
        const int d = i / tc;
        const int t = i - d * tc;
        const long long at = static_cast<long long>(d) * n_trees + t0 + t;
        int2* dst = s_split + d * chunk + t;
        copy_async4(&dst->x, sf + at);
        copy_async4(&dst->y, sb + at);
      }
    } else {
      // entry i is (tree i / depth, level i % depth) of the (T, D) rows
      const long long base = static_cast<long long>(t0) * depth;
      for (int i = tid; i < tc * depth; i += n_threads) {
        const int t = i / depth;
        int2* dst = s_split + (i - t * depth) * chunk + t;
        copy_async4(&dst->x, sf + base + i);
        copy_async4(&dst->y, sb + base + i);
      }
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
        const bool go = static_cast<int>(row[split.x]) >= split.y;
        if constexpr (kSplits == Splits::kPlanes) {
          if (go) idx += weight_s[d];
        } else {
          idx |= go << d;
        }
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

template <typename BinT, Splits kSplits, typename SplitT>
int launch_spread(int rows_per_block, int threads, int chunk, int slab,
                  cudaStream_t s, const void* x, const void* borders,
                  const void* sf, const void* sb, const void* pow2,
                  const void* lv, void* out, long long n_rows, int n_feat,
                  int n_borders, int n_trees, int depth, int n_out) {
  const SpreadLayout lay = spread_layout(rows_per_block, chunk, slab, depth,
                                         n_feat, sizeof(BinT));
  auto kernel = fused_spread_kernel<BinT, kSplits, SplitT>;
  // dm's level weights are static shared memory
  const size_t weights =
      kSplits == Splits::kPlanes ? sizeof(int32_t) * kMaxDepth : 0;
  const cudaError_t err =
      allow_shared_memory(kernel, lay.total + weights, lay.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(
      (n_rows + rows_per_block - 1) / rows_per_block));
  kernel<<<grid, threads, lay.total, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(borders),
      static_cast<const int32_t*>(sf), static_cast<const SplitT*>(sb),
      static_cast<const float*>(pow2), static_cast<const float*>(lv),
      static_cast<float*>(out), n_rows, n_feat, n_borders, n_trees, depth,
      n_out, rows_per_block, chunk, slab);
  return launch_status();
}

// The body of the spread launchers (fused_predict.cu, fused_predict_dm.cu,
// fused_predict_bp.cu): the block shape checked (`slab` <= 32 outputs,
// `threads` a multiple of 32 up to kSpreadMaxThreads, each thread at most
// kSpreadMaxAcc of the block's (row, output) sums), then the launch over
// uint8 bins when bins_u8, int32 otherwise.
template <Splits kSplits, typename SplitT = int32_t>
int spread_launcher(const void* x, const void* borders, const void* sf,
                    const void* sb, const void* pow2, const void* lv,
                    void* out, long long n_rows, int n_feat, int n_borders,
                    int n_trees, int depth, int n_out, int bins_u8,
                    int rows_per_block, int threads, int chunk, int slab,
                    int device, void* stream) {
  const cudaError_t err = select_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (slab < 1 || slab > 32 || chunk < 1 || rows_per_block < 1 ||
      threads < 32 || threads > kSpreadMaxThreads || threads % 32 != 0 ||
      rows_per_block * slab > kSpreadMaxAcc * threads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bins_u8) {
    return launch_spread<uint8_t, kSplits, SplitT>(
        rows_per_block, threads, chunk, slab, s, x, borders, sf, sb, pow2,
        lv, out, n_rows, n_feat, n_borders, n_trees, depth, n_out);
  }
  return launch_spread<int32_t, kSplits, SplitT>(
      rows_per_block, threads, chunk, slab, s, x, borders, sf, sb, pow2, lv,
      out, n_rows, n_feat, n_borders, n_trees, depth, n_out);
}

}  // namespace
