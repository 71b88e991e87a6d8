// Gradient histogram of one tree level (the training hot loop):
//   hist[f, l*B + b, s] = sum_n gh[n, s] [leaf[n] == l] [bins_t[f, n] == b]
//
// Replaces the TPU kernel src/repro/kernels/histogram.py:histogram
// (_hist_kernel).  The TPU kernel turns the scatter into a one-hot over
// the (leaf, bin) axis contracted on the MXU, and carries the sum over
// sample blocks in its output tile from one serial grid step to the next.
// Neither carries over.  Hopper scatters directly into shared memory, and
// its blocks run in no order.
//
// Determinism.  A resumed training run must end with the ensemble an
// uninterrupted one gives, bit for bit, so the histogram must give the
// same bits on every launch.  Float atomics add in whatever order the
// threads arrive.  So every value is accumulated in 64-bit fixed point,
// XGBoost's GPU `hist` technique: each stat s gets a power-of-two scale
// 2^e[s], chosen from max_n |gh[n, s]| so that n_rows terms can never
// overflow 2^62, and gh[n, s] * 2^e[s] is rounded to an integer.  Integer
// adds are exact and associative, so the sum does not depend on the order
// of the atomics.  For every term within 2^-19 of the stat's largest
// magnitude the rounding is exact.  Each term is off by at most
// 2^-(e[s]+1), about 2^-44 of max_n |gh[n, s]| at 325,360 rows.  That
// bound is relative to the stat's largest magnitude over all rows, not to
// each term or cell: a small term is off by a larger share of itself.  A
// hessian at the 1e-12 floor of MultiClass and LogLoss, against a largest
// hessian near 0.25, is 18 to 35 quanta and may be off by up to 3% of
// itself (it stays above the half quantum that would round it to 0 below
// 2^24 rows).  The leaf values and split gains divide by H + l2, so they
// rely on l2 > 0 (3 by default) to make that error negligible.  The exact
// integer sum is then rounded once to f32.  `ref.histogram_fixed` is the
// same function in plain PyTorch, bit for bit.
//
// Shared memory.  A block owns a tile of `seg_tile` (leaf, bin) segments
// of `feats_per_block` features, with every stat, as int64 cells in
// shared memory, each cell two 32-bit words (sm_90 has no 64-bit shared
// atomic add; see add_fixed).  One feature's level-d histogram at
// Covertype width (64 bins, 14 stats) is 7,168 * 2^d bytes, 917 KB at
// d = 7, more than the 227 KB a block may opt in to, so the segment axis
// (leaf-major, so a tile is a run of whole or partial leaves) is cut into
// tiles.  The features of a block share one read of each row's leaf id
// and stats, but every tile of a feature reads the feature's bins and the
// leaf ids again.  The plan is kernels/tuning.py hist_plan: one block of
// 1,024 threads an SM with all the shared memory it may have, and the
// features a block, tiles and row chunks that fill the card's waves.  A
// block that scans every row (one chunk) owns its cells outright and
// rounds them straight into the f32 output.  Chunks of one tile meet in
// a global int64 buffer through integer atomics, again independent of
// order, and a last pass rounds it.
//
// The accumulation.  A thread that owns a row and loops over its S stats
// is the obvious design and a slow one: the 32 lanes of a warp whose rows
// share a (leaf, bin) segment hit one int64 cell together and serialise
// 32 ways on every stat, which is most warps where half a column sits in
// one bin (post-ReLU embeddings) or a feature has a handful of values.
// Here the stats lie across the lanes and the rows across the warps: lane
// s of a warp adds stat s (and s + 32 when S > 32) of one row, or of one
// of floor(32 / S) rows when S <= 16, so the S atomics of an instruction
// go to S distinct consecutive words and words collide only between
// warps.  A warp loads the leaf ids and bins of 32 consecutive rows in one
// coalesced load each, a batch ahead of their use, ranks the rows whose
// segment lies in its tile (a ballot, and a 32-byte table in shared
// memory from rank to lane), and walks them kLoadsAhead steps at a time.
// The stats are read as f32 and scaled in registers, one f64 multiply
// and conversion a term.  Quantizing them once a call into an (N, S)
// int64 array that the accumulation only adds was 3-8% slower on the card
// (twice the bytes from L2; PERF.md).
//
// What bounds it on an H100: bytes, in principle.  At Covertype width
// (325,360 rows, 54 features, 14 stats) a level reads 17.6 MB of uint8
// bins, 18.2 MB of gh and 1.3 MB of leaf ids and writes 0.19 MB (d = 0)
// to 24.8 MB (d = 7): 11 to 19 us at 3.35 TB/s.  The kernel is held back
// by latency and instructions instead: a step (a row or two of one
// feature group) waits on a shuffle, an f64 conversion and a returned
// shared atomic, and at deep levels every tile re-scans the rows.  Its
// times on the card are in PERF.md.
#include "common.cuh"

namespace {

constexpr int kHistThreads = 1024;     // threads of an accumulation block
constexpr int kMaxStats = 64;          // a launch's; tuning.stat_groups
constexpr int kMaxFeatsPerBlock = 8;   // tuning.HIST_MAX_FEATS_PER_BLOCK
constexpr int kAuxThreads = 256;       // threads of the other kernels
constexpr int kLoadsAhead = 4;         // steps whose stats load together
constexpr unsigned kFullMask = 0xffffffffu;

// Exponent e of the stat's fixed-point scale 2^e = 2^(62 - lg - ex):
// with |gh| <= m < 2^ex and n_rows < 2^lg, every partial sum of scaled
// terms stays below 2^lg * 2^ex * 2^e = 2^62.
__device__ inline int stat_exponent(unsigned max_bits, long long n_rows) {
  const float m = __uint_as_float(max_bits);
  if (!(m > 0.0f)) return 0;         // an all-zero stat: any scale is exact
  int ex;
  frexpf(m, &ex);                    // m = frac * 2^ex, frac in [0.5, 1)
  int lg = 0;
  while ((1ll << lg) <= n_rows) ++lg;
  return 62 - lg - ex;
}

// One term in fixed point: exact scaling (a power-of-two scale of a float
// fits a double), one rounding to nearest even.
__device__ inline long long to_fixed(float v, double scale) {
  return __double2ll_rn(static_cast<double>(v) * scale);
}

// max_n |gh[n, s]| per stat, as the bits of a non-negative float.  Thread
// t of a block reads stat t % n_stats of rows t / n_stats, t / n_stats +
// rows_per_pass, ...: the block's loads cover whole rows, contiguously.
__global__ void hist_absmax_kernel(const float* __restrict__ gh,
                                   unsigned* __restrict__ max_bits,
                                   long long n_rows, int n_stats) {
  __shared__ unsigned block_max[kMaxStats];
  const int rows_per_pass = blockDim.x / n_stats;
  const int s = threadIdx.x % n_stats;
  const int r = threadIdx.x / n_stats;
  if (threadIdx.x < n_stats) block_max[threadIdx.x] = 0u;
  __syncthreads();
  if (r < rows_per_pass) {
    unsigned mine = 0u;
    const long long stride =
        static_cast<long long>(gridDim.x) * rows_per_pass;
    for (long long n = static_cast<long long>(blockIdx.x) * rows_per_pass + r;
         n < n_rows; n += stride) {
      mine = max(mine, __float_as_uint(fabsf(gh[n * n_stats + s])));
    }
    atomicMax(&block_max[s], mine);
  }
  __syncthreads();
  if (threadIdx.x < n_stats) atomicMax(&max_bits[threadIdx.x],
                                       block_max[threadIdx.x]);
}

// Adds v to the int64 cell whose low word is lo[0] and high word hi[0],
// with two native 32-bit shared atomics: sm_90 has no 64-bit shared
// atomic add (it would spin on a 64-bit compare-and-swap).  The low word
// adds modulo 2^32 and its carry goes into the high word, so the pair
// holds the exact sum modulo 2^64 whatever the order of the adds.
__device__ inline void add_fixed(unsigned* lo, unsigned* hi, long long v) {
  const unsigned v_lo = static_cast<unsigned>(v);
  const unsigned v_hi = static_cast<unsigned>(v >> 32);
  const unsigned old = atomicAdd(lo, v_lo);
  atomicAdd(hi, v_hi + (old + v_lo < old ? 1u : 0u));
}

// One block: features [f0, f0 + feats_per_block) with f0 = blockIdx.z *
// feats_per_block, segments [s0, s0 + seg_tile) of each, rows [r0, r0 +
// rows_per_chunk).  With one row chunk (`direct`) the block rounds its cells into `out`;
// otherwise it adds them into `acc`.
template <typename BinT>
__global__ void __launch_bounds__(kHistThreads, 1)
hist_accumulate_kernel(const BinT* __restrict__ bins_t,
                       const int32_t* __restrict__ leaf,
                       const float* __restrict__ gh,
                       const unsigned* __restrict__ max_bits,
                       unsigned long long* __restrict__ acc,
                       float* __restrict__ out, long long n_rows,
                       int n_features, int n_bins, int n_segs, int n_stats,
                       int seg_tile, int feats_per_block,
                       long long rows_per_chunk, int direct) {
  // per feature: the low words of its (segs, n_stats) cells, then the
  // high words (two planes, so the lanes of a row hit consecutive words)
  extern __shared__ unsigned words[];
  __shared__ double scale[kMaxStats];
  __shared__ double inv_scale[kMaxStats];
  // each warp's rows of the tile, in order: order[w][t] = the lane of
  // the t-th row of warp w's batch that falls in the tile
  __shared__ uint8_t order[kHistThreads / 32][32];
  const int f0 = blockIdx.z * feats_per_block;
  const int nf = min(feats_per_block, n_features - f0);
  const int s0 = blockIdx.y * seg_tile;
  const int segs = min(seg_tile, n_segs - s0);
  const int tile_cells = segs * n_stats;
  for (int i = threadIdx.x; i < 2 * nf * tile_cells; i += blockDim.x) {
    words[i] = 0u;
  }
  if (threadIdx.x < n_stats) {
    const int e = stat_exponent(max_bits[threadIdx.x], n_rows);
    scale[threadIdx.x] = ldexp(1.0, e);
    inv_scale[threadIdx.x] = ldexp(1.0, -e);
  }
  __syncthreads();

  // lane = (row slot g, stat s): floor(32 / S) rows an instruction when
  // S <= 16, one row otherwise; a lane takes stat s + 32 too when S > 32
  const int lane = threadIdx.x & 31;
  const int lanes_per_row = min(n_stats, 32);
  const int rows_per_step = 32 / lanes_per_row;
  const int g = lane / lanes_per_row;
  const int s = lane % lanes_per_row;
  const bool second = s + 32 < n_stats;
  const double sc0 = scale[s];
  const double sc1 = second ? scale[s + 32] : 0.0;

  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_chunk;
  const long long r1 = min(n_rows, r0 + rows_per_chunk);
  const long long warp_stride = (blockDim.x >> 5) * 32ll;
  uint8_t* my_order = order[threadIdx.x >> 5];
  // the warp's 32 rows: one coalesced load of leaf ids and of each
  // feature's bins, issued a batch ahead of their use
  int next_leaf = 0;
  BinT next_bin[kMaxFeatsPerBlock];
  auto fetch = [&](long long n) {
    next_leaf = n < r1 ? leaf[n] : 0;
#pragma unroll
    for (int k = 0; k < kMaxFeatsPerBlock; ++k) {
      // bins are read as stored (one byte for a pool)
      next_bin[k] = k < nf && n < r1 ? bins_t[(f0 + k) * n_rows + n]
                                     : BinT(0);
    }
  };
  long long base = r0 + (threadIdx.x >> 5) * 32ll;
  fetch(base + lane);
  for (; base < r1; base += warp_stride) {
    // bit k of `in_tile` marks a row of the tile in feature k
    const bool row_ok = base + lane < r1;
    const int leaf_base = next_leaf * n_bins - s0;
    int seg[kMaxFeatsPerBlock];
    unsigned in_tile = 0u;
#pragma unroll
    for (int k = 0; k < kMaxFeatsPerBlock; ++k) {
      seg[k] = leaf_base + static_cast<int>(next_bin[k]);
      if (k < nf && row_ok &&
          static_cast<unsigned>(seg[k]) < static_cast<unsigned>(segs)) {
        in_tile |= 1u << k;
      }
    }
    fetch(base + warp_stride + lane);
    const unsigned rows = __ballot_sync(kFullMask, in_tile != 0u);
    const int count = __popc(rows);
    if (in_tile) my_order[__popc(rows & ((1u << lane) - 1u))] = lane;
    __syncwarp();
    // kLoadsAhead steps at a time: their stats loads are all issued
    // before the first add, so a warp waits one L2 latency, not one a
    // step.  Step i takes the rows of ranks i * rows_per_step + g.
    for (int j = 0; j < count; j += rows_per_step * kLoadsAhead) {
      int src[kLoadsAhead];
      float a[kLoadsAhead], b[kLoadsAhead];
#pragma unroll
      for (int u = 0; u < kLoadsAhead; ++u) {
        const int t = j + u * rows_per_step + g;
        src[u] = g < rows_per_step && t < count ? my_order[t] : -1;
        a[u] = b[u] = 0.0f;
        if (src[u] >= 0) {
          const float* __restrict__ row_stats =
              gh + (base + src[u]) * n_stats;
          a[u] = row_stats[s];
          if (second) b[u] = row_stats[s + 32];
        }
      }
#pragma unroll
      for (int u = 0; u < kLoadsAhead; ++u) {
        if (j + u * rows_per_step >= count) break;     // warp-uniform
        const bool mine = src[u] >= 0;
        const int from = mine ? src[u] : 0;
        const unsigned row_in = __shfl_sync(kFullMask, in_tile, from);
        const long long v0 = to_fixed(a[u], sc0);
        const long long v1 = second ? to_fixed(b[u], sc1) : 0;
#pragma unroll
        for (int k = 0; k < kMaxFeatsPerBlock; ++k) {
          if (k < nf) {
            const int sk = __shfl_sync(kFullMask, seg[k], from);
            if (mine && ((row_in >> k) & 1u)) {
              unsigned* lo = words + 2 * k * tile_cells + sk * n_stats + s;
              add_fixed(lo, lo + tile_cells, v0);
              if (second) add_fixed(lo + 32, lo + tile_cells + 32, v1);
            }
          }
        }
      }
    }
    __syncwarp();                        // my_order is rewritten next batch
  }
  __syncthreads();

  for (int k = 0; k < nf; ++k) {
    const long long at =
        (static_cast<long long>(f0 + k) * n_segs + s0) * n_stats;
    const unsigned* lo = words + 2 * k * tile_cells;
    for (int i = threadIdx.x; i < tile_cells; i += blockDim.x) {
      // two's complement: the signed sum, exact below 2^62
      const unsigned long long v =
          (static_cast<unsigned long long>(lo[tile_cells + i]) << 32) | lo[i];
      if (direct) {
        out[at + i] = __double2float_rn(
            __ll2double_rn(static_cast<long long>(v)) *
            inv_scale[i % n_stats]);
      } else if (v) {
        atomicAdd(acc + at + i, v);
      }
    }
  }
}

__global__ void hist_round_kernel(const long long* __restrict__ acc,
                                  const unsigned* __restrict__ max_bits,
                                  float* __restrict__ out, long long n_cells,
                                  long long n_rows, int n_stats) {
  __shared__ double inv_scale[kMaxStats];
  if (threadIdx.x < n_stats) {
    inv_scale[threadIdx.x] =
        ldexp(1.0, -stat_exponent(max_bits[threadIdx.x], n_rows));
  }
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n_cells; i += stride) {
    out[i] = __double2float_rn(__ll2double_rn(acc[i]) *
                               inv_scale[i % n_stats]);
  }
}

inline unsigned grid_for(long long work, int threads, int cap) {
  const long long blocks = (work + threads - 1) / threads;
  return static_cast<unsigned>(blocks < 1 ? 1 : blocks > cap ? cap : blocks);
}

template <typename BinT>
int launch_accumulate(const void* bins_t, const int32_t* leaf,
                      const float* gh, const unsigned* max_bits,
                      unsigned long long* acc, float* out, long long n_rows,
                      int n_features, int n_bins, int n_segs, int n_stats,
                      int seg_tile, int feats_per_block, int row_chunks,
                      cudaStream_t s) {
  const int n_tiles = (n_segs + seg_tile - 1) / seg_tile;
  const int n_groups = (n_features + feats_per_block - 1) / feats_per_block;
  const long long rows_per_chunk = (n_rows + row_chunks - 1) / row_chunks;
  const dim3 grid(static_cast<unsigned>(row_chunks),
                  static_cast<unsigned>(n_tiles),
                  static_cast<unsigned>(n_groups));
  const size_t smem = sizeof(unsigned long long) * feats_per_block *
                      seg_tile * n_stats;
  note_launch(hist_accumulate_kernel<BinT>, smem);
  cudaError_t err = cudaFuncSetAttribute(
      hist_accumulate_kernel<BinT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  hist_accumulate_kernel<BinT><<<grid, kHistThreads, smem, s>>>(
      static_cast<const BinT*>(bins_t), leaf, gh, max_bits, acc, out,
      n_rows, n_features, n_bins, n_segs, n_stats, seg_tile, feats_per_block,
      rows_per_chunk, row_chunks == 1 ? 1 : 0);
  return launch_status();
}

}  // namespace

// bins_t (n_features, n_rows) uint8 (bins_u8) or int32; leaf (n_rows,)
// int32 in [0, n_leaves); gh (n_rows, n_stats) f32, finite, n_stats <= 64
// (kernels/histogram.py launches once a group of at most 64 stats);
// out (n_features, n_leaves * n_bins, n_stats) f32.  Scratch: max_bits
// (n_stats,) int32; acc (n_features * n_leaves * n_bins * n_stats,) int64 when
// row_chunks > 1, else unused.  The tiling (seg_tile segments,
// feats_per_block features, row_chunks chunks) comes from
// kernels/tuning.py hist_plan; feats_per_block * seg_tile * n_stats * 8
// bytes of dynamic shared memory a block.
extern "C" int repro_histogram(const void* bins_t, const void* leaf,
                               const void* gh, void* max_bits, void* acc, void* out, long long n_rows,
                               int n_features, int n_bins, int n_leaves,
                               int n_stats, int bins_u8, int seg_tile,
                               int feats_per_block, int row_chunks,
                               int device, void* stream) {
  cudaError_t err = select_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_stats < 1 || n_stats > kMaxStats || seg_tile < 1 || row_chunks < 1 ||
      feats_per_block < 1 || feats_per_block > kMaxFeatsPerBlock)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_segs = n_leaves * n_bins;
  const long long n_cells = static_cast<long long>(n_features) * n_segs *
                            n_stats;
  unsigned* mb = static_cast<unsigned*>(max_bits);
  const float* g = static_cast<const float*>(gh);
  const int32_t* lp = static_cast<const int32_t*>(leaf);
  unsigned long long* ap = static_cast<unsigned long long*>(acc);
  float* op = static_cast<float*>(out);

  err = cudaMemsetAsync(mb, 0, sizeof(unsigned) * n_stats, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows_per_pass = kAuxThreads / n_stats;
  note_launch(hist_absmax_kernel, 0);
  hist_absmax_kernel<<<grid_for(n_rows, rows_per_pass, 1024), kAuxThreads,
                       0, s>>>(g, mb, n_rows, n_stats);
  if (int st = launch_status()) return st;
  if (row_chunks > 1) {
    err = cudaMemsetAsync(acc, 0, sizeof(long long) * n_cells, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }

  const int st =
      bins_u8 ? launch_accumulate<uint8_t>(bins_t, lp, g, mb, ap, op, n_rows,
                                           n_features, n_bins, n_segs,
                                           n_stats, seg_tile,
                                           feats_per_block, row_chunks, s)
              : launch_accumulate<int32_t>(bins_t, lp, g, mb, ap, op, n_rows,
                                           n_features, n_bins, n_segs,
                                           n_stats, seg_tile,
                                           feats_per_block, row_chunks, s);
  if (st || row_chunks == 1) return st;

  note_launch(hist_round_kernel, 0);
  hist_round_kernel<<<grid_for(n_cells, kAuxThreads, 4096), kAuxThreads, 0,
                      s>>>(static_cast<const long long*>(acc), mb, op,
                           n_cells, n_rows, n_stats);
  return launch_status();
}
