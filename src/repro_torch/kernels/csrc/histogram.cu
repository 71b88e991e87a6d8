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
// integer sum is then rounded once to f32.
//
// Shared memory.  A block owns a tile of `seg_tile` (leaf, bin) segments
// of one feature, with every stat, as int64 cells in shared memory.  One
// feature's level-d histogram at Covertype width (64 bins, 14 stats) is
// 7,168 * 2^d bytes of int64, 917 KB at d = 7.  That does not fit the
// 227 KB a block may opt in to, so the segment axis (leaf-major, so a
// tile is a run of whole or partial leaves) is cut into tiles.  Each block
// reads the leaf id and bin of every row of its row chunk and adds the
// rows whose segment falls in its tile.  The tiling is chosen in
// kernels/tuning.py (hist_plan): tiles of at most HIST_TILE_BYTES, so two
// blocks share an SM, and enough row chunks for ~4 blocks per SM.  Row
// chunks of one tile meet in a global int64 buffer through integer
// atomics, again independent of order.
//
// The launcher runs four steps on the caller's stream: the per-stat
// max |gh| (integer atomicMax on the float bits, which order non-negative
// floats), zeroing the int64 buffer, the accumulation, and the rounding
// of the int64 buffer to the f32 output.
//
// What bounds it on an H100: bytes.  At Covertype width (325,360 rows,
// 54 features, 14 stats) a level reads 17.6 MB of uint8 bins, 18.2 MB of
// gh and 1.3 MB of leaf ids and writes 0.19 MB (d = 0) to 24.8 MB
// (d = 7): 11 to 19 us at 3.35 TB/s.  This first kernel does more: every
// tile of a feature re-reads that feature's bins and the leaf ids (from
// L2), the int64 buffer is written, zeroed and read again, and the shared
// atomics of rows in the same bin collide.  It is right and simple first;
// its time on the card is in PERF.md.
#include "common.cuh"

namespace {

constexpr int kHistThreads = 512;   // threads of an accumulation block
constexpr int kMaxStats = 64;       // 2C for C <= 32 outputs
constexpr int kAuxThreads = 256;    // threads of the max and round kernels

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

// One block: feature blockIdx.z, segments [s0, s0 + seg_tile) of it, rows
// [r0, r0 + rows_per_chunk).
template <typename BinT>
__global__ void __launch_bounds__(kHistThreads)
hist_accumulate_kernel(const BinT* __restrict__ bins_t,
                       const int32_t* __restrict__ leaf,
                       const float* __restrict__ gh,
                       const unsigned* __restrict__ max_bits,
                       unsigned long long* __restrict__ acc,
                       long long n_rows, int n_bins, int n_segs, int n_stats,
                       int seg_tile, long long rows_per_chunk) {
  extern __shared__ unsigned long long cells[];   // (segs, n_stats)
  __shared__ double scale[kMaxStats];
  const int f = blockIdx.z;
  const int s0 = blockIdx.y * seg_tile;
  const int segs = min(seg_tile, n_segs - s0);
  const int n_cells = segs * n_stats;
  for (int i = threadIdx.x; i < n_cells; i += blockDim.x) cells[i] = 0ull;
  if (threadIdx.x < n_stats) {
    scale[threadIdx.x] =
        ldexp(1.0, stat_exponent(max_bits[threadIdx.x], n_rows));
  }
  __syncthreads();

  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_chunk;
  const long long r1 = min(n_rows, r0 + rows_per_chunk);
  const BinT* __restrict__ row_bins = bins_t + f * n_rows;
  for (long long n = r0 + threadIdx.x; n < r1; n += blockDim.x) {
    // bins are read as stored (one byte for a pool) and meet the leaf id
    // in an int32 register
    const int seg = leaf[n] * n_bins + static_cast<int>(row_bins[n]) - s0;
    if (static_cast<unsigned>(seg) < static_cast<unsigned>(segs)) {
      const float* __restrict__ g = gh + n * n_stats;
      unsigned long long* cell = cells + seg * n_stats;
      for (int s = 0; s < n_stats; ++s) {
        // exact: a power-of-two scale of a float fits a double
        const long long q =
            __double2ll_rn(static_cast<double>(__ldg(g + s)) * scale[s]);
        atomicAdd(cell + s, static_cast<unsigned long long>(q));
      }
    }
  }
  __syncthreads();

  // two's-complement adds: the signed sum modulo 2^64, exact below 2^62
  unsigned long long* out =
      acc + (static_cast<long long>(f) * n_segs + s0) * n_stats;
  for (int i = threadIdx.x; i < n_cells; i += blockDim.x) {
    const unsigned long long v = cells[i];
    if (v) atomicAdd(out + i, v);
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

}  // namespace

// bins_t (n_features, n_rows) uint8 (bins_u8) or int32; leaf (n_rows,)
// int32 in [0, n_leaves); gh (n_rows, n_stats) f32, finite, n_stats <= 64;
// max_bits (n_stats,) and acc (n_features * n_leaves * n_bins * n_stats,)
// int64 are scratch; out (n_features, n_leaves * n_bins, n_stats) f32.
// The tiling (seg_tile segments, row_chunks chunks) comes from
// kernels/tuning.py hist_plan; seg_tile * n_stats * 8 bytes of dynamic
// shared memory a block.
extern "C" int repro_histogram(const void* bins_t, const void* leaf,
                               const void* gh, void* max_bits, void* acc,
                               void* out, long long n_rows, int n_features,
                               int n_bins, int n_leaves, int n_stats,
                               int bins_u8, int seg_tile, int row_chunks,
                               int device, void* stream) {
  cudaError_t err = select_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_stats < 1 || n_stats > kMaxStats || seg_tile < 1 || row_chunks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_segs = n_leaves * n_bins;
  const long long n_cells = static_cast<long long>(n_features) * n_segs *
                            n_stats;
  unsigned* mb = static_cast<unsigned*>(max_bits);
  const float* g = static_cast<const float*>(gh);

  err = cudaMemsetAsync(mb, 0, sizeof(unsigned) * n_stats, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows_per_pass = kAuxThreads / n_stats;
  hist_absmax_kernel<<<grid_for(n_rows, rows_per_pass, 1024), kAuxThreads,
                       0, s>>>(g, mb, n_rows, n_stats);
  if (int st = launch_status()) return st;

  err = cudaMemsetAsync(acc, 0, sizeof(long long) * n_cells, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (n_segs + seg_tile - 1) / seg_tile;
  const long long rows_per_chunk = (n_rows + row_chunks - 1) / row_chunks;
  const dim3 grid(static_cast<unsigned>(row_chunks),
                  static_cast<unsigned>(n_tiles),
                  static_cast<unsigned>(n_features));
  const size_t smem = sizeof(unsigned long long) * seg_tile * n_stats;
  const int32_t* lp = static_cast<const int32_t*>(leaf);
  unsigned long long* ap = static_cast<unsigned long long*>(acc);
  if (bins_u8) {
    err = cudaFuncSetAttribute(hist_accumulate_kernel<uint8_t>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    hist_accumulate_kernel<uint8_t><<<grid, kHistThreads, smem, s>>>(
        static_cast<const uint8_t*>(bins_t), lp, g, mb, ap, n_rows, n_bins,
        n_segs, n_stats, seg_tile, rows_per_chunk);
  } else {
    err = cudaFuncSetAttribute(hist_accumulate_kernel<int32_t>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    hist_accumulate_kernel<int32_t><<<grid, kHistThreads, smem, s>>>(
        static_cast<const int32_t*>(bins_t), lp, g, mb, ap, n_rows, n_bins,
        n_segs, n_stats, seg_tile, rows_per_chunk);
  }
  if (int st = launch_status()) return st;

  hist_round_kernel<<<grid_for(n_cells, kAuxThreads, 4096), kAuxThreads, 0,
                      s>>>(static_cast<const long long*>(acc), mb,
                           static_cast<float*>(out), n_cells, n_rows,
                           n_stats);
  return launch_status();
}
