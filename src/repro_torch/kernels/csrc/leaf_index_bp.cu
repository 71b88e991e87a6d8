// Oblivious-tree leaf indexes over the bitpacked layout:
//   idx[n, t] = OR_d [bins[n, sf_bp[d, t]] >= sb_bp[d, t]] << d,
// with the splits held as (D, T) planes: int32 split features and uint8
// or int32 thresholds (uint8 where every threshold of the depth group fits
// a byte, int32 where the group holds PAD_SPLIT_BIN).
//
// Replaces the TPU kernel src/repro/kernels/leaf_index.py:leaf_index_bp
// (_leaf_index_bp_kernel, with _bp_compare_planes).  The TPU kernel is
// integer only: per level it compares a block of docs against the
// threshold plane, packs each 32 docs' compare bits into a uint32 lane
// word (the paper's vmsgeu mask register), unpacks the word again and ors
// bit d into the index.  Here a warp's 32 lanes are 32 rows, so that word
// is exactly __ballot_sync of the compare, and each lane takes its own bit
// back out of it: the same round trip, the identity on the result.
//
// The bins tile stays in its own type in shared memory (uint8 for a pool:
// 54 bytes a Covertype row); widening it is what the TPU kernel avoids,
// and it is the only widening that costs anything here.  A bin and its
// threshold meet in int32 registers, so the 2^30 sentinel of an int32
// plane never goes right.  One template takes uint8 or int32 bins against
// uint8 or int32 planes: four instantiations.
//
// Lanes as rows would make each (N, T) idx store hit 32 separate rows, so
// the block transposes through shared memory: each warp assembles a
// 32 x 32 block of idx (rows x trees) in a 33-word-stride tile, and the
// block then writes its rows out with lanes as trees.
//
// What bounds it on an H100: bytes, as for leaf_index.cu: the (N, T) int32
// output (558 MB at N = 139,440 and T = 1,000), 0.17 ms at 3.35 TB/s.  The
// first design gave a block 128 rows and 32 trees: each of the 32 tree
// tiles staged the rows again (a byte and an integer division at a time),
// every (tree, level) compare cost two shuffles to hand out the split on
// top of the ballot, and the blocks in flight together wrote 128-byte
// pieces of rows 4,000 bytes apart, a DRAM page a piece.  It took 6.8x the
// bound.  This one:
//   * a block owns 32 rows (a lane each) and walks the trees in rounds of
//     256, 8 warps a round, a 32-tree tile each, then writes each of its
//     rows' 256 indexes as one contiguous kilobyte.  The trees are split
//     into groups of rounds (grid.y) only where the row blocks alone would
//     not fill the SMs (a serving bucket);
//   * the rows are staged once a block, with 16-byte loads and one
//     division a load, at an odd-word row stride so the 32 rows a warp
//     reads at one feature sit in 32 banks;
//   * each round's (D, 256) planes are staged as (feature, threshold)
//     int32 pairs: a warp reads two trees' level-d splits in one 16-byte
//     broadcast load from shared memory, not two shuffles a tree, and
//     runs kAtOnce trees' ballots as independent chains;
//   * rows too wide for the opt-in limit are read where they lie, in
//     global memory (kStaged false), by the same loop.
#include "common.cuh"

namespace {

constexpr int kRows = 32;        // rows a block: one a lane
constexpr int kWarps = 8;        // a tree tile each a round
constexpr int kTreeTile = 32;    // trees a warp's transpose tile holds
constexpr int kRoundTrees = kWarps * kTreeTile;
constexpr int kTransposeWords = kRows * 33;
constexpr int kAtOnce = 4;       // trees a warp indexes together
constexpr unsigned kFull = 0xffffffffu;

// Shared memory: the 8 transpose tiles, the (depth, 256) split pairs,
// then (kStaged) the bins tile; every part a multiple of 16 bytes.
inline size_t bp_smem(int depth, int stride, int bin_bytes, bool staged) {
  return static_cast<size_t>(kWarps) * kTransposeWords * 4 +
         static_cast<size_t>(depth) * kRoundTrees * sizeof(int2) +
         (staged ? static_cast<size_t>(kRows) * stride * bin_bytes : 0);
}

template <typename BinT, typename PlaneT, bool kStaged>
__global__ void __launch_bounds__(kWarps * 32)
leaf_index_bp_kernel(const BinT* __restrict__ bins,
                     const int32_t* __restrict__ sf_bp,
                     const PlaneT* __restrict__ sb_bp,
                     int32_t* __restrict__ out, long long n_rows, int n_feat,
                     int n_trees, int depth, int stride,
                     int rounds_per_group) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int32_t* idx_s = reinterpret_cast<int32_t*>(smem_raw);
  int2* split_s = reinterpret_cast<int2*>(idx_s + kWarps * kTransposeWords);
  BinT* tile = reinterpret_cast<BinT*>(split_s + depth * kRoundTrees);
  const int tid = threadIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const int rows = static_cast<int>(
      min(static_cast<long long>(kRows), n_rows - row0));
  const BinT* src = bins + row0 * n_feat;

  if (kStaged) {
    // the block's rows, contiguous in `bins`: 16 bytes a load, each
    // element put at (r, f) of the strided tile, (r, f) carried along
    constexpr int kVec = 16 / sizeof(BinT);
    const int total = rows * n_feat;
    const int n_vec =
        reinterpret_cast<uintptr_t>(src) % 16 == 0 ? total / kVec : 0;
    for (int v = tid; v < n_vec; v += blockDim.x) {
      union {
        uint4 word;
        BinT val[kVec];
      } load;
      load.word = __ldg(reinterpret_cast<const uint4*>(src) + v);
      int r = v * kVec / n_feat;
      int f = v * kVec - r * n_feat;
#pragma unroll
      for (int u = 0; u < kVec; ++u) {
        tile[r * stride + f] = load.val[u];
        if (++f == n_feat) {
          f = 0;
          ++r;
        }
      }
    }
    for (int i = n_vec * kVec + tid; i < total; i += blockDim.x) {
      const int r = i / n_feat;
      tile[r * stride + (i - r * n_feat)] = src[i];
    }
  }

  const int lane = tid & 31;
  const int warp = tid >> 5;
  // a lane past the block's rows reads the first row; its bits are never
  // stored
  const int r_own = lane < rows ? lane : 0;
  const BinT* row = kStaged ? tile + r_own * stride
                            : src + static_cast<long long>(r_own) * n_feat;
  int32_t* my_idx = idx_s + warp * kTransposeWords;
  const int n_rounds = (n_trees + kRoundTrees - 1) / kRoundTrees;
  const int first = blockIdx.y * rounds_per_group;
  const int last = min(n_rounds, first + rounds_per_group);

  for (int round = first; round < last; ++round) {
    const int t0 = round * kRoundTrees;
    const int nt = min(kRoundTrees, n_trees - t0);
    __syncthreads();  // the rows are staged, the last round written out
    for (int i = tid; i < depth * kRoundTrees; i += blockDim.x) {
      const int d = i / kRoundTrees;
      const int j = i - d * kRoundTrees;
      const long long at = static_cast<long long>(d) * n_trees + t0 + j;
      // past the last tree: feature 0, computed and never stored
      split_s[i] = j < nt ? make_int2(__ldg(sf_bp + at),
                                      static_cast<int>(__ldg(sb_bp + at)))
                          : make_int2(0, 0);
    }
    __syncthreads();
    // kAtOnce trees at a time: their splits in 16-byte broadcast loads
    // (two trees a load), kAtOnce independent ballot chains
    const int j0 = warp * kTreeTile;
    const int tile_nt = min(kTreeTile, nt - j0);
    for (int j = 0; j < tile_nt; j += kAtOnce) {
      unsigned idx[kAtOnce];
#pragma unroll
      for (int u = 0; u < kAtOnce; ++u) idx[u] = 0u;
      for (int d = 0; d < depth; ++d) {
        const int4* pairs =
            reinterpret_cast<const int4*>(split_s + d * kRoundTrees + j0 + j);
#pragma unroll
        for (int h = 0; h < kAtOnce / 2; ++h) {
          const int4 two = pairs[h];
          // the 32 rows' compare bits as one word, then this row's bit
          const unsigned w0 = __ballot_sync(
              kFull, static_cast<int>(row[two.x]) >= two.y);
          const unsigned w1 = __ballot_sync(
              kFull, static_cast<int>(row[two.z]) >= two.w);
          idx[2 * h] |= ((w0 >> lane) & 1u) << d;
          idx[2 * h + 1] |= ((w1 >> lane) & 1u) << d;
        }
      }
#pragma unroll
      for (int u = 0; u < kAtOnce; ++u) {
        if (j + u < tile_nt) {
          my_idx[lane * 33 + j + u] = static_cast<int32_t>(idx[u]);
        }
      }
    }
    __syncthreads();
    // a row's nt indexes, contiguous: 128 bytes a store, lanes as trees
    for (int r = warp; r < rows; r += kWarps) {
      int32_t* dst = out + (row0 + r) * n_trees + t0;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) {
        const int j = k * kTreeTile + lane;
        if (j < nt) dst[j] = idx_s[k * kTransposeWords + r * 33 + lane];
      }
    }
  }
}

template <typename BinT, typename PlaneT>
int launch_planes(dim3 grid, cudaStream_t s, const BinT* bins,
                  const int32_t* sf, const PlaneT* sb, int32_t* out,
                  long long n_rows, int n_feat, int n_trees, int depth,
                  int stride, int from_global, int rounds_per_group) {
  const size_t smem = bp_smem(depth, stride, sizeof(BinT), !from_global);
  auto kernel = from_global ? leaf_index_bp_kernel<BinT, PlaneT, false>
                            : leaf_index_bp_kernel<BinT, PlaneT, true>;
  const cudaError_t err = allow_shared_memory(kernel, smem, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kWarps * 32, smem, s>>>(bins, sf, sb, out, n_rows, n_feat,
                                         n_trees, depth, stride,
                                         rounds_per_group);
  return launch_status();
}

template <typename BinT>
int launch(dim3 grid, cudaStream_t s, const BinT* bins, const int32_t* sf,
           const void* sb, int planes_u8, int32_t* out, long long n_rows,
           int n_feat, int n_trees, int depth, int stride, int from_global,
           int rounds_per_group) {
  if (planes_u8) {
    return launch_planes<BinT, uint8_t>(
        grid, s, bins, sf, static_cast<const uint8_t*>(sb), out, n_rows,
        n_feat, n_trees, depth, stride, from_global, rounds_per_group);
  }
  return launch_planes<BinT, int32_t>(
      grid, s, bins, sf, static_cast<const int32_t*>(sb), out, n_rows,
      n_feat, n_trees, depth, stride, from_global, rounds_per_group);
}

}  // namespace

// bins (n_rows, n_feat) uint8 when bins_u8 else int32; sf_bp (depth,
// n_trees) int32 with every sf in [0, n_feat) and depth <= kMaxDepth;
// sb_bp (depth, n_trees) uint8 when planes_u8 else int32; out (n_rows,
// n_trees) int32.  The plan is kernels/tuning.py bp_plan: 32 rows a
// block, staged in shared memory at `stride` bins a row unless
// from_global; tree_groups groups (grid.y) of rounds_per_group 256-tree
// rounds.
extern "C" int repro_leaf_index_bp(const void* bins, const void* sf_bp,
                                   const void* sb_bp, void* out,
                                   long long n_rows, int n_feat, int n_trees,
                                   int depth, int bins_u8, int planes_u8,
                                   int stride, int from_global,
                                   int tree_groups, int rounds_per_group,
                                   int device, void* stream) {
  cudaError_t err = select_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (depth > kMaxDepth || rounds_per_group < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((n_rows + kRows - 1) / kRows),
                  static_cast<unsigned>(tree_groups));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* sfp = static_cast<const int32_t*>(sf_bp);
  int32_t* op = static_cast<int32_t*>(out);
  if (bins_u8) {
    return launch<uint8_t>(grid, s, static_cast<const uint8_t*>(bins), sfp,
                           sb_bp, planes_u8, op, n_rows, n_feat, n_trees,
                           depth, stride, from_global, rounds_per_group);
  }
  return launch<int32_t>(grid, s, static_cast<const int32_t*>(bins), sfp,
                         sb_bp, planes_u8, op, n_rows, n_feat, n_trees, depth,
                         stride, from_global, rounds_per_group);
}
