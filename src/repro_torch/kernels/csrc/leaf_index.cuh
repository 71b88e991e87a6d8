// Oblivious-tree leaf indexes, shared by leaf_index.cu (soa: (T, D)
// splits) and leaf_index_dm.cu (depth_major: (D, T) planes):
//   idx[n, t] = sum_d w[d] * [bins[n, sf(t, d)] >= sb(t, d)],
// with the split of tree t at level d at t * tree_stride + d * level_stride
// and the level weights w[d] = 2^d (pow2, truncated to int, where the
// layout holds one).
//
// The compare is the int32 one: padded trees and truncated levels carry
// split bin 2^30 (PAD_SPLIT_BIN), which no bin reaches, so those levels
// always go left.
//
// What bounds it on an H100: bytes.  The (N, T) int32 output is 4 bytes a
// (row, tree) against 1 byte of uint8 bins a (row, feature): 558 MB at
// N = 139,440 and T = 1,000, 0.17 ms at 3.35 TB/s.  Next come the compares
// (N * T * D, 1.1e9 there): at one shared load and three integer
// instructions each they would take longer than the write.  The first
// design (128 rows x 32 trees a block) staged each block's rows once per
// 32-tree tile, a byte a thread, wrote 128-byte pieces of rows 4,000 bytes
// apart from blocks in flight together, ran one row's chain at a time and
// left the card idle at a serving bucket: 5.4x the bound.  This one:
//   * a block owns `rows` rows (tuning.index_plan: 8 to 64), stages
//     them once with 16-byte loads into a transposed (F + 1, rows + 4)
//     tile, and walks the trees in rounds of 256, one tree a lane: each
//     warp's store is 128 contiguous bytes of an idx row, and a round
//     writes each of its rows' 256 indexes as one contiguous kilobyte;
//   * each round's splits are staged as (feature offset, threshold) int2
//     pairs, from (T, D) rows or (D, T) planes alike: the only place the
//     two launchers differ, with dm's level weights.  The first round's
//     split loads and dm's weights go out before the rows', so a small
//     launch waits for one trip to memory, not two;
//   * a shared word holds 4 rows' bins of one feature, so one load serves 4
//     rows.  uint8 bins are compared 4 at a time inside the word (SWAR: the
//     low 7 bits subtracted under a guard bit, the top bits folded in by
//     one 3-input logic op) and each level's 4 compare bits are shifted
//     into 4 byte-wide indexes: 5 integer instructions for 4 compares.
//     A threshold above 255 (PAD_SPLIT_BIN among them) reads the tile's
//     zero row against threshold 1, so it never goes right; one at or
//     below 0 always does.  int32 bins are staged as bytes when all of a
//     block's lie in [0, 255] (bins of a table of at most 255 borders: the
//     staged route's and the depth groups'), else as int32 and compared in
//     int32, 4 rows an int4 load;
//   * a warp walks G such words (8 uint8 words, 32 rows; 4 int32 words; or
//     the block's rows where it has fewer) as independent chains, levels
//     0-7 unrolled, and the 8 warps split a round's (tree tile, pass)
//     items between them;
//   * 64 registers a thread (4 blocks an SM): more registers and fewer
//     warps cost more than the few spilled words save
//     (scripts/leaf_index_probe.py, `no_cap` and `six_blocks`);
//   * the trees are split into groups of rounds (grid.y) only where the
//     row blocks alone would not fill the SMs (a serving bucket, a depth
//     group of a few trees);
//   * rows too wide for the opt-in limit are read where they lie, in
//     global memory (kStaged false), by the same walk.
// The tile's pitch is rows + 4 elements: an odd number of words (uint8)
// or of 16-byte chunks (int32), so the lanes' distinct features fall in
// distinct banks unless they are 32 features apart.
#pragma once

#include "common.cuh"

namespace {

constexpr int kIndexWarps = 8;
constexpr int kRoundTrees = kIndexWarps * 32;  // a round: one tree a thread
constexpr int kGroupRows = 4;                  // rows a compare word holds
constexpr int kPassGroups = 8;                 // words a warp walks at once
constexpr int kPitchPad = 4;                   // pitch = rows + kPitchPad
// Blocks an SM at least: 64 registers a thread at most, so the store
// stream has warps enough in flight.
constexpr int kMinBlocks = 4;

// The round's split pairs, then (staged) the tile: room for int32 bins
// when the bins are int32, though a block whose bins all fit a byte
// stages them as uint8 in the same space.
inline size_t index_smem(int depth, int rows, int n_feat, int bin_bytes,
                         bool staged) {
  return static_cast<size_t>(depth) * kRoundTrees * sizeof(int2) +
         (staged ? static_cast<size_t>(n_feat + 1) * (rows + kPitchPad) *
                       bin_bytes
                 : 0);
}

// The walk over uint8 words: a word is 4 rows' bins of one feature, and
// the compare runs on its 4 bytes at once.
struct WalkBytes {
  using T = uint8_t;
  static constexpr int kMaxGroups = kPassGroups;

  // (offset of the feature's bins, threshold in every byte); `zero` is the
  // offset of the zero row (bins 0): a threshold past 255 reads it against
  // 1 and never goes right, one at or below 0 always does
  __device__ static int2 encode(int f, int s, int fstep, int zero) {
    if (s > 255) return make_int2(zero, 0x01010101);
    return make_int2(f * fstep, max(s, 0) * 0x01010101);
  }

  template <bool kStaged>
  __device__ static uint32_t fetch(const uint8_t* base, int at, int r,
                                   int rows, int n_feat) {
    if (kStaged) return *reinterpret_cast<const uint32_t*>(base + at + r);
    uint32_t word = 0u;
#pragma unroll
    for (int k = 0; k < kGroupRows; ++k) {
      if (at < n_feat && r + k < rows) {
        word |= static_cast<uint32_t>(
                    __ldg(base + static_cast<long long>(r + k) * n_feat + at))
                << (8 * k);
      }
    }
    return word;
  }

  // one level's compare bits, put at bit `bit` of each row's byte
  template <bool kStaged, int G>
  __device__ static void level(uint32_t (&acc)[G], const uint8_t* base,
                               int2 pair, int bit, int r0, int rows,
                               int n_feat) {
    const uint32_t b = static_cast<uint32_t>(pair.y);
    const uint32_t low = b & 0x7f7f7f7fu;
    const uint32_t mask = 0x01010101u << bit;
    uint32_t a[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      a[g] = fetch<kStaged>(base, pair.x, r0 + g * kGroupRows, rows, n_feat);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      // bit 7 of each byte of t: low 7 bits of a >= those of b
      const uint32_t t = (a[g] | 0x80808080u) - low;
      // bit 7 of each byte: a >= b (one 3-input op: the majority of a's
      // top bit, b's top bit inverted and t's)
      const uint32_t ge = (a[g] & ~b) | (~(a[g] ^ b) & t);
      acc[g] |= (ge >> (7 - bit)) & mask;
    }
  }

  // levels 0-7 in a byte a row of lo, 8-15 in one of hi
  template <int G>
  struct Acc {
    uint32_t lo[G], hi[G];
  };

  template <int G>
  __device__ static uint32_t bits(const Acc<G>& acc, int g, int k) {
    // byte k of lo and of hi
    return __byte_perm(acc.lo[g], acc.hi[g], k | (k + 4) << 4) & 0xffffu;
  }

  template <bool kStaged, int G>
  __device__ static void pass(const uint8_t* base, const int2* pairs, int j,
                              int r0, int rows, int n_feat, int depth,
                              Acc<G>& acc) {
    uint32_t (&lo)[G] = acc.lo;
    uint32_t (&hi)[G] = acc.hi;
#pragma unroll
    for (int g = 0; g < G; ++g) lo[g] = hi[g] = 0u;
    // levels 0-7 unrolled, so the loads of one level go out under the
    // compares of the last; deeper ones (rare) in a loop
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      if (d < depth) {
        level<kStaged, G>(lo, base, pairs[d * kRoundTrees + j], d, r0, rows,
                          n_feat);
      }
    }
    for (int d = 8; d < depth; ++d) {
      level<kStaged, G>(hi, base, pairs[d * kRoundTrees + j], d - 8, r0,
                        rows, n_feat);
    }
  }
};

// The walk over int32 words: 4 rows' bins of one feature as an int4, each
// compared in int32.
struct WalkInts {
  using T = int32_t;
  static constexpr int kMaxGroups = 4;  // 4 registers a word

  __device__ static int2 encode(int f, int s, int fstep, int) {
    return make_int2(f * fstep, s);
  }

  template <bool kStaged>
  __device__ static int4 fetch(const int32_t* base, int at, int r, int rows,
                               int n_feat) {
    if (kStaged) return *reinterpret_cast<const int4*>(base + at + r);
    int v[kGroupRows];
#pragma unroll
    for (int k = 0; k < kGroupRows; ++k) {
      v[k] = r + k < rows
                 ? __ldg(base + static_cast<long long>(r + k) * n_feat + at)
                 : 0;
    }
    return make_int4(v[0], v[1], v[2], v[3]);
  }

  template <int G>
  struct Acc {
    uint32_t v[G][kGroupRows];
  };

  template <int G>
  __device__ static uint32_t bits(const Acc<G>& acc, int g, int k) {
    return acc.v[g][k];
  }

  template <bool kStaged, int G>
  __device__ static void pass(const int32_t* base, const int2* pairs, int j,
                              int r0, int rows, int n_feat, int depth,
                              Acc<G>& acc) {
    uint32_t (&idx)[G][kGroupRows] = acc.v;
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int k = 0; k < kGroupRows; ++k) idx[g][k] = 0u;
    }
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      if (d < depth) {
        level<kStaged, G>(idx, base, pairs[d * kRoundTrees + j], d, r0, rows,
                          n_feat);
      }
    }
    for (int d = 8; d < depth; ++d) {
      level<kStaged, G>(idx, base, pairs[d * kRoundTrees + j], d, r0, rows,
                        n_feat);
    }
  }

  template <bool kStaged, int G>
  __device__ static void level(uint32_t (&idx)[G][kGroupRows],
                               const int32_t* base, int2 pair, int d, int r0,
                               int rows, int n_feat) {
    const uint32_t w = 1u << d;
    int4 a[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      a[g] = fetch<kStaged>(base, pair.x, r0 + g * kGroupRows, rows, n_feat);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      idx[g][0] |= a[g].x >= pair.y ? w : 0u;
      idx[g][1] |= a[g].y >= pair.y ? w : 0u;
      idx[g][2] |= a[g].z >= pair.y ? w : 0u;
      idx[g][3] |= a[g].w >= pair.y ? w : 0u;
    }
  }
};

// The block's rows, contiguous in `src`, into the transposed tile: 16
// bytes a load, each element put at (f, r), (r, f) carried along; then
// the zero row.  int32 bins staged into a uint8 tile are narrowed, and the
// return value says whether one of this thread's lay outside [0, 255].
template <typename SrcT, typename TileT>
__device__ bool stage_rows(TileT* tile, const SrcT* src, int rows,
                           int n_feat, int pitch) {
  constexpr int kVec = 16 / sizeof(SrcT);
  constexpr bool kNarrow = sizeof(TileT) < sizeof(SrcT);
  bool outside = false;
  const int total = rows * n_feat;
  const int n_vec =
      reinterpret_cast<uintptr_t>(src) % 16 == 0 ? total / kVec : 0;
  for (int v = threadIdx.x; v < n_vec; v += blockDim.x) {
    union {
      uint4 word;
      SrcT val[kVec];
    } load;
    load.word = __ldg(reinterpret_cast<const uint4*>(src) + v);
    int r = v * kVec / n_feat;
    int f = v * kVec - r * n_feat;
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      if (kNarrow) outside |= static_cast<uint32_t>(load.val[u]) > 255u;
      tile[f * pitch + r] = static_cast<TileT>(load.val[u]);
      if (++f == n_feat) {
        f = 0;
        ++r;
      }
    }
  }
  for (int i = n_vec * kVec + threadIdx.x; i < total; i += blockDim.x) {
    const int r = i / n_feat;
    if (kNarrow) outside |= static_cast<uint32_t>(src[i]) > 255u;
    tile[(i - r * n_feat) * pitch + r] = static_cast<TileT>(src[i]);
  }
  for (int i = threadIdx.x; i < pitch; i += blockDim.x) {
    tile[n_feat * pitch + i] = 0;
  }
  return outside;
}

// Tree t's splits at levels [first, last), every load issued before any
// is used.
template <int kFirst, int kLast>
__device__ void load_splits(int (&f)[kMaxDepth], int (&s)[kMaxDepth],
                            const int32_t* sf, const int32_t* sb, int t,
                            int n_trees, int depth, int tree_stride,
                            int level_stride) {
#pragma unroll
  for (int d = kFirst; d < kLast; ++d) {
    const long long at = static_cast<long long>(t) * tree_stride +
                         static_cast<long long>(d) * level_stride;
    // past the last tree: feature 0, computed and never stored
    f[d] = d < depth && t < n_trees ? __ldg(sf + at) : 0;
    s[d] = d < depth && t < n_trees ? __ldg(sb + at) : 0;
  }
}

// A round's (32-tree tile, pass of G words) items, spread over the warps.
template <typename W, bool kStaged, int G>
__device__ void walk_round(const typename W::T* base, const int2* pairs,
                           int32_t* out, long long row0, int rows,
                           int n_feat, int n_trees, int t0, int nt,
                           int depth) {
  constexpr int kRows = G * kGroupRows;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_tiles = (nt + 31) / 32;
  const int n_passes = (rows + kRows - 1) / kRows;
  for (int item = warp; item < n_tiles * n_passes; item += kIndexWarps) {
    const int j = (item % n_tiles) * 32 + lane;  // the lane's tree
    const int r0 = (item / n_tiles) * kRows;
    typename W::template Acc<G> acc;
    W::template pass<kStaged, G>(base, pairs, j, r0, rows, n_feat, depth,
                                 acc);
    if (j >= nt) continue;
    int32_t* dst = out + (row0 + r0) * n_trees + t0 + j;
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int k = 0; k < kGroupRows; ++k) {
        if (r0 + g * kGroupRows + k < rows) {
          dst[static_cast<long long>(g * kGroupRows + k) * n_trees] =
              static_cast<int32_t>(W::bits(acc, g, k));
        }
      }
    }
  }
}

// G words a pass: the walk's most (8 uint8 words, 32 rows; 4 int32
// words), or the block's rows where it has fewer.
template <typename W, bool kStaged>
__device__ void walk(int rows_per_block, const typename W::T* base,
                     const int2* pairs, int32_t* out, long long row0,
                     int rows, int n_feat, int n_trees, int t0, int nt,
                     int depth) {
  if (rows_per_block >= W::kMaxGroups * kGroupRows) {
    walk_round<W, kStaged, W::kMaxGroups>(base, pairs, out, row0, rows,
                                          n_feat, n_trees, t0, nt, depth);
  } else if (rows_per_block == 4 * kGroupRows) {
    walk_round<W, kStaged, 4>(base, pairs, out, row0, rows, n_feat, n_trees,
                              t0, nt, depth);
  } else {
    walk_round<W, kStaged, 2>(base, pairs, out, row0, rows, n_feat, n_trees,
                              t0, nt, depth);
  }
}

// kWeights: the dm launcher's, which reads the layout's level weights.
template <typename BinT, bool kStaged, bool kWeights>
__global__ void __launch_bounds__(kIndexWarps * 32, kMinBlocks)
leaf_index_kernel(const BinT* __restrict__ bins,
                  const int32_t* __restrict__ sf,
                  const int32_t* __restrict__ sb,
                  const float* __restrict__ pow2,
                  int32_t* __restrict__ out, long long n_rows, int n_feat,
                  int n_trees, int depth, int rows_per_block,
                  int rounds_per_group, int tree_stride, int level_stride) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int2* pairs = reinterpret_cast<int2*>(smem_raw);
  unsigned char* tile = reinterpret_cast<unsigned char*>(
      pairs + depth * kRoundTrees);
  const int tid = threadIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const int rows = static_cast<int>(
      min(static_cast<long long>(rows_per_block), n_rows - row0));
  const BinT* src = bins + row0 * n_feat;
  // staged, bin (r, f) is at f * pitch + r; in global memory at
  // r * n_feat + f
  const int pitch = rows_per_block + kPitchPad;
  const int fstep = kStaged ? pitch : 1;
  const int zero = n_feat * fstep;
  const int n_rounds = (n_trees + kRoundTrees - 1) / kRoundTrees;
  const int first = blockIdx.y * rounds_per_group;
  const int last = min(n_rounds, first + rounds_per_group);

  // thread tid stages tree t0 + tid's split pairs of each round; the first
  // round's first 8 levels go out before the rows, so the two wait
  // together (deeper levels, rare, after them: fewer registers held)
  int f[kMaxDepth], s[kMaxDepth];
  load_splits<0, 8>(f, s, sf, sb, first * kRoundTrees + tid, n_trees, depth,
                    tree_stride, level_stride);
  // dm's level weights, read now and checked once the rows are staged
  float weight[kMaxDepth];
#pragma unroll
  for (int d = 0; d < kMaxDepth; ++d) {
    weight[d] = kWeights && d < depth ? __ldg(pow2 + d) : 0.f;
  }
  // the walk reads uint8 words for uint8 bins, and for int32 bins when
  // every one of the block's lies in [0, 255]
  bool bytes = sizeof(BinT) == 1;
  if (kStaged) {
    if (sizeof(BinT) == 1) {
      stage_rows(tile, src, rows, n_feat, pitch);
    } else {
      bytes = !__syncthreads_or(stage_rows(tile, src, rows, n_feat, pitch));
      if (!bytes) {
        stage_rows(reinterpret_cast<int32_t*>(tile), src, rows, n_feat,
                   pitch);
      }
    }
  }
  const unsigned char* base = kStaged
      ? tile : reinterpret_cast<const unsigned char*>(src);
  // whether the weights are 2^d (always, as lowered); checked before the
  // rows, the loads would cost a small launch a trip to memory of their
  // own (scripts/leaf_index_probe.py, `weights_first`; `weights_at_barrier`
  // checks them at the first round's barrier)
  bool plain = true;
  if (kWeights) {
#pragma unroll
    for (int d = 0; d < kMaxDepth; ++d) {
      if (d < depth) plain &= __float2int_rz(weight[d]) == (1 << d);
    }
  }
  if (depth > 8) {
    load_splits<8, kMaxDepth>(f, s, sf, sb, first * kRoundTrees + tid,
                              n_trees, depth, tree_stride, level_stride);
  }

  for (int round = first; round < last; ++round) {
    const int t0 = round * kRoundTrees;
    const int nt = min(kRoundTrees, n_trees - t0);
    if (round != first) {
      __syncthreads();  // the last round's pairs are read
      load_splits<0, kMaxDepth>(f, s, sf, sb, t0 + tid, n_trees, depth,
                                tree_stride, level_stride);
    }
#pragma unroll
    for (int d = 0; d < kMaxDepth; ++d) {
      if (d < depth) {
        pairs[d * kRoundTrees + tid] =
            bytes ? WalkBytes::encode(f[d], s[d], fstep, zero)
                  : WalkInts::encode(f[d], s[d], fstep, zero);
      }
    }
    __syncthreads();  // the rows are staged and the round's pairs too
    if (sizeof(BinT) == 1 || (kStaged && bytes)) {
      walk<WalkBytes, kStaged>(rows_per_block, base, pairs, out, row0, rows,
                               n_feat, n_trees, t0, nt, depth);
    } else if constexpr (sizeof(BinT) == 4) {
      walk<WalkInts, kStaged>(rows_per_block,
                              reinterpret_cast<const int32_t*>(base), pairs,
                              out, row0, rows, n_feat, n_trees, t0, nt,
                              depth);
    }
    if (kWeights && !plain) {
      // sum_d w[d] * bit d over the round's stores, for weights other
      // than 2^d: a pass of its own, so the walk is the same code for
      // both launchers
      __syncthreads();  // the round's bits are in `out`
      for (int i = tid; i < rows * nt; i += blockDim.x) {
        int32_t* at = out + (row0 + i / nt) * n_trees + t0 + i % nt;
        const uint32_t level_bits = static_cast<uint32_t>(*at);
        uint32_t v = 0u;
        for (int d = 0; d < depth; ++d) {
          if ((level_bits >> d) & 1u) {
            v += static_cast<uint32_t>(__float2int_rz(__ldg(pow2 + d)));
          }
        }
        *at = static_cast<int32_t>(v);
      }
    }
  }
}

template <typename BinT, bool kWeights>
int launch_typed(dim3 grid, cudaStream_t s, const BinT* bins,
                 const int32_t* sf, const int32_t* sb, const float* pow2,
                 int32_t* out, long long n_rows, int n_feat, int n_trees,
                 int depth, int rows_per_block, int from_global,
                 int rounds_per_group, int tree_stride, int level_stride) {
  const size_t smem = index_smem(depth, rows_per_block, n_feat, sizeof(BinT),
                                 !from_global);
  auto kernel = from_global ? leaf_index_kernel<BinT, false, kWeights>
                            : leaf_index_kernel<BinT, true, kWeights>;
  const cudaError_t err = allow_shared_memory(kernel, smem, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kIndexWarps * 32, smem, s>>>(
      bins, sf, sb, pow2, out, n_rows, n_feat, n_trees, depth, rows_per_block,
      rounds_per_group, tree_stride, level_stride);
  return launch_status();
}

// Launch over uint8 (bins_u8) or int32 bins.  The plan is
// kernels/tuning.py index_plan: rows_per_block rows a block (8, 16 or a
// multiple of 32), staged in shared memory unless from_global; tree_groups
// groups (grid.y) of rounds_per_group 256-tree rounds.  kWeights: pow2
// holds the level weights (dm); soa passes none.
template <bool kWeights>
inline int launch_leaf_index(const void* bins, const void* sf,
                             const void* sb, const void* pow2, void* out,
                             long long n_rows, int n_feat, int n_trees,
                             int depth, int bins_u8, int rows_per_block,
                             int from_global, int tree_groups,
                             int rounds_per_group, int tree_stride,
                             int level_stride, int device, void* stream) {
  cudaError_t err = select_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool rows_ok = rows_per_block == 8 || rows_per_block == 16 ||
                       (rows_per_block >= 32 && rows_per_block % 32 == 0);
  if (depth > kMaxDepth || !rows_ok || rounds_per_group < 1 ||
      tree_groups < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(
      static_cast<unsigned>((n_rows + rows_per_block - 1) / rows_per_block),
      static_cast<unsigned>(tree_groups));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* sfp = static_cast<const int32_t*>(sf);
  const int32_t* sbp = static_cast<const int32_t*>(sb);
  const float* wp = static_cast<const float*>(pow2);
  int32_t* op = static_cast<int32_t*>(out);
  if (bins_u8) {
    return launch_typed<uint8_t, kWeights>(
        grid, s, static_cast<const uint8_t*>(bins), sfp, sbp, wp, op, n_rows,
        n_feat, n_trees, depth, rows_per_block, from_global,
        rounds_per_group, tree_stride, level_stride);
  }
  return launch_typed<int32_t, kWeights>(
      grid, s, static_cast<const int32_t*>(bins), sfp, sbp, wp, op, n_rows,
      n_feat, n_trees, depth, rows_per_block, from_global, rounds_per_group,
      tree_stride, level_stride);
}

}  // namespace
