// Split search of one tree level (training/gbdt.py `_split_level`):
//   gain[f, b] = sum over (leaf l, output c) of
//                gl^2 / (hl + l2) + gr^2 / (hr + l2)
// where (gl, hl) sum output c's gradient and hessian over leaf l's bins
// below border b and (gr, hr) over the rest; NEG_INF where b is not a
// valid border of f or a side holds no hessian mass; then (f*, b*), the
// first maximum over (f, b) flattened, and each row's new leaf id
//   leaf | (bins_t[f*, n] >= b*) << d.
//
// No TPU kernel stands behind it: in the JAX package this step is plain
// jnp (src/repro/training/gbdt.py: _split_level) that XLA compiles into
// loops of its own.  Issued from the host as PyTorch ops, it was about a
// hundred small launches a level (PERF.md).  Here it is three kernels, no
// host synchronization, and f*, b* stay on the card.
//
// Bits.  The float sums are added in the order core/split_sums.py gives
// (XLA's order in the JAX package), so the card gives the CPU's bits:
//   * the inclusive scan over bins of each (feature, leaf, stat) column in
//     blocks of 16: in order within a block, the block totals scanned the
//     same way (in order up to 16 of them, blocked again past that), and
//     each element adds the scanned total of the blocks before it
//     (`blocked_cumsum`);
//   * the sum over (leaf, output) in the order `leaf_sum_plan(L, B, C)`
//     names, whose four integers are arguments: in order; `lanes`
//     accumulators over the first `vector_leaves` leaves, added in halves,
//     then the rest in order; or windows of 32 leaves, each in order or in
//     `window_lanes` lanes, the window sums then added the same way
//     (`leaf_stat_sum`).
// Every add, multiply and divide is __fadd_rn / __fmul_rn / __fdiv_rn: nvcc
// contracts a * b + c into one fused multiply-add by default, which rounds
// once where the plain version rounds twice.  Hessians are non-negative,
// so "a side's hessians sum above 0" is "some hessian of the side is above
// 0", which needs no sum.
//
// Kernels.
//   1. split_terms_kernel: a block owns `pairs_per_block` (feature, leaf,
//      output) pairs of columns (gradient, hessian), each of B bins.  A
//      thread scans a 16-bin block of a pair's two columns in registers
//      (its 32 loads issued first), the block totals are scanned in shared
//      memory, and a second pass adds each block its carry and makes the
//      (F, L, C, B) gain terms and two mass flags a term (left, right).
//      The block's terms and flags are one contiguous run of the scratch:
//      where they fit (kStaged), they gather in shared memory and leave in
//      coalesced stores (stored one by one, an L2 transaction each, they
//      took twice the time).
//   2. split_choose_kernel: a thread a valid (feature, border) with
//      hessian mass on both sides (16 flags loaded at a time) adds its
//      L x C terms in the plan's order, 16 loads ahead of their adds; the
//      threads of a warp read neighbouring borders.  A border's chain is
//      serial, so at one round of at most kMaxSlots windows (64 to 256
//      leaves) a thread takes one window and the first adds the window
//      sums in order.  Every other border is NEG_INF; the block keeps its
//      first maximum.
//   3. split_refine_kernel: every block reduces the choose blocks' winners
//      to (f*, b*) (the first block writes them), then refines 16 rows a
//      thread with 16-byte loads of the bins column and the leaf ids.
//
// Bound on an H100: bytes.  A level reads its (F, L*B, 2C) histogram once,
// the (F, B) mask, the chosen column and the leaf ids, and writes the leaf
// ids: at Covertype width (54 features, 129 bins, 7 outputs, 325,360 rows)
// 0.39 MB of histogram a leaf plus 3.3 MB, 53 MB (16 us at 3.35 TB/s) at
// d = 7 and 123 MB (37 us) over the eight levels of a tree.  The gain terms
// (half the histogram's bytes) go to scratch and back, and a border's
// chain is one thread's; its times on the card (about 10x the bound) are
// in PERF.md.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;           // tuning.SPLIT_THREADS
constexpr int kChooseThreads = 64;      // tuning.SPLIT_CHOOSE_THREADS
constexpr int kBatch = 16;              // terms a choose thread loads ahead
constexpr int kMaxSlots = 8;            // windows a choose block splits
constexpr int kScanBlock = 16;          // split_sums.SCAN_BLOCK
constexpr int kLeafWindow = 32;         // split_sums.LEAF_WINDOW
constexpr int kMaxLanes = 16;           // widest lanes split_sums names
constexpr int kMaxWindows = 4;          // window rounds: 32^4 leaves
constexpr int kMaxScanLevels = 6;       // block-total levels: 16^7 bins
constexpr int kRowsPerThread = 16;      // tuning.SPLIT_ROWS_PER_THREAD
constexpr int kTermsSmem = 48 * 1024;   // tuning.SPLIT_TERMS_SMEM
constexpr float kNegInf = -1e30f;       // split_sums.NEG_INF

// The levels of block totals of an n_bins scan: level 0 holds the totals
// of the bins' 16-blocks, level j + 1 those of level j's 16-blocks, down to
// a level of at most 16.  A column keeps its levels at `off` in its
// `floats` shared floats, and its last bin's in-block value at the end.
struct ScanShape {
  int levels;
  int len[kMaxScanLevels];
  int off[kMaxScanLevels];
  int floats;
};

ScanShape scan_shape(int n_bins) {
  ScanShape s = {};
  int n = n_bins;
  int off = 0;
  while (n > kScanBlock && s.levels < kMaxScanLevels) {
    n = (n + kScanBlock - 1) / kScanBlock;
    s.len[s.levels] = n;
    s.off[s.levels] = off;
    off += n;
    ++s.levels;
  }
  s.floats = n > kScanBlock ? -1 : off + 1;   // -1: too many bins
  return s;
}

// split_sums.leaf_sum_plan's four integers.
struct SumPlan {
  int windows;
  int lanes;
  int vector_leaves;
  int window_lanes;
};

__device__ __forceinline__ float gain_term(float g, float h, float l2) {
  return __fdiv_rn(__fmul_rn(g, g), __fadd_rn(h, l2));
}

// torch.argmax's order: NaN above every number, equal values to the lower
// index; an index below 0 is no candidate.
__device__ __forceinline__ bool beats(float a, int ia, float b, int ib) {
  if (ia < 0) return false;
  if (ib < 0) return true;
  if (isnan(a)) return !isnan(b) || ia < ib;
  if (isnan(b)) return false;
  return a == b ? ia < ib : a > b;
}

// The block's first maximum of each thread's (value, index), left in
// slot 0 of `val` / `idx`.
__device__ void block_best(float v, int i, float* val, int* idx) {
  val[threadIdx.x] = v;
  idx[threadIdx.x] = i;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s &&
        beats(val[threadIdx.x + s], idx[threadIdx.x + s], val[threadIdx.x],
              idx[threadIdx.x])) {
      val[threadIdx.x] = val[threadIdx.x + s];
      idx[threadIdx.x] = idx[threadIdx.x + s];
    }
    __syncthreads();
  }
}

// In-order scan of the 16-block of `x` (stride `stride`) starting at
// element `first`, the elements at or past `n` read as +0 (the scan pads
// so): returns the block's total, calls `emit(e, value)` on each element
// below `n`.
// A pair's gradient and hessian column at bins first .. first + 15, +0
// at or past `n` (the scan pads so): every load goes out before the scan
// reads one.
__device__ __forceinline__ void load16(const float* src, long long stats,
                                       int n_out, int first, int n,
                                       float (&g)[kScanBlock],
                                       float (&h)[kScanBlock]) {
#pragma unroll
  for (int i = 0; i < kScanBlock; ++i) {
    const long long e = first + i;
    g[i] = e < n ? src[e * stats] : 0.0f;
    h[i] = e < n ? src[e * stats + n_out] : 0.0f;
  }
}

template <typename Emit>
__device__ __forceinline__ float scan16(const float* x, long long stride,
                                        int first, int n, Emit emit) {
  float v = 0.0f;
  for (int i = 0; i < kScanBlock; ++i) {
    const int e = first + i;
    const float xi = e < n ? x[e * stride] : 0.0f;
    v = i == 0 ? xi : __fadd_rn(v, xi);
    if (e < n) emit(e, v);
  }
  return v;
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
split_terms_kernel(const float* __restrict__ hist, float* __restrict__ terms,
                   uint8_t* __restrict__ mass, long long n_pairs, int n_bins,
                   int n_out, int pairs_per_block, ScanShape shape,
                   float l2) {
  extern __shared__ float smem[];
  const long long first = static_cast<long long>(blockIdx.x) *
                          pairs_per_block;
  const int pairs = static_cast<int>(
      min(static_cast<long long>(pairs_per_block), n_pairs - first));
  const int blocks = (n_bins + kScanBlock - 1) / kScanBlock;
  const int items = pairs * blocks;
  const int cols = 2 * pairs;
  const long long stats = 2 * n_out;
  const int last = shape.floats - 1;

  // 1. each 16-bin block of each column in order: its total into level 0,
  //    the last bin's value aside
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int q = it / blocks;
    const int k = it - q * blocks;
    const long long p = first + q;
    const float* src = hist + (p / n_out) * n_bins * stats + p % n_out;
    float xg[kScanBlock], xh[kScanBlock];
    load16(src, stats, n_out, k * kScanBlock, n_bins, xg, xh);
    const int at_last = n_bins - 1 - k * kScanBlock;
    float vg = xg[0], vh = xh[0], lg = vg, lh = vh;
#pragma unroll
    for (int i = 1; i < kScanBlock; ++i) {
      vg = __fadd_rn(vg, xg[i]);
      vh = __fadd_rn(vh, xh[i]);
      if (i == at_last) {
        lg = vg;
        lh = vh;
      }
    }
    float* cg = smem + 2 * q * shape.floats;
    float* ch = cg + shape.floats;
    if (at_last >= 0 && at_last < kScanBlock) {
      cg[last] = lg;
      ch[last] = lh;
    }
    if (shape.levels) {
      cg[shape.off[0] + k] = vg;
      ch[shape.off[0] + k] = vh;
    }
  }
  __syncthreads();

  // 2. the levels of block totals, scanned as blocked_cumsum scans them:
  //    bottom up, each level's 16-blocks in order with their totals into
  //    the next level, the last level (at most 16) in order; then top down,
  //    each level adds the scanned totals of the blocks before
  for (int j = 0; j < shape.levels; ++j) {
    const int n = shape.len[j];
    if (j + 1 < shape.levels) {
      const int nb = shape.len[j + 1];
      for (int it = threadIdx.x; it < cols * nb; it += blockDim.x) {
        const int c = it / nb;
        const int k = it - c * nb;
        float* a = smem + c * shape.floats + shape.off[j];
        const float total = scan16(a, 1, k * kScanBlock, n,
                                   [&](int e, float v) { a[e] = v; });
        smem[c * shape.floats + shape.off[j + 1] + k] = total;
      }
    } else {
      for (int c = threadIdx.x; c < cols; c += blockDim.x) {
        float* a = smem + c * shape.floats + shape.off[j];
        for (int e = 1; e < n; ++e) a[e] = __fadd_rn(a[e - 1], a[e]);
      }
    }
    __syncthreads();
  }
  for (int j = shape.levels - 2; j >= 0; --j) {
    const int n = shape.len[j];
    for (int it = threadIdx.x; it < cols * n; it += blockDim.x) {
      const int c = it / n;
      const int e = it - c * n;
      float* a = smem + c * shape.floats;
      const int k = e / kScanBlock;
      a[shape.off[j] + e] = __fadd_rn(
          a[shape.off[j] + e], k ? a[shape.off[j + 1] + k - 1] : 0.0f);
    }
    __syncthreads();
  }

  // 3. each bin's scan: its in-block value plus the scanned totals of the
  //    blocks before (level 0).  Left of border b is the scan at b - 1
  //    (+0 at b = 0), right the column's total less left.
  const bool carried = shape.levels > 0;
  float* staged_terms = smem + cols * shape.floats;
  uint8_t* staged_flags =
      reinterpret_cast<uint8_t*>(staged_terms + pairs * n_bins);
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int q = it / blocks;
    const int k = it - q * blocks;
    const long long p = first + q;
    const float* src = hist + (p / n_out) * n_bins * stats + p % n_out;
    const float* cg = smem + 2 * q * shape.floats;
    const float* ch = cg + shape.floats;
    const float carry_g = k ? cg[shape.off[0] + k - 1] : 0.0f;
    const float carry_h = k ? ch[shape.off[0] + k - 1] : 0.0f;
    const float total_g =
        carried ? __fadd_rn(cg[last], cg[shape.off[0] + blocks - 2])
                : cg[last];
    const float total_h =
        carried ? __fadd_rn(ch[last], ch[shape.off[0] + blocks - 2])
                : ch[last];
    // staged: the block's terms and flags go to shared memory first, and
    // out to their (contiguous) place in coalesced stores at the end
    float* out = kStaged ? staged_terms + q * n_bins : terms + p * n_bins;
    uint8_t* flags = kStaged ? staged_flags + q * n_bins : mass + p * n_bins;
    const auto emit = [&](int b, float lg, float lh) {
      const float rg = __fsub_rn(total_g, lg);
      const float rh = __fsub_rn(total_h, lh);
      out[b] = __fadd_rn(gain_term(lg, lh, l2), gain_term(rg, rh, l2));
      flags[b] = static_cast<uint8_t>((lh > 0.0f ? 1 : 0) |
                                      (rh > 0.0f ? 2 : 0));
    };
    if (k == 0) emit(0, 0.0f, 0.0f);
    // bins k * 16 + 1 .. k * 16 + 16 below n_bins take the scan of the
    // bin before them as their left side
    float xg[kScanBlock], xh[kScanBlock];
    load16(src, stats, n_out, k * kScanBlock, n_bins - 1, xg, xh);
    const int count = n_bins - 1 - k * kScanBlock;
    float vg = xg[0], vh = xh[0];
#pragma unroll
    for (int i = 0; i < kScanBlock; ++i) {
      if (i) {
        vg = __fadd_rn(vg, xg[i]);
        vh = __fadd_rn(vh, xh[i]);
      }
      if (i < count) {
        emit(k * kScanBlock + i + 1, carried ? __fadd_rn(vg, carry_g) : vg,
             carried ? __fadd_rn(vh, carry_h) : vh);
      }
    }
  }
  if (kStaged) {
    __syncthreads();
    const long long base = first * n_bins;
    const int cells = pairs * n_bins;
    for (int i = threadIdx.x; i < cells; i += blockDim.x) {
      terms[base + i] = staged_terms[i];
      mass[base + i] = staged_flags[i];
    }
  }
}

// The terms of one (feature, border) in (leaf, output) order: term j =
// l * n_out + c at t[j * stride].
struct Terms {
  const float* t;
  long long stride;
  int n_out;

  // acc, then terms j0 .. j1 - 1 added in order; `fresh` starts the chain
  // at term j0.  The loads of kBatch terms go out before their adds.
  __device__ float chain(float acc, bool fresh, long long j0,
                         long long j1) const {
    long long j = j0;
    if (fresh) acc = t[j++ * stride];
    for (; j + kBatch <= j1; j += kBatch) {
      float v[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) v[k] = t[(j + k) * stride];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) acc = __fadd_rn(acc, v[k]);
    }
    if (j < j1) {
      float v[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k)
        v[k] = j + k < j1 ? t[(j + k) * stride] : 0.0f;
#pragma unroll
      for (int k = 0; k < kBatch; ++k)
        if (j + k < j1) acc = __fadd_rn(acc, v[k]);
    }
    return acc;
  }

  // acc, then the terms of leaves l0, l0 + step, ... below l1 (outputs
  // inner) added in order.
  __device__ float add(float acc, bool fresh, int l0, int l1,
                       int step) const {
    if (step == 1) {
      return chain(acc, fresh, static_cast<long long>(l0) * n_out,
                   static_cast<long long>(l1) * n_out);
    }
    for (int l = l0; l < l1; l += step) {
      acc = chain(acc, fresh, static_cast<long long>(l) * n_out,
                  static_cast<long long>(l + 1) * n_out);
      fresh = false;
    }
    return acc;
  }

  // `lanes` chains, lane j over leaves lo + j, lo + j + lanes, ... below
  // hi, then added in halves.
  __device__ float lanes_sum(int lo, int hi, int lanes) const {
    float acc[kMaxLanes];
    for (int j = 0; j < lanes; ++j) acc[j] = add(0.0f, true, lo + j, hi, lanes);
    for (int half = lanes / 2; half >= 1; half /= 2)
      for (int j = 0; j < half; ++j) acc[j] = __fadd_rn(acc[j], acc[j + half]);
    return acc[0];
  }
};

// The sum of the round-0 window of 32 leaves from w0: in order, or in
// `window_lanes` lanes with its last leaves in order.
__device__ float window_sum(const Terms& t, int w0, const SumPlan& plan) {
  const int k = plan.window_lanes;
  if (k == 1) return t.add(0.0f, true, w0, w0 + kLeafWindow, 1);
  const int nv = kLeafWindow - k;
  return t.add(t.lanes_sum(w0, w0 + nv, k), false, w0 + nv,
               w0 + kLeafWindow, 1);
}

// The sum over (leaf, output) in `plan`'s order (split_sums.leaf_stat_sum).
__device__ float leaf_output_sum(const Terms& t, int n_leaves,
                                 const SumPlan& plan) {
  if (plan.windows == 0) {
    const int nv = plan.vector_leaves;
    if (nv == 0) return t.add(0.0f, true, 0, n_leaves, 1);
    return t.add(t.lanes_sum(0, nv, plan.lanes), false, nv, n_leaves, 1);
  }
  // round 0 sums each window of 32 leaves; round r > 0 each window of 32
  // sums of round r - 1, in order; the last round's sums add in order
  float acc[kMaxWindows + 1];
  int count[kMaxWindows + 1] = {};
  for (int w0 = 0; w0 < n_leaves; w0 += kLeafWindow) {
    float v = window_sum(t, w0, plan);
    for (int r = 1;; ++r) {
      acc[r] = count[r]++ ? __fadd_rn(acc[r], v) : v;
      if (r == plan.windows || count[r] < kLeafWindow) break;
      v = acc[r];
      count[r] = 0;
    }
  }
  return acc[plan.windows];
}

__global__ void __launch_bounds__(kChooseThreads)
split_choose_kernel(const float* __restrict__ terms,
                    const uint8_t* __restrict__ mass,
                    const uint8_t* __restrict__ valid,
                    float* __restrict__ gains, float* __restrict__ win_val,
                    int* __restrict__ win_idx, int n_features, int n_leaves,
                    int n_bins, int n_out, SumPlan plan) {
  __shared__ float val[kChooseThreads];
  __shared__ int idx[kChooseThreads];
  __shared__ float window[kMaxSlots][kChooseThreads];
  const int n_cand = n_features * n_bins;
  const long long per_feature =
      static_cast<long long>(n_leaves) * n_out * n_bins;
  const long long n_terms = static_cast<long long>(n_leaves) * n_out;
  // one round of at most kMaxSlots windows: a thread a window, the first
  // slot adds the window sums in order
  const int n_windows = n_leaves / kLeafWindow;
  const int slots = plan.windows == 1 && n_windows <= kMaxSlots
                        ? n_windows : 1;
  const int per_block = kChooseThreads / slots;
  const int lane = threadIdx.x % per_block;
  const int slot = threadIdx.x / per_block;
  float best = 0.0f;
  int best_i = -1;
  for (int base = blockIdx.x * per_block; base < n_cand;
       base += gridDim.x * per_block) {
    const int cand = base + lane;
    const int f = cand / n_bins;
    const long long off = f * per_feature + (cand - f * n_bins);
    const Terms t{terms + off, n_bins, n_out};
    // a border that is not valid is NEG_INF whatever its sums
    const bool live = cand < n_cand && valid[cand];
    if (slots > 1) {
      if (live) window[slot][lane] = window_sum(t, slot * kLeafWindow, plan);
      __syncthreads();
    }
    if (slot == 0 && cand < n_cand) {
      float g = kNegInf;
      if (live) {
        unsigned sides = 0;
        for (long long j = 0; j < n_terms && sides != 3; j += kBatch) {
#pragma unroll
          for (int k = 0; k < kBatch; ++k)
            if (j + k < n_terms) sides |= mass[off + (j + k) * n_bins];
        }
        if (sides == 3) {
          if (slots > 1) {
            g = window[0][lane];
            for (int w = 1; w < slots; ++w) g = __fadd_rn(g, window[w][lane]);
          } else {
            g = leaf_output_sum(t, n_leaves, plan);
          }
        }
      }
      gains[cand] = g;
      if (beats(g, cand, best, best_i)) {
        best = g;
        best_i = cand;
      }
    }
    if (slots > 1) __syncthreads();
  }
  block_best(best, best_i, val, idx);
  if (threadIdx.x == 0) {
    win_val[blockIdx.x] = val[0];
    win_idx[blockIdx.x] = idx[0];
  }
}

// 16 bins of one column as ints, from one 16-byte load (uint8) or four.
__device__ __forceinline__ void load16(const uint8_t* p, int (&v)[16]) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const unsigned words[4] = {w.x, w.y, w.z, w.w};
  for (int i = 0; i < 16; ++i) v[i] = (words[i / 4] >> (8 * (i % 4))) & 0xff;
}

__device__ __forceinline__ void load16(const int32_t* p, int (&v)[16]) {
  for (int j = 0; j < 4; ++j) {
    const int4 w = reinterpret_cast<const int4*>(p)[j];
    v[4 * j] = w.x;
    v[4 * j + 1] = w.y;
    v[4 * j + 2] = w.z;
    v[4 * j + 3] = w.w;
  }
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename BinT>
__global__ void __launch_bounds__(kThreads)
split_refine_kernel(const float* __restrict__ win_val,
                    const int* __restrict__ win_idx, int n_win,
                    const BinT* __restrict__ bins_t,
                    const int32_t* __restrict__ leaf,
                    int32_t* __restrict__ out, int32_t* __restrict__ f_out,
                    int32_t* __restrict__ b_out, long long n_rows,
                    int n_bins, int depth) {
  __shared__ float val[kThreads];
  __shared__ int idx[kThreads];
  float best = 0.0f;
  int best_i = -1;
  for (int w = threadIdx.x; w < n_win; w += blockDim.x) {
    if (beats(win_val[w], win_idx[w], best, best_i)) {
      best = win_val[w];
      best_i = win_idx[w];
    }
  }
  block_best(best, best_i, val, idx);
  const int chosen = max(idx[0], 0);
  const int f = chosen / n_bins;
  const int b = chosen - f * n_bins;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *f_out = f;
    *b_out = b;
  }
  const BinT* col = bins_t + static_cast<long long>(f) * n_rows;
  const int32_t bit = 1 << depth;
  const bool vec = aligned16(col) && aligned16(leaf) && aligned16(out);
  const long long stride =
      static_cast<long long>(gridDim.x) * blockDim.x * kRowsPerThread;
  for (long long r0 = (static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x) * kRowsPerThread;
       r0 < n_rows; r0 += stride) {
    if (vec && r0 + kRowsPerThread <= n_rows) {
      int v[16];
      load16(col + r0, v);
      const int4* lp = reinterpret_cast<const int4*>(leaf + r0);
      int4* op = reinterpret_cast<int4*>(out + r0);
      for (int j = 0; j < 4; ++j) {
        int4 w = lp[j];
        w.x |= v[4 * j] >= b ? bit : 0;
        w.y |= v[4 * j + 1] >= b ? bit : 0;
        w.z |= v[4 * j + 2] >= b ? bit : 0;
        w.w |= v[4 * j + 3] >= b ? bit : 0;
        op[j] = w;
      }
    } else {
      const long long end = min(r0 + kRowsPerThread, n_rows);
      for (long long r = r0; r < end; ++r)
        out[r] = leaf[r] | (static_cast<int>(col[r]) >= b ? bit : 0);
    }
  }
}

inline size_t align16(size_t n) { return (n + 15) / 16 * 16; }

}  // namespace

// hist (n_features, n_leaves * n_bins, 2 * n_out) f32, gradients then
// hessians on the last axis; valid (n_features, n_bins) bool; bins_t
// (n_features, n_rows) uint8 (bins_u8) or int32; leaf (n_rows,) int32 ids
// below 2^depth.  Writes leaf_out (n_rows,) int32, f_out and b_out (one
// int32 each) = (f*, b*).  The plan (kernels/tuning.py split_plan): pairs_per_block
// column pairs a terms block, whose terms and flags are staged in shared
// memory (staged) or stored as they come; choose_blocks and refine_blocks
// blocks.  scratch holds, each 16-byte aligned, the (n_features, n_leaves,
// n_out, n_bins) f32 terms, the (n_features, n_bins) f32 masked gains, the
// choose blocks' winners (f32 values, int32 indexes) and the terms' mass
// flags (uint8).  windows, lanes, vector_leaves, window_lanes:
// core/split_sums.py leaf_sum_plan(n_leaves, n_bins, n_out).  Launches the
// three kernels, in order, on the stream.
extern "C" int repro_split_level(
    const void* hist, const void* valid, const void* bins_t, const void* leaf,
    void* scratch, void* leaf_out, void* f_out, void* b_out, long long n_rows,
    int n_features, int n_leaves, int n_bins, int n_out, int depth,
    int bins_u8, int pairs_per_block, int choose_blocks, int refine_blocks,
    int staged, int windows, int lanes, int vector_leaves, int window_lanes,
    float l2, int device, void* stream) {
  cudaError_t err = select_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const ScanShape shape = scan_shape(n_bins);
  const size_t per_pair =
      sizeof(float) * 2 * static_cast<size_t>(shape.floats > 0 ? shape.floats
                                                               : 0) +
      (staged ? (sizeof(float) + 1) * static_cast<size_t>(n_bins) : 0);
  const size_t smem = per_pair * static_cast<size_t>(pairs_per_block);
  const long long n_cand = static_cast<long long>(n_features) * n_bins;
  if (n_features < 1 || n_leaves < 1 || n_bins < 1 || n_out < 1 ||
      depth < 0 || depth > 30 || n_rows < 0 || pairs_per_block < 1 ||
      choose_blocks < 1 || refine_blocks < 1 || shape.floats < 0 ||
      smem > kTermsSmem || n_cand > 0x7fffffffLL || windows < 0 ||
      windows > kMaxWindows || lanes < 1 || lanes > kMaxLanes ||
      window_lanes < 1 || window_lanes > kMaxLanes || vector_leaves < 0 ||
      vector_leaves > n_leaves)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_pairs =
      static_cast<long long>(n_features) * n_leaves * n_out;
  const long long cells = n_pairs * n_bins;
  char* at = static_cast<char*>(scratch);
  float* terms = reinterpret_cast<float*>(at);
  at += align16(sizeof(float) * cells);
  float* gains = reinterpret_cast<float*>(at);
  at += align16(sizeof(float) * n_cand);
  float* win_val = reinterpret_cast<float*>(at);
  at += align16(sizeof(float) * choose_blocks);
  int* win_idx = reinterpret_cast<int*>(at);
  at += align16(sizeof(int) * choose_blocks);
  uint8_t* mass = reinterpret_cast<uint8_t*>(at);

  const unsigned term_blocks = static_cast<unsigned>(
      (n_pairs + pairs_per_block - 1) / pairs_per_block);
  const float* hp = static_cast<const float*>(hist);
  if (staged) {
    note_launch(split_terms_kernel<true>, smem);
    split_terms_kernel<true><<<term_blocks, kThreads, smem, s>>>(
        hp, terms, mass, n_pairs, n_bins, n_out, pairs_per_block, shape,
        l2);
  } else {
    note_launch(split_terms_kernel<false>, smem);
    split_terms_kernel<false><<<term_blocks, kThreads, smem, s>>>(
        hp, terms, mass, n_pairs, n_bins, n_out, pairs_per_block, shape,
        l2);
  }
  if (int st = launch_status()) return st;

  const SumPlan plan = {windows, lanes, vector_leaves, window_lanes};
  note_launch(split_choose_kernel, 0);
  split_choose_kernel<<<choose_blocks, kChooseThreads, 0, s>>>(
      terms, mass, static_cast<const uint8_t*>(valid), gains, win_val,
      win_idx, n_features, n_leaves, n_bins, n_out, plan);
  if (int st = launch_status()) return st;

  const int32_t* lp = static_cast<const int32_t*>(leaf);
  int32_t* op = static_cast<int32_t*>(leaf_out);
  int32_t* fp = static_cast<int32_t*>(f_out);
  int32_t* bp = static_cast<int32_t*>(b_out);
  if (bins_u8) {
    note_launch(split_refine_kernel<uint8_t>, 0);
    split_refine_kernel<uint8_t><<<refine_blocks, kThreads, 0, s>>>(
        win_val, win_idx, choose_blocks,
        static_cast<const uint8_t*>(bins_t), lp, op, fp, bp, n_rows, n_bins,
        depth);
  } else {
    note_launch(split_refine_kernel<int32_t>, 0);
    split_refine_kernel<int32_t><<<refine_blocks, kThreads, 0, s>>>(
        win_val, win_idx, choose_blocks,
        static_cast<const int32_t*>(bins_t), lp, op, fp, bp, n_rows, n_bins,
        depth);
  }
  return launch_status();
}
