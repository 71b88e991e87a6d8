// Leaf-value accumulation: pred[n, c] = sum_t lv[t, idx[n, t], c].
//
// Replaces the TPU kernel src/repro/kernels/leaf_gather.py:leaf_gather
// (_leaf_gather_kernel).  The TPU kernel turns the gather into a one-hot
// matmul on the MXU and carries the sum over tree blocks from one serial
// grid step to the next in its output tile.  Neither carries over: Hopper
// gathers directly, and its blocks run in no order, so each block owns its
// rows outright and loops over every tree itself (no cross-block
// reduction, no atomics).  Every (row, output) sum is taken in tree order,
// one add per tree from 0.0f, exactly as the fused kernels take it, so the
// staged and the fused path give bit-identical scores at any C.
//
// What bounds it on an H100: bytes.  The (N, T) int32 idx is read once
// (558 MB at N = 139,440 and T = 1,000) and the leaf table (7.2 MB at
// T = 1,000, depth 8, C = 7) at least once.  A thread a row gathering its
// C leaf values from L2 for every tree pulls a 32-byte sector or two a
// (row, tree): 4.5-9 GB of L2 traffic at that shape, which, not the idx
// read, set the time of the first design.  This one:
//   * lanes hold outputs: a row's slab of at most 32 outputs is summed by
//     `lanes` lanes (the slab rounded up to a power of two), lane c adding
//     output c0 + c, so a warp sums 32 / lanes rows at once and C > 32
//     goes in slabs (grid.y), each in tree order;
//   * staged (many rows, kernels/tuning.py gather_plan): one 1,024-thread
//     block an SM owns ~N/132 rows, `rows_per_thread` a thread.  It walks
//     the trees in chunks: the chunk's leaf values (one slab) and its rows'
//     idx for those trees go to shared memory, the idx a warp a row with
//     lanes as trees (coalesced, every row's copy in flight at once), and
//     every thread then adds the chunk's trees to each of its rows, reading
//     four trees' idx in one 16-byte broadcast load and each leaf value
//     from shared memory.  The leaf table crosses L2 once a block (122
//     times at the bulk shape, 0.87 GB) instead of a sector a (row, tree);
//   * direct (few rows: a serving bucket): a lane group a row, the leaf
//     values read from L2 with kAhead trees' loads in flight (and the next
//     kAhead trees' idx behind them), so a thread waits about one L2
//     latency every kAhead trees, not every tree.  Parallelism comes from
//     rows x outputs, never from splitting a row's tree sum.
// On the card (PERF.md) the staged route takes about as long to stage a
// chunk as to sum it, and does not overlap the two: the sum is held by
// shared-memory wavefronts (a warp's 4 rows read 7-float windows at
// random leaves, which collide in the banks), the staging by the idx
// reads, a few dozen bytes of each of ~1,000 rows 4 KB apart.  Double
// buffers (smaller chunks: shorter pieces of each row) and L2 prefetches
// of idx were slower or no faster.
#include "common.cuh"

namespace {

constexpr int kMaxRows = 16;   // rows a staged thread sums (tuning.py)
constexpr int kStagedThreads = 1024;
constexpr int kAhead = 8;      // trees whose loads a direct thread issues

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

// Bytes of the staged leaf values, padded so the idx rows after them
// start on a 16-byte boundary (kernels/tuning.py gather_stage_bytes).
__host__ __device__ inline size_t lv_stage_bytes(int chunk, int n_leaves,
                                                 int slab) {
  return (static_cast<size_t>(chunk) * n_leaves * slab * sizeof(float) +
          15) & ~static_cast<size_t>(15);
}

__global__ void __launch_bounds__(kStagedThreads, 1)
gather_staged_kernel(const int32_t* __restrict__ idx,
                     const float* __restrict__ lv, float* __restrict__ out,
                     long long n_rows, int n_trees, int n_leaves, int n_out,
                     int slab, int lanes, int rows_per_thread, int chunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int c0 = blockIdx.y * slab;
  const int nc = min(slab, n_out - c0);
  const int slots = blockDim.x / lanes;
  const int rows_per_block = slots * rows_per_thread;
  const int pad = (chunk + 3) & ~3;       // idx words a staged row
  float* lv_s = reinterpret_cast<float*>(smem_raw);
  int32_t* idx_s = reinterpret_cast<int32_t*>(
      smem_raw + lv_stage_bytes(chunk, n_leaves, slab));
  const long long row0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const int rows = static_cast<int>(
      min(static_cast<long long>(rows_per_block), n_rows - row0));
  const int slot = threadIdx.x / lanes;
  const int c = threadIdx.x - slot * lanes;
  const bool active = c < nc;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const long long tree_floats = static_cast<long long>(n_leaves) * n_out;
  const bool whole = nc == n_out &&
      reinterpret_cast<uintptr_t>(lv) % 16 == 0 && tree_floats % 4 == 0;

  float acc[kMaxRows];
#pragma unroll
  for (int k = 0; k < kMaxRows; ++k) acc[k] = 0.0f;

  for (int t0 = 0; t0 < n_trees; t0 += chunk) {
    const int nt = min(chunk, n_trees - t0);
    __syncthreads();  // the previous chunk is fully consumed
    // the rows' idx for the chunk, a warp a row and lanes as trees, as
    // asynchronous copies: all of them in flight while the leaf values
    // below load
    if (lane < nt) {
      for (int r = warp; r < rows; r += n_warps) {
        copy_async4(idx_s + r * pad + lane,
                    idx + (row0 + r) * n_trees + t0 + lane);
      }
    }
    copy_commit();
    // the chunk's leaf values of this slab, (nt, n_leaves, nc)
    const long long count = static_cast<long long>(nt) * n_leaves * nc;
    if (whole) {   // one contiguous run: 16-byte copies
      const float4* src =
          reinterpret_cast<const float4*>(lv + t0 * tree_floats);
      float4* dst = reinterpret_cast<float4*>(lv_s);
#pragma unroll 4
      for (long long i = threadIdx.x; i < count / 4; i += blockDim.x) {
        dst[i] = __ldg(src + i);
      }
    } else {       // a slab of a wider table
      for (long long i = threadIdx.x; i < count; i += blockDim.x) {
        const long long leaf = i / nc;
        lv_s[i] = __ldg(lv + (t0 * static_cast<long long>(n_leaves) + leaf) *
                                 n_out + c0 + (i - leaf * nc));
      }
    }
    copy_wait_all();
    __syncthreads();
    if (!active) continue;
    const float* lc = lv_s + c;
#pragma unroll
    for (int k = 0; k < kMaxRows; ++k) {
      const int r = k * slots + slot;
      if (k < rows_per_thread && r < rows) {
        const int32_t* ir = idx_s + r * pad;
        float a = acc[k];
        for (int j = 0; j < nt; j += 4) {
          const int4 q = *reinterpret_cast<const int4*>(ir + j);
          const int base = j * n_leaves;
          a += lc[(base + q.x) * nc];
          if (j + 1 < nt) a += lc[(base + n_leaves + q.y) * nc];
          if (j + 2 < nt) a += lc[(base + 2 * n_leaves + q.z) * nc];
          if (j + 3 < nt) a += lc[(base + 3 * n_leaves + q.w) * nc];
        }
        acc[k] = a;
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int k = 0; k < kMaxRows; ++k) {
    const int r = k * slots + slot;
    if (k < rows_per_thread && r < rows) {
      out[(row0 + r) * n_out + c0 + c] = acc[k];
    }
  }
}

__global__ void gather_direct_kernel(const int32_t* __restrict__ idx,
                                     const float* __restrict__ lv,
                                     float* __restrict__ out,
                                     long long n_rows, int n_trees,
                                     int n_leaves, int n_out, int slab,
                                     int lanes) {
  const int c0 = blockIdx.y * slab;
  const int nc = min(slab, n_out - c0);
  const int slot = threadIdx.x / lanes;
  const int c = threadIdx.x - slot * lanes;
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x / lanes) + slot;
  if (row >= n_rows || c >= nc) return;
  const int32_t* ir = idx + row * n_trees;
  const float* lc = lv + c0 + c;
  const long long tree_floats = static_cast<long long>(n_leaves) * n_out;
  int next[kAhead];
#pragma unroll
  for (int u = 0; u < kAhead; ++u) next[u] = u < n_trees ? __ldg(ir + u) : 0;
  float acc = 0.0f;
  for (int t0 = 0; t0 < n_trees; t0 += kAhead) {
    float v[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      v[u] = t0 + u < n_trees
                 ? __ldg(lc + (t0 + u) * tree_floats +
                         static_cast<long long>(next[u]) * n_out)
                 : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int t = t0 + kAhead + u;
      next[u] = t < n_trees ? __ldg(ir + t) : 0;
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (t0 + u < n_trees) acc += v[u];   // tree order, one add a tree
    }
  }
  out[row * n_out + c0 + c] = acc;
}

}  // namespace

// idx (n_rows, n_trees) int32 with every value in [0, n_leaves); lv
// (n_trees, n_leaves, n_out) f32; out (n_rows, n_out) f32.  The plan is
// kernels/tuning.py gather_plan: slabs of `slab` <= 32 outputs (grid.y),
// `lanes` >= slab lanes a row; staged: `threads` (at most 1,024) a block,
// rows_per_thread <= kMaxRows rows a thread, `chunk` <= 32 trees a chunk
// in shared memory; direct: `threads` a block, a row a lane group.
extern "C" int repro_leaf_gather(const void* idx, const void* lv, void* out,
                                 long long n_rows, int n_trees, int n_leaves,
                                 int n_out, int slab, int lanes, int staged,
                                 int threads, int rows_per_thread, int chunk,
                                 int row_blocks, int device, void* stream) {
  cudaError_t err = select_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (slab < 1 || slab > 32 || lanes < slab || lanes > 32 ||
      32 % lanes != 0 || threads % 32 != 0 ||
      (staged && (threads > kStagedThreads || rows_per_thread < 1 ||
                  rows_per_thread > kMaxRows || chunk < 1 || chunk > 32)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_slabs = (n_out + slab - 1) / slab;
  const dim3 grid(static_cast<unsigned>(row_blocks),
                  static_cast<unsigned>(n_slabs));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* ip = static_cast<const int32_t*>(idx);
  const float* lp = static_cast<const float*>(lv);
  float* op = static_cast<float*>(out);
  if (!staged) {
    note_launch(gather_direct_kernel, 0);
    gather_direct_kernel<<<grid, threads, 0, s>>>(ip, lp, op, n_rows, n_trees,
                                                  n_leaves, n_out, slab,
                                                  lanes);
    return launch_status();
  }
  const int rows = threads / lanes * rows_per_thread;
  const size_t smem = lv_stage_bytes(chunk, n_leaves, slab) +
                      static_cast<size_t>(rows) * ((chunk + 3) / 4) * 16;
  err = allow_shared_memory(gather_staged_kernel, smem, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  gather_staged_kernel<<<grid, threads, smem, s>>>(
      ip, lp, op, n_rows, n_trees, n_leaves, n_out, slab, lanes,
      rows_per_thread, chunk);
  return launch_status();
}
