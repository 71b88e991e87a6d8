// Pairwise squared L2 distances (the kNN featurizer's batched form):
//   out[m, n] = max((-2 * sum_k a[m, k] b[n, k] + a_sq[m]) + b_sq[n], 0)
// with a_sq[m] = ||a[m]||^2 and b_sq[n] = ||b[n]||^2.
//
// Replaces the TPU kernel src/repro/kernels/l2dist.py:l2sq_matrix
// (_l2_matrix_kernel).  The TPU kernel runs the cross term on the MXU,
// carries -2 * cross over the K blocks from one serial grid step to the
// next in its output tile, and at the last K block adds the norms and
// clamps.  Here a block owns an output tile and loops over all of K
// itself, in the same order: the cross term summed over K, then -2 *
// cross + a_sq, then + b_sq, then the clamp (v < 0 ? 0 : v keeps a NaN,
// as jnp.maximum and torch.clamp_min do).
//
// What bounds it on an H100: operations.  2 M N K flops against about
// 4 (M + N) K + 4 M N bytes: at the test split (2,841 x 2,808, K = 512)
// 8.17 GFLOP against 43.5 MB.  In fp32 outside the tensor cores that is
// 0.122 ms at 67 TFLOP/s, the ceiling of any FFMA design (cuBLAS's SGEMM
// sits at it too).  The tensor cores run TF32 at 495 TFLOP/s, but one
// TF32 product keeps 11 bits of each operand and breaks the distance rule
// (PERF.md §2) about 5x.  So the product is 3xTF32: each operand is split
// into hi = tf32(x), rounded to nearest, and lo = x - hi, and
//   a.b ~ a_hi.b_hi + a_hi.b_lo + a_lo.b_hi
// (the tensor core reads lo's top 19 bits), three TF32 products into one
// fp32 accumulator: 3 * 2 M N K / 495e12 s, 0.0495 ms at the test split.
//
// Two kernels, launched back to back on one stream:
//   * l2sq_split_kernel: a warp a row of a or b writes hi and lo into
//     (2, rows, k_pad) scratch, K padded with zeros to a multiple of 32,
//     so every shape and alignment of the inputs becomes a TMA-legal
//     tensor, and sums the row's squares in a fixed order (lane-strided,
//     then a __shfl_xor_sync butterfly);
//   * l2sq_matrix_kernel: a block of three warpgroups owns a 128 x 128
//     output tile.  Warpgroup 0 gives up registers (setmaxnreg) and one
//     of its threads keeps a ring of stages full with TMA: a stage is 32
//     K values (one 128-byte swizzle row a matrix row) of hi and lo of
//     both operands, one 3-D box (k, row, hi|lo) an operand, on an
//     mbarrier with expected bytes; OOB rows and columns come in as
//     zeros.  Warpgroups 1 and 2 each own 64 rows and issue
//     wgmma.m64n128k8.f32.tf32.tf32 three times a k8 step (hi.hi, hi.lo,
//     lo.hi) straight from the swizzled stage; both operands are K-major
//     as stored, which is what TF32 wgmma takes.
//   * The tensor cores add into their fp32 accumulator without rounding
//     to nearest, so over K the sum drifts one way instead of walking at
//     random (on an H100, 0.22 of the distance rule at the kNN test
//     split).  Each stage's 12 products therefore go into a fresh
//     fragment, which is added to the running fp32 sum with ordinary
//     rounded adds once the stage's group is done (0.05 of the rule
//     there); the stage goes back to the producer at that point.  A
//     256-wide tile would need 256 accumulator registers a thread for
//     this: it is not built.
//   * The epilogue writes the tile through shared memory: the spent ring
//     takes it as four 32-column boxes in the 128-byte swizzle and one
//     thread stores them with TMA, which clips the ragged edge, so the
//     block retires without waiting on its stores (on an H100, 0.085 ms
//     at the kNN test split against 0.099 with every SM storing its
//     fragments at once).  TMA needs 16-byte row strides: with N % 4 != 0
//     each thread stores its fragment itself.
//   * No split-K, no atomics, a static tile-to-block map (M tiles fastest,
//     so a wave shares its B tiles in L2): each output is one fixed-order
//     sum, and two launches give the same bits.
#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from
                   // cudaGetDriverEntryPoint, so nothing links libcuda
#include <limits.h>

#include "common.cuh"

namespace {

constexpr int kTileM = 128;          // output rows a block
constexpr int kTileN = 128;          // output columns a block (wgmma N)
constexpr int kKBlock = 32;          // K values a stage: 128 bytes of fp32
constexpr int kThreads = 384;        // a producer and two consumer warpgroups
constexpr int kSplitThreads = 256;   // the split pass: a warp a row
constexpr int kRowBytes = kKBlock * 4;
constexpr int kAlign = 1024;         // the 128-byte swizzle's 8-row atom
constexpr int kConsumerWarps = 8;    // arrivals that release a stage
constexpr int kProducerRegs = 40;    // setmaxnreg: 128 x 40 + 256 x 232
constexpr int kConsumerRegs = 232;   // = 384 x 168, the launch's registers
// A wait that outlasts this many cycles (about 2 s) traps: a lost
// arrival fails the launch instead of hanging the card.
constexpr long long kWaitLimitCycles = 1ll << 32;

__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

__global__ void __launch_bounds__(kSplitThreads)
    l2sq_split_kernel(const float* __restrict__ a,
                      const float* __restrict__ b, int m_rows, int n_rows,
                      int k_dim, int k_pad, float* __restrict__ a_split,
                      float* __restrict__ b_split, float* __restrict__ a_sq,
                      float* __restrict__ b_sq) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (kSplitThreads / 32) +
      (threadIdx.x >> 5);
  if (row >= static_cast<long long>(m_rows) + n_rows) return;
  const int lane = threadIdx.x & 31;
  const bool is_a = row < m_rows;
  const long long r = is_a ? row : row - m_rows;
  const long long rows = is_a ? m_rows : n_rows;
  const float* src = (is_a ? a : b) + r * k_dim;
  float* hi = (is_a ? a_split : b_split) + r * k_pad;
  float* lo = hi + rows * k_pad;
  float s = 0.f;
  for (int c = lane; c < k_pad; c += 32) {
    const float x = c < k_dim ? __ldg(src + c) : 0.f;
    const float h = tf32_rna(x);
    hi[c] = h;
    lo[c] = x - h;  // exact: x and h share their exponent range
    s = fmaf(x, x, s);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) (is_a ? a_sq : b_sq)[r] = s;
}

// --- mbarrier, TMA and wgmma, as PTX -------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}\n" ::"r"(
          bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar)
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the phase of parity `parity` to complete.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > kWaitLimitCycles) __trap();
}

// One (kKBlock, rows, 2) box: hi then lo of `rows` rows from K value k.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int k, int row) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k), "r"(row),
      "r"(0)
      : "memory");
}

// A K-major operand in a 128-byte-swizzled stage: 8-row groups 1024
// bytes apart (the stride byte offset); the leading byte offset is not
// read for this layout.  A k8 step inside the swizzle row adds 32 bytes
// to the start address.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(kAlign >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(kPending)
               : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators
// across the asynchronous wgmma that owns them.
template <int kRegs>
__device__ __forceinline__ void fence_operands(float (&d)[kRegs]) {
#pragma unroll
  for (int i = 0; i < kRegs; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, fp32, the wgmma fragment) = A (64 x 8) . B (128 x 8)^T
// (+ d when scale_d), both TF32 from shared memory, K-major.
__device__ __forceinline__ void wgmma_tf32(float (&d)[kTileN / 2],
                                           uint64_t a, uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63},"
      " %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ float distance(float cross, float am, float bn) {
  float d = -2.0f * cross;
  d = d + am;
  d = d + bn;
  return d < 0.f ? 0.f : d;
}

__global__ void __launch_bounds__(kThreads, 1)
    l2sq_matrix_kernel(const __grid_constant__ CUtensorMap a_map,
                       const __grid_constant__ CUtensorMap b_map,
                       const __grid_constant__ CUtensorMap out_map,
                       const float* __restrict__ a_sq,
                       const float* __restrict__ b_sq,
                       float* __restrict__ out, int m_rows, int n_rows,
                       int k_blocks, int stages, int tma_out) {
  constexpr uint32_t kABytes = 2 * kTileM * kRowBytes;  // hi and lo
  constexpr uint32_t kBBytes = 2 * kTileN * kRowBytes;
  constexpr uint32_t kStage = kABytes + kBBytes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + kAlign - 1) & ~(kAlign - 1);
  const uint32_t full = base + stages * kStage;  // a barrier a stage
  const uint32_t empty = full + stages * 8;

  const int m_tiles = (m_rows + kTileM - 1) / kTileM;
  const int m0 = static_cast<int>(blockIdx.x % m_tiles) * kTileM;
  const int n0 = static_cast<int>(blockIdx.x / m_tiles) * kTileN;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // --- the producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      asm volatile("prefetch.tensormap [%0];" ::"l"(
                       reinterpret_cast<uint64_t>(&a_map))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];" ::"l"(
                       reinterpret_cast<uint64_t>(&b_map))
                   : "memory");
      for (int kb = 0; kb < k_blocks; ++kb) {
        const int s = kb % stages;
        // round 0 waits on parity 1: a fresh barrier passes it at once
        mbar_wait(empty + 8 * s, ((kb / stages) & 1) ^ 1);
        const uint32_t stage = base + s * kStage;
        mbar_expect_tx(full + 8 * s, kStage);
        tma_load(stage, &a_map, full + 8 * s, kb * kKBlock, m0);
        tma_load(stage + kABytes, &b_map, full + 8 * s, kb * kKBlock, n0);
      }
    }
  } else {
    // --- the consumers: rows 64 c .. 64 c + 63 of the tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int c = wg - 1;
    const int t = threadIdx.x - 128 * wg;
    float acc[kTileN / 2];   // the running sum, in rounded fp32 adds
    float part[kTileN / 2];  // one stage's products, from the tensor cores
#pragma unroll
    for (int i = 0; i < kTileN / 2; ++i) acc[i] = 0.f;
    for (int kb = 0; kb < k_blocks; ++kb) {
      const int s = kb % stages;
      mbar_wait(full + 8 * s, (kb / stages) & 1);
      const uint32_t a_hi = base + s * kStage + c * 64 * kRowBytes;
      const uint32_t a_lo = a_hi + kTileM * kRowBytes;
      const uint32_t b_hi = base + s * kStage + kABytes;
      const uint32_t b_lo = b_hi + kTileN * kRowBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKBlock / 8; ++kk) {
        const uint32_t off = kk * 32;  // 8 fp32 along the swizzle row
        wgmma_tf32(part, smem_desc(a_hi + off), smem_desc(b_hi + off),
                   kk > 0);  // the stage's first product overwrites
        wgmma_tf32(part, smem_desc(a_hi + off), smem_desc(b_lo + off), 1);
        wgmma_tf32(part, smem_desc(a_lo + off), smem_desc(b_hi + off), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(part);
      if ((t & 31) == 0) mbar_arrive(empty + 8 * s);
#pragma unroll
      for (int i = 0; i < kTileN / 2; ++i) acc[i] += part[i];
    }

    // The fragment: register 4 j + 2 i + e of thread t holds row
    // 16 (t / 32) + t % 32 / 4 + 8 i, column 8 j + 2 (t % 4) + e.
    if (tma_out) {
      // the spent ring's first 64 KB take the tile, as four swizzled
      // 32-column boxes, once both warpgroups are done reading it
      asm volatile("bar.sync 1, 256;" ::: "memory");
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = 64 * c + 16 * (t >> 5) + ((t & 31) >> 2) + 8 * i;
        const float am = m0 + r < m_rows ? a_sq[m0 + r] : 0.f;
#pragma unroll
        for (int j = 0; j < kTileN / 8; ++j) {
          const int n = n0 + 8 * j + 2 * (t & 3);
          const float b0 = n < n_rows ? b_sq[n] : 0.f;
          const float b1 = n + 1 < n_rows ? b_sq[n + 1] : 0.f;
          const float v0 = distance(acc[4 * j + 2 * i], am, b0);
          const float v1 = distance(acc[4 * j + 2 * i + 1], am, b1);
          const uint32_t chunk = (2 * (j & 3) + ((t & 3) >> 1)) ^ (r & 7);
          const uint32_t addr = base + (j >> 2) * (kTileM * kRowBytes) +
                                r * kRowBytes + chunk * 16 + 8 * (t & 1);
          asm volatile("st.shared.v2.f32 [%0], {%1, %2};" ::"r"(addr),
                       "f"(v0), "f"(v1)
                       : "memory");
        }
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile("bar.sync 1, 256;" ::: "memory");
      if (threadIdx.x == 128) {
#pragma unroll
        for (int q = 0; q < kTileN / kKBlock; ++q)
          asm volatile(
              "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
              " [%0, {%1, %2}], [%3];" ::"l"(
                  reinterpret_cast<uint64_t>(&out_map)),
              "r"(n0 + kKBlock * q), "r"(m0),
              "r"(base + q * kTileM * kRowBytes)
              : "memory");
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      }
      return;
    }
    // N % 4 != 0: each thread stores its fragment
    const int row0 = m0 + 64 * c + 16 * (t >> 5) + ((t & 31) >> 2);
    const int col0 = n0 + 2 * (t & 3);
    const bool pairs = (n_rows & 1) == 0;  // then float2 stores line up
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = row0 + 8 * i;
      if (m >= m_rows) continue;
      const float am = a_sq[m];
      float* orow = out + static_cast<long long>(m) * n_rows;
#pragma unroll
      for (int j = 0; j < kTileN / 8; ++j) {
        const int n = col0 + 8 * j;
        if (n >= n_rows) continue;
        const float v0 = distance(acc[4 * j + 2 * i], am, b_sq[n]);
        if (n + 1 >= n_rows) {
          orow[n] = v0;
          continue;
        }
        const float v1 = distance(acc[4 * j + 2 * i + 1], am, b_sq[n + 1]);
        if (pairs) {
          *reinterpret_cast<float2*>(orow + n) = make_float2(v0, v1);
        } else {
          orow[n] = v0;
          orow[n + 1] = v1;
        }
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, looked up once through the runtime.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) {
      cudaGetLastError();
      p = nullptr;
    }
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The (2, rows, k_pad) split scratch as a 3-D map (k, row, hi|lo), boxes
// of (kKBlock, box_rows, 2), 128-byte swizzle, zeros out of bounds.
bool encode_split_map(CUtensorMap* map, const void* split, int rows,
                      int k_pad, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(k_pad),
                              static_cast<cuuint64_t>(rows), 2};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(k_pad) * 4,
      static_cast<cuuint64_t>(rows) * static_cast<cuuint64_t>(k_pad) * 4};
  const cuuint32_t box[3] = {kKBlock, static_cast<cuuint32_t>(box_rows), 2};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                const_cast<void*>(split), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// out (m_rows, n_rows) as a 2-D map, boxes of 32 columns x kTileM rows in
// the 128-byte swizzle: a row's stride must be a multiple of 16 bytes.
bool encode_out_map(CUtensorMap* map, void* out, int m_rows, int n_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(n_rows),
                              static_cast<cuuint64_t>(m_rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(n_rows) * 4};
  const cuuint32_t box[2] = {kKBlock, kTileM};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, out, dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// a (m_rows, k_dim), b (n_rows, k_dim) f32 row-major, any alignment;
// a_split (2, m_rows, k_pad), b_split (2, n_rows, k_pad), a_sq (m_rows,),
// b_sq (n_rows,) f32 outputs; k_pad >= k_dim, a multiple of 32.
extern "C" int repro_l2sq_split(const void* a, const void* b, void* a_split,
                                void* b_split, void* a_sq, void* b_sq,
                                int m_rows, int n_rows, int k_dim, int k_pad,
                                int device, void* stream) {
  cudaError_t err = select_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(m_rows) + n_rows;
  const long long warps = kSplitThreads / 32;
  note_launch(l2sq_split_kernel, 0);
  l2sq_split_kernel<<<static_cast<unsigned>((rows + warps - 1) / warps),
                      kSplitThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), m_rows,
      n_rows, k_dim, k_pad, static_cast<float*>(a_split),
      static_cast<float*>(b_split), static_cast<float*>(a_sq),
      static_cast<float*>(b_sq));
  return launch_status();
}

// The split pass's outputs in; out (m_rows, n_rows) f32.  stages (>= 2)
// and smem (the dynamic shared memory, 1 KB of alignment slack included)
// come from tuning.matrix_plan.
extern "C" int repro_l2sq_matrix(const void* a_split, const void* b_split,
                                 const void* a_sq, const void* b_sq,
                                 void* out, int m_rows, int n_rows, int k_pad,
                                 int stages, int smem, int device,
                                 void* stream) {
  cudaError_t err = select_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (stages < 2 || k_pad <= 0 || k_pad % kKBlock)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap a_map, b_map, out_map = {};
  const int tma_out = n_rows % 4 == 0;
  if (!encode_split_map(&a_map, a_split, m_rows, k_pad, kTileM) ||
      !encode_split_map(&b_map, b_split, n_rows, k_pad, kTileN) ||
      (tma_out && !encode_out_map(&out_map, out, m_rows, n_rows)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles =
      static_cast<long long>((m_rows + kTileM - 1) / kTileM) *
      ((n_rows + kTileN - 1) / kTileN);
  if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  note_launch(l2sq_matrix_kernel, static_cast<size_t>(smem));
  err = cudaFuncSetAttribute(l2sq_matrix_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  l2sq_matrix_kernel<<<static_cast<unsigned>(tiles), kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      a_map, b_map, out_map, static_cast<const float*>(a_sq),
      static_cast<const float*>(b_sq), static_cast<float*>(out), m_rows,
      n_rows, k_pad / kKBlock, stages, tma_out);
  return launch_status();
}
