// Pairwise squared L2 distances (the kNN featurizer's batched form):
//   out[m, n] = max((-2 * sum_k a[m, k] b[n, k] + a_sq[m]) + b_sq[n], 0)
// with a_sq[m] = ||a[m]||^2 and b_sq[n] = ||b[n]||^2 computed by the caller.
//
// Replaces the TPU kernel src/repro/kernels/l2dist.py:l2sq_matrix
// (_l2_matrix_kernel).  The TPU kernel runs the cross term on the MXU,
// carries -2 * cross over the K blocks from one serial grid step to the
// next in its output tile, and at the last K block adds the norms and
// clamps.  Here a block owns a 128 x 128 output tile and loops over all of
// K itself, in the same order: the cross term summed over K, then -2 *
// cross + a_sq, then + b_sq, then the clamp.
//
// What bounds it on an H100: operations.  2 M N K flops against 4 (M + N)
// K + 4 M N bytes: at the test split (2,841 x 2,808, K = 512) 8.17 GFLOP
// against 43.5 MB, 0.122 ms at the 67 TFLOP/s of fp32 outside the tensor
// cores and 0.013 ms at 3.35 TB/s.  The product is computed in full fp32
// with FFMA: no TF32 mma / wgmma, so it is as exact as the plain version's
// float32 matmul.  The design is the classic register-blocked SGEMM:
//   * 256 threads a block, 128 x 128 outputs, an 8 x 8 micro-tile a thread
//     held in 64 registers: each k step loads 8 + 8 values from shared
//     memory for 64 FFMAs;
//   * K is walked in slabs of 8, staged in shared memory K-major (a slab of
//     a and one of b, each 8 x 128, rows padded to 132 floats so the
//     transposing stores fall in distinct banks), double-buffered: the next
//     slab is loaded into registers while the current one is multiplied,
//     with one barrier a slab;
//   * a thread's micro-tile is rows {4 ty + i, 64 + 4 ty + i} and columns
//     {4 tx + j, 64 + 4 tx + j}, so its shared-memory reads are float4s
//     that neighbouring lanes take from neighbouring addresses;
//   * with K % 4 == 0 and 16-byte aligned rows the slabs are loaded as
//     float4s, otherwise as masked scalars; ragged M, N and K are masked
//     here, nothing is padded;
//   * each output is one thread's fixed-order sum, so two launches give
//     the same bits.
#include "common.cuh"

namespace {

constexpr int kTile = 128;               // output rows and columns a block
constexpr int kSlab = 8;                 // K values a shared-memory slab
constexpr int kPad = kTile + 4;          // padded slab row, in floats
constexpr int kThreads = 256;            // 16 x 16 threads
constexpr int kMicro = 8;                // 8 x 8 outputs a thread

// One thread's share of a slab: 4 consecutive K values of one row of a
// (or b), loaded as a float4 when kVec.
template <bool kVec>
__device__ inline float4 load_slab(const float* __restrict__ src,
                                   int n_rows, int k_dim, int row, int k) {
  if (row >= n_rows) return make_float4(0.f, 0.f, 0.f, 0.f);
  const float* p = src + static_cast<long long>(row) * k_dim + k;
  if (kVec) {
    // k_dim % 4 == 0 and k % 4 == 0, so k < k_dim covers all four
    if (k < k_dim) return __ldg(reinterpret_cast<const float4*>(p));
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  return make_float4(k < k_dim ? __ldg(p) : 0.f,
                     k + 1 < k_dim ? __ldg(p + 1) : 0.f,
                     k + 2 < k_dim ? __ldg(p + 2) : 0.f,
                     k + 3 < k_dim ? __ldg(p + 3) : 0.f);
}

__device__ inline void store_slab(float (*slab)[kPad], int row, int kc,
                                  float4 v) {
  slab[kc + 0][row] = v.x;
  slab[kc + 1][row] = v.y;
  slab[kc + 2][row] = v.z;
  slab[kc + 3][row] = v.w;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    l2sq_matrix_kernel(const float* __restrict__ a,
                       const float* __restrict__ b,
                       const float* __restrict__ a_sq,
                       const float* __restrict__ b_sq,
                       float* __restrict__ out, int m_rows, int n_rows,
                       int k_dim) {
  __shared__ __align__(16) float a_s[2][kSlab][kPad];
  __shared__ __align__(16) float b_s[2][kSlab][kPad];

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int m0 = blockIdx.y * kTile;
  const int n0 = blockIdx.x * kTile;
  // the slab load: thread tid takes row tid / 2, K values 4 (tid % 2) + 0..3
  const int load_row = tid >> 1;
  const int load_k = (tid & 1) * 4;

  float acc[kMicro][kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i)
#pragma unroll
    for (int j = 0; j < kMicro; ++j) acc[i][j] = 0.f;

  const int n_slabs = (k_dim + kSlab - 1) / kSlab;
  float4 a_next = load_slab<kVec>(a, m_rows, k_dim, m0 + load_row, load_k);
  float4 b_next = load_slab<kVec>(b, n_rows, k_dim, n0 + load_row, load_k);
  store_slab(a_s[0], load_row, load_k, a_next);
  store_slab(b_s[0], load_row, load_k, b_next);
  __syncthreads();

  for (int t = 0; t < n_slabs; ++t) {
    const int cur = t & 1;
    if (t + 1 < n_slabs) {
      const int k = (t + 1) * kSlab + load_k;
      a_next = load_slab<kVec>(a, m_rows, k_dim, m0 + load_row, k);
      b_next = load_slab<kVec>(b, n_rows, k_dim, n0 + load_row, k);
    }
#pragma unroll
    for (int kk = 0; kk < kSlab; ++kk) {
      const float4 a_lo = *reinterpret_cast<const float4*>(&a_s[cur][kk][4 * ty]);
      const float4 a_hi =
          *reinterpret_cast<const float4*>(&a_s[cur][kk][64 + 4 * ty]);
      const float4 b_lo = *reinterpret_cast<const float4*>(&b_s[cur][kk][4 * tx]);
      const float4 b_hi =
          *reinterpret_cast<const float4*>(&b_s[cur][kk][64 + 4 * tx]);
      const float av[kMicro] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w,
                                a_hi.x, a_hi.y, a_hi.z, a_hi.w};
      const float bv[kMicro] = {b_lo.x, b_lo.y, b_lo.z, b_lo.w,
                                b_hi.x, b_hi.y, b_hi.z, b_hi.w};
#pragma unroll
      for (int i = 0; i < kMicro; ++i)
#pragma unroll
        for (int j = 0; j < kMicro; ++j)
          acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (t + 1 < n_slabs) {
      // buffer cur ^ 1 was last read in slab t - 1, before the barrier
      store_slab(a_s[cur ^ 1], load_row, load_k, a_next);
      store_slab(b_s[cur ^ 1], load_row, load_k, b_next);
    }
    __syncthreads();
  }

  // epilogue, in the TPU kernel's order; v < 0 ? 0 : v keeps a NaN, as
  // jnp.maximum and torch.clamp_min do
  const bool vec_out = (n_rows & 3) == 0;
#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    const int m = m0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (m >= m_rows) continue;
    const float am = a_sq[m];
    float* orow = out + static_cast<long long>(m) * n_rows;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = n0 + half * 64 + 4 * tx;
      if (n >= n_rows) continue;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int nj = n + j < n_rows ? n + j : n;
        float d = -2.0f * acc[i][half * 4 + j];
        d = d + am;
        d = d + b_sq[nj];
        v[j] = d < 0.f ? 0.f : d;
      }
      if (vec_out) {
        // n_rows % 4 == 0 and n % 4 == 0: all four are in range
        *reinterpret_cast<float4*>(orow + n) =
            make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < n_rows) orow[n + j] = v[j];
      }
    }
  }
}

}  // namespace

// a (m_rows, k_dim), b (n_rows, k_dim) f32 row-major; a_sq (m_rows,),
// b_sq (n_rows,) f32; out (m_rows, n_rows) f32, 16-byte aligned.  vec: the
// caller guarantees k_dim % 4 == 0 and 16-byte aligned a and b.
extern "C" int repro_l2sq_matrix(const void* a, const void* b,
                                 const void* a_sq, const void* b_sq,
                                 void* out, int m_rows, int n_rows, int k_dim,
                                 int vec, int device, void* stream) {
  cudaError_t err = select_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((n_rows + kTile - 1) / kTile),
                  static_cast<unsigned>((m_rows + kTile - 1) / kTile));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ap = static_cast<const float*>(a);
  const float* bp = static_cast<const float*>(b);
  const float* asp = static_cast<const float*>(a_sq);
  const float* bsp = static_cast<const float*>(b_sq);
  float* op = static_cast<float*>(out);
  if (vec) {
    l2sq_matrix_kernel<true><<<grid, kThreads, 0, s>>>(
        ap, bp, asp, bsp, op, m_rows, n_rows, k_dim);
  } else {
    l2sq_matrix_kernel<false><<<grid, kThreads, 0, s>>>(
        ap, bp, asp, bsp, op, m_rows, n_rows, k_dim);
  }
  return launch_status();
}
