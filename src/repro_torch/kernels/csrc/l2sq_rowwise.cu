// Squared L2 distance of one query to many reference rows (paper:
// L2SqrDistance, the RVV vfsub / vfmacc / vfredsum loop):
//   out[n] = sum_k (refs[n, k] - q[k])^2
//
// Replaces the TPU kernel src/repro/kernels/l2dist.py:l2sq_rowwise
// (_l2_rowwise_kernel).  The TPU kernel tiles (refs, K chunks) and carries
// each row's partial sum over the K chunks from one serial grid step to
// the next in its output block.  Nothing carries over between Hopper's
// blocks, so a warp owns a row outright and loops over all of K itself.
//
// What bounds it on an H100: bytes.  Each reference value is read once
// and feeds one subtract and one fused multiply-add: 2 operations per 4
// bytes, far below the card's ~20 fp32 operations per byte of HBM.  At
// the kNN path's shape (2,808 references of K = 512) a call reads 5.75 MB,
// 1.72 us at 3.35 TB/s.  The design keeps the loads wide and coalesced:
//   * q is staged once a block in shared memory;
//   * one warp a reference row, grid-stride over the rows; with K % 4 == 0
//     and 16-byte aligned rows each lane reads float4s, so a warp reads
//     512 contiguous bytes a step; otherwise it reads scalars;
//   * each lane sums its columns in a fixed order with fmaf, and the warp
//     reduces the 32 partials with a fixed __shfl_xor_sync butterfly, so
//     two launches on the same inputs give the same bits;
//   * ragged N and K are masked here: nothing is padded.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;             // threads a block
constexpr int kWarps = kThreads / 32;     // reference rows a block at a time
constexpr int kMaxBlocks = 132 * 16;      // the grid-stride cap: 16 an SM

__device__ inline float sq_diff4(float acc, float4 r, float4 q) {
  float d = r.x - q.x;
  acc = fmaf(d, d, acc);
  d = r.y - q.y;
  acc = fmaf(d, d, acc);
  d = r.z - q.z;
  acc = fmaf(d, d, acc);
  d = r.w - q.w;
  return fmaf(d, d, acc);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    l2sq_rowwise_kernel(const float* __restrict__ q,
                        const float* __restrict__ refs,
                        float* __restrict__ out, long long n_rows,
                        int k_dim) {
  extern __shared__ float4 q_s4[];
  float* q_s = reinterpret_cast<float*>(q_s4);
  for (int k = threadIdx.x; k < k_dim; k += kThreads) q_s[k] = q[k];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const long long first =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const long long step = static_cast<long long>(gridDim.x) * kWarps;
  for (long long r = first; r < n_rows; r += step) {
    const float* row = refs + r * k_dim;
    float acc = 0.0f;
    if (kVec) {
      const float4* row4 = reinterpret_cast<const float4*>(row);
      const int k4 = k_dim >> 2;
      for (int i = lane; i < k4; i += 32)
        acc = sq_diff4(acc, __ldg(row4 + i), q_s4[i]);
    } else {
      for (int k = lane; k < k_dim; k += 32) {
        const float d = __ldg(row + k) - q_s[k];
        acc = fmaf(d, d, acc);
      }
    }
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, offset);
    if (lane == 0) out[r] = acc;
  }
}

// Past the 48 KB a block gets by default, the block opts in first; a
// refused opt-in comes back as the launch's status.
template <bool kVec>
void launch(dim3 grid, size_t smem, cudaStream_t s, const float* q,
            const float* refs, float* out, long long n_rows, int k_dim) {
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(l2sq_rowwise_kernel<kVec>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess)
    return;
  l2sq_rowwise_kernel<kVec><<<grid, kThreads, smem, s>>>(q, refs, out, n_rows,
                                                         k_dim);
}

}  // namespace

// q (k_dim,) f32; refs (n_rows, k_dim) f32 row-major; out (n_rows,) f32.
// vec: the caller guarantees k_dim % 4 == 0 and a 16-byte aligned refs.
// q takes k_dim * 4 bytes of dynamic shared memory; past 48 KB the block
// opts in (the caller keeps it within the 227 KB a block may take).
extern "C" int repro_l2sq_rowwise(const void* q, const void* refs, void* out,
                                  long long n_rows, int k_dim, int vec,
                                  int device, void* stream) {
  cudaError_t err = select_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = ((static_cast<size_t>(k_dim) + 3) / 4) * sizeof(float4);
  const long long blocks = (n_rows + kWarps - 1) / kWarps;
  const dim3 grid(static_cast<unsigned>(
      blocks < kMaxBlocks ? blocks : kMaxBlocks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qp = static_cast<const float*>(q);
  const float* rp = static_cast<const float*>(refs);
  float* op = static_cast<float*>(out);
  if (vec) {
    launch<true>(grid, smem, s, qp, rp, op, n_rows, k_dim);
  } else {
    launch<false>(grid, smem, s, qp, rp, op, n_rows, k_dim);
  }
  return launch_status();
}
