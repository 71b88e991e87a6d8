// Squared L2 distance of one query to many reference rows (paper:
// L2SqrDistance, the RVV vfsub / vfmacc / vfredsum loop):
//   out[n] = sum_k (refs[n, k] - q[k])^2
//
// Replaces the TPU kernel src/repro/kernels/l2dist.py:l2sq_rowwise
// (_l2_rowwise_kernel).  The TPU kernel tiles (refs, K chunks) and carries
// each row's partial sum over the K chunks from one serial grid step to
// the next in its output block.  Nothing carries over between Hopper's
// blocks, so a warp owns its rows outright and walks all of K itself.
//
// What bounds it on an H100: bytes.  Each reference value is read once
// and feeds one subtract and one fused multiply-add: 2 operations per 4
// bytes, far below the card's ~20 fp32 operations per byte of HBM.  At
// the kNN path's shape (2,808 references of K = 512) a call reads 5.75 MB,
// 1.72 us at 3.35 TB/s: one trip to memory's latency is about half of it,
// so the design puts every byte of the call in flight at once.
//   * q lives in registers.  Lane l needs the same columns of q for every
//     row (float4s l, l + 32, ...), so it loads them once with __ldg, in
//     the same burst as its first rows: no shared copy, no barrier before
//     the first row load, and no cap on K.
//   * A warp takes a row and holds J chunks of 128 columns of it (a
//     float4 a lane a chunk): its J row loads are unrolled and issued
//     before the first multiply-add.  tuning.rowwise_plan picks the warps
//     a block so the blocks deal out evenly over the SMs in one wave
//     (2,808 x 512: J = 4, 2,808 warps, about 43 KB in flight an SM); past
//     one wave its blocks stride over the rows.  (Two and four rows a
//     warp were measured slower at 2,808 x 512 and are not built.)
//   * Past 8 chunks (K > 1,024) the warp walks K in passes of 8 chunks and
//     takes q's chunk again from L1 each pass (the walk route).
//   * Where float4 loads cannot go (K % 4 != 0, or a row or q not 16-byte
//     aligned) a masked scalar route takes a row a warp.
//   * One summation order on every route: lane l sums columns 4i .. 4i + 3
//     for i = l, l + 32, l + 64, ... in that order with fmaf, and the warp
//     reduces the 32 partials with a fixed __shfl_xor_sync butterfly.  So
//     two launches on the same inputs give the same bits, and so do the
//     routes (ref.l2sq_rowwise_lanes is this order in plain PyTorch).
//   * A block's sums leave as one contiguous store (through shared memory
//     when the block has more than one warp).
//   * Rows past N and columns past K are masked here: nothing is padded.
#include "common.cuh"

namespace {

constexpr int kMaxWarps = 8;      // warps a block, at most
constexpr int kChunk = 32;        // float4s a chunk: one a lane, 128 columns
constexpr int kRegisters = 0, kWalk = 1, kScalar = 2;  // tuning.ROWWISE_ROUTES

__device__ __forceinline__ float sq_diff4(float acc, float4 r, float4 q) {
  float d = r.x - q.x;
  acc = fmaf(d, d, acc);
  d = r.y - q.y;
  acc = fmaf(d, d, acc);
  d = r.z - q.z;
  acc = fmaf(d, d, acc);
  d = r.w - q.w;
  return fmaf(d, d, acc);
}

__device__ __forceinline__ float warp_sum(float acc) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, offset);
  return acc;
}

// Every load below reads a valid address: a float4 past k4 reads float4
// k4 - 1 and a row past n_rows the last row.  Masking by address, not by
// branch, leaves no load in a conditional block of its own, so the
// compiler can issue them all at once; the values past k4 are then set to
// zero (their squares add nothing) and the sums of rows past n_rows are
// never stored.

// q's float4s at + 32 j (j < J), zero past k4.
template <int J>
__device__ __forceinline__ void load_q(float4 (&qv)[J],
                                       const float4* __restrict__ q4, int at,
                                       int k4) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int i = at + kChunk * j;
    qv[j] = __ldg(q4 + (i < k4 ? i : k4 - 1));
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    if (at + kChunk * j >= k4) qv[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Row `row` at float4s at + 32 j: all J loads are issued before the
// first multiply-add.
template <int J>
__device__ __forceinline__ float accumulate(float acc,
                                            const float4 (&qv)[J],
                                            const float4* __restrict__ refs4,
                                            long long row, long long n_rows,
                                            int at, int k4) {
  if (row >= n_rows) row = n_rows - 1;
  float4 rv[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int i = at + kChunk * j;
    rv[j] = __ldg(refs4 + row * k4 + (i < k4 ? i : k4 - 1));
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    if (at + kChunk * j >= k4) rv[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    acc = sq_diff4(acc, rv[j], qv[j]);
  }
  return acc;
}

// The block's sums, rows base .. base + warps - 1, as one contiguous
// store; every lane holds its warp's sum after the butterfly.
__device__ __forceinline__ void store_sums(float sum, float* sums_s,
                                           float* __restrict__ out,
                                           long long base, long long n_rows) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  if (warps == 1) {
    if (lane == 0 && base < n_rows) out[base] = sum;
    return;
  }
  if (lane == 0) sums_s[warp] = sum;
  __syncthreads();
  const int t = threadIdx.x;
  if (t < warps && base + t < n_rows) out[base + t] = sums_s[t];
  __syncthreads();  // the next tile writes sums_s again
}

// The registers route (kStride false: q's J chunks cover K and stay in
// registers for every row) and the walk route (kStride true: passes of J
// chunks, q's chunk loaded again each pass).
template <int J, bool kStride>
__global__ void __launch_bounds__(kMaxWarps * 32)
    l2sq_rowwise_kernel(const float4* __restrict__ q4,
                        const float4* __restrict__ refs4,
                        float* __restrict__ out, long long n_rows, int k4) {
  __shared__ float sums_s[kMaxWarps];
  const int lane = threadIdx.x & 31;
  const long long tile = blockDim.x >> 5;
  float4 qv[J];
  if (!kStride) load_q<J>(qv, q4, lane, k4);
  for (long long base = blockIdx.x * tile; base < n_rows;
       base += static_cast<long long>(gridDim.x) * tile) {
    const long long row = base + (threadIdx.x >> 5);
    float acc = 0.f;
    if (kStride) {
      for (int at = lane; at < k4; at += kChunk * J) {
        load_q<J>(qv, q4, at, k4);
        acc = accumulate<J>(acc, qv, refs4, row, n_rows, at, k4);
      }
    } else {
      acc = accumulate<J>(acc, qv, refs4, row, n_rows, lane, k4);
    }
    store_sums(warp_sum(acc), sums_s, out, base, n_rows);
  }
}

// The scalar route: a row a warp, scalar loads, the same summation order.
__global__ void __launch_bounds__(kMaxWarps * 32)
    l2sq_rowwise_scalar_kernel(const float* __restrict__ q,
                               const float* __restrict__ refs,
                               float* __restrict__ out, long long n_rows,
                               int k_dim) {
  __shared__ float sums_s[kMaxWarps];
  const int lane = threadIdx.x & 31;
  const long long tile = blockDim.x >> 5;
  for (long long base = blockIdx.x * tile; base < n_rows;
       base += static_cast<long long>(gridDim.x) * tile) {
    const long long r = base + (threadIdx.x >> 5);
    float acc = 0.f;
    if (r < n_rows) {
      const float* row = refs + r * k_dim;
      for (int c0 = 4 * lane; c0 < k_dim; c0 += 4 * kChunk) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int c = c0 + u;
          if (c < k_dim) {
            const float d = __ldg(row + c) - __ldg(q + c);
            acc = fmaf(d, d, acc);
          }
        }
      }
    }
    store_sums(warp_sum(acc), sums_s, out, base, n_rows);
  }
}

using VecLaunch = void (*)(dim3, dim3, cudaStream_t, const float4*,
                           const float4*, float*, long long, int);

template <int J, bool kStride>
void launch_vec(dim3 grid, dim3 block, cudaStream_t s, const float4* q4,
                const float4* refs4, float* out, long long n_rows, int k4) {
  note_launch(l2sq_rowwise_kernel<J, kStride>, 0);
  l2sq_rowwise_kernel<J, kStride><<<grid, block, 0, s>>>(q4, refs4, out,
                                                         n_rows, k4);
}

// The instantiations tuning.rowwise_plan may ask for (the registers route
// at J = 1, 2, 4, 8; the walk route at J = 8), or nullptr.
VecLaunch pick(int route, int chunks) {
  if (route == kWalk) return chunks == 8 ? launch_vec<8, true> : nullptr;
  switch (chunks) {
    case 1: return launch_vec<1, false>;
    case 2: return launch_vec<2, false>;
    case 4: return launch_vec<4, false>;
    case 8: return launch_vec<8, false>;
    default: return nullptr;
  }
}

}  // namespace

// q (k_dim,) f32; refs (n_rows, k_dim) f32 row-major; out (n_rows,) f32.
// The plan (tuning.rowwise_plan): route 0 registers, 1 walk, 2 scalar;
// chunks J; warps a block; blocks.  The registers and walk routes take
// k_dim % 4 == 0 and a 16-byte aligned q and refs (the caller's
// guarantee).  A J the kernel has no instance for, or a registers route
// whose J chunks do not cover K, comes back as cudaErrorInvalidValue.
extern "C" int repro_l2sq_rowwise(const void* q, const void* refs, void* out,
                                  long long n_rows, int k_dim, int route,
                                  int chunks, int warps, int blocks,
                                  int device, void* stream) {
  cudaError_t err = select_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (warps < 1 || warps > kMaxWarps || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  const dim3 block(static_cast<unsigned>(warps * 32));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* op = static_cast<float*>(out);
  if (route == kScalar) {
    note_launch(l2sq_rowwise_scalar_kernel, 0);
    l2sq_rowwise_scalar_kernel<<<grid, block, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(refs), op,
        n_rows, k_dim);
    return launch_status();
  }
  const VecLaunch launch =
      route == kRegisters || route == kWalk
          ? pick(route, chunks)
          : nullptr;
  if (launch == nullptr ||
      (route == kRegisters && k_dim / 4 > kChunk * chunks))
    return static_cast<int>(cudaErrorInvalidValue);
  launch(grid, block, s, static_cast<const float4*>(q),
         static_cast<const float4*>(refs), op, n_rows, k_dim / 4);
  return launch_status();
}
