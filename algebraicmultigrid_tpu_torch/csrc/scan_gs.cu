// Natural-order Gauss-Seidel / SOR sweeps on a small ELL level (Hopper,
// sm_90a).
//
// Not the port of a Pallas kernel: it replaces the JAX package's XLA
// lax.scan recurrence _scan_sweep (models/device.py), which levels of at
// most 2048 rows run for natural-order GS/SOR.  Each row update is
//
//   rsum = sum_w data[i,w] * x[cols[i,w]] - d_i * x_i
//   x_i  = d_i == 0 ? x_i : (1 - w) x_i + w (b_i - rsum) / d_i
//
// in row order (forward) or reverse row order (backward), every update
// seeing the ones before it: an exact sequential recurrence.
//
// What bounds it on the card: latency.  The level is a few hundred rows of
// a few dozen slots (kilobytes), but every row waits for the one before it,
// so the time is rows x (one warp reduction + a shared-memory round trip).
//
// Design.  One block of one warp runs the whole smoother application (every
// iteration, forward and backward sweeps) in one launch: x lives in shared
// memory for the launch, the warp's lanes stride over a row's ELL slots,
// a butterfly of shuffles sums them, and lane 0 writes the new x_i before
// the warp moves on.  In a torch row loop the same work would be thousands
// of launches per V-cycle.
//
// The entry points launch on the caller's stream, allocate nothing and
// return cudaGetLastError() for the wrapper to check.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  return v;
}

template <typename T>
__device__ __forceinline__ void row_update(T* xs, int i, const T* __restrict__ b,
                                           const T* __restrict__ data,
                                           const long long* __restrict__ cols,
                                           const T* __restrict__ diag, int width,
                                           T omega) {
  const int lane = threadIdx.x;
  const long long base = static_cast<long long>(i) * width;
  T s = 0;
  for (int w = lane; w < width; w += 32) s += data[base + w] * xs[cols[base + w]];
  s = warp_sum(s);
  if (lane == 0) {
    const T d = diag[i];
    const T xi = xs[i];
    const T rsum = s - d * xi;
    const T cand = (T(1) - omega) * xi + omega * (b[i] - rsum) / (d == T(0) ? T(1) : d);
    xs[i] = d == T(0) ? xi : cand;
  }
  __syncwarp();
}

template <typename T>
__global__ void __launch_bounds__(32)
    scan_gs_kernel(T* __restrict__ x_out, const T* __restrict__ x_in,
                   const T* __restrict__ b, const T* __restrict__ data,
                   const long long* __restrict__ cols, const T* __restrict__ diag,
                   int rows, int width, T omega, int iters, int forward,
                   int backward) {
  extern __shared__ unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  for (int i = threadIdx.x; i < rows; i += 32) xs[i] = x_in[i];
  __syncwarp();
  for (int it = 0; it < iters; ++it) {
    if (forward)
      for (int i = 0; i < rows; ++i) row_update(xs, i, b, data, cols, diag, width, omega);
    if (backward)
      for (int i = rows - 1; i >= 0; --i) row_update(xs, i, b, data, cols, diag, width, omega);
  }
  for (int i = threadIdx.x; i < rows; i += 32) x_out[i] = xs[i];
}

template <typename T>
int scan_gs(void* x_out, const void* x_in, const void* b, const void* data,
            const void* cols, const void* diag, int rows, int width,
            double omega, int iters, int forward, int backward, void* stream) {
  const size_t smem = static_cast<size_t>(rows) * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        scan_gs_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (rows > 0) {
    scan_gs_kernel<T><<<1, 32, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<T*>(x_out), static_cast<const T*>(x_in),
        static_cast<const T*>(b), static_cast<const T*>(data),
        static_cast<const long long*>(cols), static_cast<const T*>(diag), rows,
        width, static_cast<T>(omega), iters, forward, backward);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x_out[rows] = the smoother applied to x_in[rows] with rhs b: `iters`
// times a forward and/or backward sweep over ELL data/cols [rows, width]
// (cols int64, every column < rows) with diagonal diag[rows].
#define AMG_SCAN_GS_ENTRY(T, SUFFIX)                                           \
  extern "C" int amg_scan_gs_##SUFFIX(                                         \
      void* x_out, const void* x_in, const void* b, const void* data,          \
      const void* cols, const void* diag, int rows, int width, double omega,   \
      int iters, int forward, int backward, void* stream) {                    \
    return scan_gs<T>(x_out, x_in, b, data, cols, diag, rows, width, omega,    \
                      iters, forward, backward, stream);                       \
  }

AMG_SCAN_GS_ENTRY(float, f32)
AMG_SCAN_GS_ENTRY(double, f64)
