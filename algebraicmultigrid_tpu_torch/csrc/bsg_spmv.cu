// K6: y = A x over a BSG operator (Hopper, sm_90a).
//
// Replaces the Pallas TPU kernel _bsg_kernel of the JAX package's
// ops/bsg.py (via _bsg_spmv_call / bsg_spmv).  The operator stores, per
// 1024-row tile t and ELL slot k, a [8, 128] plane of coefficients and of
// window offsets, so that
//
//   y[t*1024 + u*128 + j] = sum_k data[t,k,u,j] * x[m0[t]*128 + off[t,k,u,j]]
//
// accumulated in float32 in slot order k = 0..K-1 (padding slots hold
// data 0 and off 0).
//
// What bounds it on the card: bytes.  Each slot moves 8 bytes of
// coefficient and offset for 2 flops, and x and y once each; at the RCM'd
// scrambled 1024^2 Poisson level (K = 5) that is ~50 MB, 15 us at
// 3.35 TB/s.
//
// Design.  The TPU kernel sweeps the tile's window block by block with a
// vreg-local lane shuffle, because the TPU has no fast general gather.  The
// card has one: a thread per row reads x[m0*128 + off] directly, through the
// read-only cache, and the (t, k) planes are 1024 contiguous words, so the
// coefficient and offset loads of a warp coalesce.  The TPU kernel's x
// operand carries ws guard blocks of zeros after the last window; here a
// gather index at or past the x operand's length reads 0 instead, which is
// the same function without the padded copy.
//
// The entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() for the wrapper to check.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 1024;
constexpr int kThreads = 256;
constexpr int kBlocksPerTile = kTile / kThreads;

__global__ void __launch_bounds__(kThreads)
    bsg_spmv_kernel(float* __restrict__ y, const float* __restrict__ data,
                    const int* __restrict__ off, const int* __restrict__ m0,
                    const float* __restrict__ x, long long nx, int K,
                    long long rows) {
  const long long t = blockIdx.x / kBlocksPerTile;
  const int r = (blockIdx.x % kBlocksPerTile) * kThreads + threadIdx.x;
  const long long row = t * kTile + r;
  if (row >= rows) return;
  const long long base = static_cast<long long>(m0[t]) * 128;
  const float* d = data + t * K * kTile + r;
  const int* o = off + t * K * kTile + r;
  float acc = 0.0f;
  for (int k = 0; k < K; ++k) {
    const long long idx = base + o[static_cast<long long>(k) * kTile];
    const float v = idx < nx ? __ldg(x + idx) : 0.0f;
    acc += d[static_cast<long long>(k) * kTile] * v;
  }
  y[row] = acc;
}

}  // namespace

// y[rows] from data/off [T, K, 8, 128], m0 [T] and x [nx]; rows <= T*1024.
extern "C" int amg_bsg_spmv_f32(void* y, const void* data, const void* off,
                                const void* m0, const void* x, long long nx,
                                int T, int K, long long rows, void* stream) {
  if (T > 0 && rows > 0) {
    bsg_spmv_kernel<<<T * kBlocksPerTile, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<float*>(y), static_cast<const float*>(data),
        static_cast<const int*>(off), static_cast<const int*>(m0),
        static_cast<const float*>(x), nx, K, rows);
  }
  return static_cast<int>(cudaGetLastError());
}
