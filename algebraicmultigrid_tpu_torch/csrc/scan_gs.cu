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
// a few dozen slots (tens of kilobytes), but every row waits for the one
// before it, so the time is rows x the chain's latency per row.
//
// Design.  One block runs the whole smoother application (every iteration,
// forward and backward sweeps) in one launch, and shortens the chain:
//
// * The lowering splits each row's off-diagonal slots into those left of
//   the diagonal (cols < i) and those right of it (cols > i), column-major
//   [w][rows] with 16-bit columns (ops/kernels/scan_gs.py), and keeps
//   dshift_i = a_ii - d_i.
// * Staged route: the launch loads both halves, x, b and 1/d into shared
//   memory, all in flight, once.  Streamed route (a level whose halves do
//   not fit): the halves stay in device memory, and the chain's lanes
//   fetch row i+1's slots while row i reduces.
// * At the start of a sweep the whole block computes, for every row at
//   once, the part of its sum that the sweep will not have updated when it
//   reaches the row (forward: the right half and the diagonal; backward:
//   the left half and the diagonal), folded into
//     e_i = alpha_i x_i + beta_i (b_i - part_i),
//   alpha_i = 1 - w and beta_i = w / d_i (1 and 0 on a frozen row).
// * The chain then runs row by row over the other half only:
//     x_i = e_i - beta_i * sum_{w in half} data * x[col],
//   in the kChainLanes = 32 lanes of a warp: lane l holds the slots l,
//   l + 32, ... of a row, fetched a row ahead, and a shuffle reduction
//   sums them.  What lost (kernel_variants.py scan, PERF.md): the chain in
//   one thread, and in 8 or 16 lanes; the variants edit kChainLanes.
//
// The summation order differs from the plain version's (the tolerances
// hold it); the recurrence is exact.
//
// The entry points launch on the caller's stream, allocate nothing and
// return cudaGetLastError() for the wrapper to check.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kScanThreads = 256;

template <typename T>
struct ScanArgs {
  T* x_out;
  const T* x_in;
  const T* b;
  const T* lo_data;   // [w_lo][rows], cols < i
  const short* lo_cols;
  const T* up_data;   // [w_up][rows], cols > i
  const short* up_cols;
  const T* dshift;    // a_ii - d_i
  const T* diag;
  int rows, w_lo, w_up;
  T omega;
  int iters, forward, backward;
};

// e_i of every row from the half the sweep has not updated when it gets
// there (hd/hc, in shared or device memory)
template <typename T>
__device__ void sweep_parts(const ScanArgs<T>& a, const T* __restrict__ hd,
                            const short* __restrict__ hc, int w, const T* xs,
                            const T* bs, const T* al, const T* be,
                            const T* ds, T* es) {
  for (int i = threadIdx.x; i < a.rows; i += blockDim.x) {
    T part = ds[i] * xs[i];
    for (int k = 0; k < w; ++k) part += hd[k * a.rows + i] * xs[hc[k * a.rows + i]];
    es[i] = al[i] * xs[i] + be[i] * (bs[i] - part);
  }
}

// the chain's lanes of warp 0
constexpr int kChainLanes = 32;

// the chain in kChainLanes lanes of warp 0 (the half in shared or device
// memory): lane l holds the slots l, l + LANES, ... (32 / LANES of them in
// registers, fetched a row ahead; a loop past 32), a shuffle reduction of
// log2(LANES) steps
template <typename T>
__device__ void warp_chain(const ScanArgs<T>& a, const T* __restrict__ hd,
                           const short* __restrict__ hc, int w, T* xs,
                           const T* be, const T* es, int i0, int step) {
  constexpr int LANES = kChainLanes;
  constexpr int J = 32 / LANES;
  const int lane = threadIdx.x;
  if (lane >= 32) return;
  const int R = a.rows;
  T dn[J];
  int cn[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int k = lane + j * LANES;
    const bool mine = lane < LANES && k < w;
    dn[j] = mine ? hd[(int64_t)k * R + i0] : T(0);
    cn[j] = mine ? hc[(int64_t)k * R + i0] : 0;
  }
  for (int n = 0, i = i0; n < R; ++n, i += step) {
    T d[J];
    int c[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      d[j] = dn[j];
      c[j] = cn[j];
    }
    const T e = es[i], bi = be[i];
    T s = T(0);
#pragma unroll
    for (int j = 0; j < J; ++j) s += d[j] * xs[c[j]];
    if (n + 1 < R) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int k = lane + j * LANES;
        if (lane < LANES && k < w) {
          dn[j] = hd[(int64_t)k * R + i + step];
          cn[j] = hc[(int64_t)k * R + i + step];
        }
      }
    }
    if (lane < LANES) {
      for (int k = lane + 32; k < w; k += LANES) s += hd[(int64_t)k * R + i] * xs[hc[(int64_t)k * R + i]];
    }
#pragma unroll
    for (int o = LANES / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) xs[i] = e - bi * s;
    __syncwarp();
  }
}

template <typename T, bool STAGED>
__global__ void __launch_bounds__(kScanThreads) scan_gs_kernel(const ScanArgs<T> a) {
  extern __shared__ __align__(16) unsigned char scan_smem[];
  const int R = a.rows;
  T* xs = reinterpret_cast<T*>(scan_smem);
  T* bs = xs + R;
  T* al = bs + R;
  T* be = al + R;
  T* ds = be + R;
  T* es = ds + R;
  T* lod = es + R;
  T* upd = lod + (STAGED ? a.w_lo * R : 0);
  short* loc = reinterpret_cast<short*>(upd + (STAGED ? a.w_up * R : 0));
  short* upc = loc + (STAGED ? a.w_lo * R : 0);

  const T omega = a.omega;
  for (int i = threadIdx.x; i < R; i += blockDim.x) {
    const T d = a.diag[i];
    xs[i] = a.x_in[i];
    bs[i] = a.b[i];
    ds[i] = a.dshift[i];
    al[i] = d == T(0) ? T(1) : T(1) - omega;
    be[i] = d == T(0) ? T(0) : omega / d;
  }
  if (STAGED) {
    for (int j = threadIdx.x; j < a.w_lo * R; j += blockDim.x) {
      lod[j] = a.lo_data[j];
      loc[j] = a.lo_cols[j];
    }
    for (int j = threadIdx.x; j < a.w_up * R; j += blockDim.x) {
      upd[j] = a.up_data[j];
      upc[j] = a.up_cols[j];
    }
  } else {
    lod = const_cast<T*>(a.lo_data);
    upd = const_cast<T*>(a.up_data);
    loc = const_cast<short*>(a.lo_cols);
    upc = const_cast<short*>(a.up_cols);
  }
  __syncthreads();

  for (int it = 0; it < a.iters; ++it) {
    for (int dir = 0; dir < 2; ++dir) {
      if (dir == 0 ? !a.forward : !a.backward) continue;
      // forward: the right half waits, the left half is the chain
      const T* pd = dir == 0 ? upd : lod;
      const short* pc = dir == 0 ? upc : loc;
      const int pw = dir == 0 ? a.w_up : a.w_lo;
      const T* cd = dir == 0 ? lod : upd;
      const short* cc = dir == 0 ? loc : upc;
      const int cw = dir == 0 ? a.w_lo : a.w_up;
      sweep_parts(a, pd, pc, pw, xs, bs, al, be, ds, es);
      __syncthreads();
      const int i0 = dir == 0 ? 0 : R - 1, step = dir == 0 ? 1 : -1;
      warp_chain(a, cd, cc, cw, xs, be, es, i0, step);
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < R; i += blockDim.x) a.x_out[i] = xs[i];
}

// shared memory of a launch: six row vectors, plus both halves when staged
template <typename T>
size_t scan_smem_bytes(int rows, int w_lo, int w_up, bool staged) {
  size_t bytes = (size_t)6 * rows * sizeof(T);
  if (staged) bytes += (size_t)(w_lo + w_up) * rows * (sizeof(T) + sizeof(short));
  return bytes;
}

template <typename T, bool STAGED>
int launch(const ScanArgs<T>& a, size_t smem, void* stream) {
  auto kernel = scan_gs_kernel<T, STAGED>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<1, kScanThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int scan_gs(void* x_out, const void* x_in, const void* b, const void* lo_data,
            const void* lo_cols, const void* up_data, const void* up_cols,
            const void* dshift, const void* diag, int rows, int w_lo, int w_up,
            double omega, int iters, int forward, int backward, int staged,
            void* stream) {
  if (rows < 1 || w_lo < 0 || w_up < 0) return (int)cudaErrorInvalidValue;
  ScanArgs<T> a{static_cast<T*>(x_out), static_cast<const T*>(x_in), static_cast<const T*>(b),
                static_cast<const T*>(lo_data), static_cast<const short*>(lo_cols),
                static_cast<const T*>(up_data), static_cast<const short*>(up_cols),
                static_cast<const T*>(dshift), static_cast<const T*>(diag),
                rows, w_lo, w_up, static_cast<T>(omega), iters, forward, backward};
  const size_t smem = scan_smem_bytes<T>(rows, w_lo, w_up, staged != 0);
  return staged ? launch<T, true>(a, smem, stream) : launch<T, false>(a, smem, stream);
}

}  // namespace

// x_out[rows] = the smoother applied to x_in[rows] with rhs b: `iters`
// times a forward and/or backward sweep over the split ELL level (left and
// right halves [w][rows], int16 columns), dshift = a_ii - d and diagonal
// diag; staged = 1 loads the halves into shared memory.
#define AMG_SCAN_GS_ENTRY(T, SUFFIX)                                           \
  extern "C" int amg_scan_gs_##SUFFIX(                                         \
      void* x_out, const void* x_in, const void* b, const void* lo_data,       \
      const void* lo_cols, const void* up_data, const void* up_cols,           \
      const void* dshift, const void* diag, int rows, int w_lo, int w_up,      \
      double omega, int iters, int forward, int backward, int staged,          \
      void* stream) {                                                          \
    return scan_gs<T>(x_out, x_in, b, lo_data, lo_cols, up_data, up_cols,      \
                      dshift, diag, rows, w_lo, w_up, omega, iters, forward,   \
                      backward, staged, stream);                               \
  }

// the shared memory a launch takes (the wrapper's plan checks it)
extern "C" int amg_scan_gs_smem_bytes(int rows, int w_lo, int w_up, int itemsize, int staged) {
  return itemsize == 8 ? (int)scan_smem_bytes<double>(rows, w_lo, w_up, staged != 0)
                       : (int)scan_smem_bytes<float>(rows, w_lo, w_up, staged != 0);
}

AMG_SCAN_GS_ENTRY(float, f32)
AMG_SCAN_GS_ENTRY(double, f64)
