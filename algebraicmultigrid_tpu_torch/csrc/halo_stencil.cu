// K8: y = A x on one x-slab of a slab-sharded Lat2D operator (Hopper,
// sm_90a), in two parts that let the halo exchange overlap the stencil.
//
// Replaces the Pallas TPU kernel of the JAX package's
// parallel/async_halo.py (lat2d_spmv_halo_async, kernel body :80-173,
// pallas_call :177, row helper _stencil_rows :44).  A rank holds the rows
// [r0, r0 + loc) of the grid: planes data [n_off, loc, Wy] (a slab of the
// level's planes, read in place: consecutive planes lie `plane` elements
// apart), x [loc, Wy] and, for the boundary part, the halo [2, reach, Wy]:
// halo[0] the `reach` rows above the slab (the rank above's last rows),
// halo[1] the `reach` rows below it, zeros at the chain ends.  Per cell
//
//   y[i, j] = sum_k data[k, i, j] * X[i + dx_k, j + dy_k]
//
// summed in offset order, X being x inside the slab, the halo above and
// below it, and 0 beyond the grid's columns.  The TPU kernel runs the
// interior rows while its remote copies fly and the boundary rows after the
// receives land, inside one kernel with semaphores.  Here remote copies are
// NCCL (or gloo) point-to-point calls outside the kernel, so the kernel is
// split: part 0 computes the interior rows [reach, loc - reach), which read
// x only, and runs on the compute stream while the exchange runs on a
// communication stream; part 1 computes the `reach` top and bottom rows
// once the compute stream has waited on the exchange.  The wrapper
// (ops/kernels/halo_stencil.py) and the driver (parallel/async_halo.py)
// own the streams and the exchange.
//
// What bounds it on the card: bytes.  Each cell reads n_off coefficients
// and writes one value; x is read once from device memory and reused from
// the caches by the neighbouring threads.  At 4096^2 with 5 offsets that is
// (5 + 2) * 4 B * 16.8M = 470 MB, 0.140 ms at 3.35 TB/s.
//
// Design.  A thread per cell, consecutive threads on consecutive j, so the
// coefficient, x and y accesses of a warp coalesce; reads outside the slab
// go to the halo or read 0.  The products and sums are rounded one by one
// (no fused multiply-add), as the plain version rounds them, so the kernel
// agrees with it bitwise.  The entry point launches on the caller's stream,
// allocates nothing, launches nothing for an empty part, and returns
// cudaGetLastError() for the wrapper to check.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxOff = 32;
constexpr int kThreads = 256;

struct Offsets {
  int n;
  int dx[kMaxOff];
  int dy[kMaxOff];
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
    halo_stencil_kernel(T* __restrict__ y, const T* __restrict__ data,
                        long long plane, const T* __restrict__ x,
                        const T* __restrict__ halo, Offsets st, int loc,
                        int Wy, int reach, int part, long long cells) {
  const long long c = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= cells) return;
  const int r = static_cast<int>(c / Wy);
  const int j = static_cast<int>(c - static_cast<long long>(r) * Wy);
  // part 0: interior row reach + r; part 1: top rows, then bottom rows
  const int i = part == 0 ? reach + r : (r < reach ? r : loc - 2 * reach + r);
  const long long cell = static_cast<long long>(i) * Wy + j;
  T acc = T(0);
  for (int k = 0; k < st.n; ++k) {
    const int ii = i + st.dx[k];
    const int jj = j + st.dy[k];
    T v = T(0);
    if (jj >= 0 && jj < Wy) {
      if (ii < 0) {
        if (halo) v = halo[static_cast<long long>(reach + ii) * Wy + jj];
      } else if (ii >= loc) {
        if (halo) v = halo[static_cast<long long>(reach + ii - loc) * Wy + jj];
      } else {
        v = x[static_cast<long long>(ii) * Wy + jj];
      }
    }
    const T term = mul(data[k * plane + cell], v);
    acc = k == 0 ? term : add(acc, term);
  }
  y[cell] = acc;
}

template <typename T>
int launch(void* y, const void* data, long long plane, const void* x,
           const void* halo, const int* offs, int n_off, int loc, int Wy,
           int reach, int part, void* stream) {
  if (n_off < 1 || n_off > kMaxOff || loc < 2 * reach || Wy < 1 ||
      (part != 0 && part != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Offsets st{};
  st.n = n_off;
  for (int k = 0; k < n_off; ++k) {
    st.dx[k] = offs[2 * k];
    st.dy[k] = offs[2 * k + 1];
  }
  const long long rows = part == 0 ? loc - 2 * reach : 2 * reach;
  const long long cells = rows * Wy;
  if (cells > 0) {
    const long long blocks = (cells + kThreads - 1) / kThreads;
    halo_stencil_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<T*>(y), static_cast<const T*>(data), plane,
        static_cast<const T*>(x), static_cast<const T*>(halo), st, loc, Wy,
        reach, part, cells);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// part 0: rows [reach, loc - reach) of y (x only; halo may be null);
// part 1: rows [0, reach) and [loc - reach, loc) (halo [2, reach, Wy], or
// null for zeros).  offs holds (dx, dy) per offset.
extern "C" int amg_halo_stencil_f32(void* y, const void* data, long long plane,
                                    const void* x, const void* halo,
                                    const int* offs, int n_off, int loc, int Wy,
                                    int reach, int part, void* stream) {
  return launch<float>(y, data, plane, x, halo, offs, n_off, loc, Wy, reach,
                       part, stream);
}

extern "C" int amg_halo_stencil_f64(void* y, const void* data, long long plane,
                                    const void* x, const void* halo,
                                    const int* offs, int n_off, int loc, int Wy,
                                    int reach, int part, void* stream) {
  return launch<double>(y, data, plane, x, halo, offs, n_off, loc, Wy, reach,
                        part, stream);
}
