// Per-cell pieces of the factored V-cycle on a Lat2D level, shared by the
// leg kernels (vcycle_legs.cu: K1, K2, K3), the whole-tail kernel
// (tail_kernel.cu: K4, through tail_levels.cuh) and the whole-subcycle
// kernel (subcycle_kernel.cu: K9).  Each function computes one cell; the kernels own
// the loops, the launches and the barriers between dependent phases.
//
// Planes are unpadded [Wx, Wy] row-major; every stencil read outside
// [0,Wx)x[0,Wy) is guarded to zero.  Only the coefficient planes (A, dinv,
// T, S) are read through __restrict__ pointers: the work vectors (x, b, r,
// g, coarse vectors) are written inside the persistent kernels and read back
// after a barrier, so they must never take the non-coherent load path.
//
// The vectors and the arithmetic are of type T; the planes A, T and S of
// type C and dinv of type D, each T itself or, with bf16 coefficient
// planes under float32 or float64 vectors, __nv_bfloat16, converted to T
// where it is read (coef, coef_ldg; through float, exactly), so every sum
// and product stays in T.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <map>
#include <mutex>
#include <utility>

namespace amg {

constexpr int kMaxOff = 32;
constexpr int kMaxColorCells = 64;
constexpr int kMaxSteps = 64;

struct Stencil {
  int n;
  int dx[kMaxOff];
  int dy[kMaxOff];
};

struct ColorGrid {
  int a;
  int b;
  int tab[kMaxColorCells];
};

// a coefficient of type C as the working type T
template <typename T, typename C>
struct Widen {
  __device__ __forceinline__ static T of(C v) { return v; }
};
template <typename T>
struct Widen<T, __nv_bfloat16> {
  __device__ __forceinline__ static T of(__nv_bfloat16 v) {
    return T(__bfloat162float(v));
  }
};

// p[i] of a coefficient plane as T, by an ordinary load / through the
// non-coherent path
template <typename T, typename C>
__device__ __forceinline__ T coef(const C* __restrict__ p, int64_t i) {
  return Widen<T, C>::of(p[i]);
}
template <typename T, typename C>
__device__ __forceinline__ T coef_ldg(const C* __restrict__ p, int64_t i) {
  return Widen<T, C>::of(__ldg(p + i));
}

// sum_k A[k, i, j] * x[i + dx_k, j + dy_k], zero outside the grid
template <typename T, typename C>
__device__ __forceinline__ T stencil_at(const C* __restrict__ A, const T* x,
                                        const Stencil& st, int i, int j,
                                        int Wx, int Wy) {
  const int64_t plane = (int64_t)Wx * Wy;
  const int64_t c = (int64_t)i * Wy + j;
  T acc = T(0);
  for (int k = 0; k < st.n; ++k) {
    const int ii = i + st.dx[k];
    const int jj = j + st.dy[k];
    if (ii >= 0 && ii < Wx && jj >= 0 && jj < Wy) {
      acc += coef<T>(A, k * plane + c) * x[(int64_t)ii * Wy + jj];
    }
  }
  return acc;
}

// x_c index of fine cell (i, j) under box-K upsampling (K is 2 or 3, a
// compile-time constant, so the divisions become multiplies)
template <int K>
__device__ __forceinline__ int64_t coarse_of(int i, int j, int Wyc) {
  return (int64_t)(i / K) * Wyc + j / K;
}

// sum_k A[k, i, j] * Tup[i + dx_k, j + dy_k] with Tup = T * upsample_K(x_c)
// formed on the fly, so no Tup plane is written or read back
template <int K, typename T, typename C>
__device__ __forceinline__ T stencil_tup_at(const C* __restrict__ A,
                                            const C* __restrict__ Tp,
                                            const T* xc, const Stencil& st,
                                            int i, int j, int Wx, int Wy,
                                            int Wyc) {
  const int64_t plane = (int64_t)Wx * Wy;
  const int64_t c = (int64_t)i * Wy + j;
  T acc = T(0);
  for (int q = 0; q < st.n; ++q) {
    const int ii = i + st.dx[q];
    const int jj = j + st.dy[q];
    if (ii >= 0 && ii < Wx && jj >= 0 && jj < Wy) {
      acc += coef<T>(A, q * plane + c) *
             (coef<T>(Tp, (int64_t)ii * Wy + jj) *
              xc[coarse_of<K>(ii, jj, Wyc)]);
    }
  }
  return acc;
}

// One color step at cell (i, j): cells of color `color` take
// x + omega*dinv*(b - A x).  x_in == nullptr is the zero vector (b - A*0 =
// b); full_write writes every cell of x_out (x_in != x_out), otherwise only
// color cells are written in place.  In-place steps are race-free because
// the periodic lattice coloring leaves no two coupled cells the same color.
template <typename T, typename C, typename D>
__device__ __forceinline__ void step_cell(T* x_out, const T* x_in, const T* b,
                                          const C* __restrict__ A,
                                          const D* __restrict__ dinv,
                                          const Stencil& st,
                                          const ColorGrid& cg, int color,
                                          T omega, int i, int j, int Wx,
                                          int Wy, bool full_write) {
  const int64_t c = (int64_t)i * Wy + j;
  const bool mine = cg.tab[(i % cg.a) * cg.b + (j % cg.b)] == color;
  if (x_in == nullptr) {
    x_out[c] = mine ? omega * coef<T>(dinv, c) * b[c] : T(0);
  } else if (mine) {
    const T r = b[c] - stencil_at(A, x_in, st, i, j, Wx, Wy);
    x_out[c] = x_in[c] + omega * coef<T>(dinv, c) * r;
  } else if (full_write) {
    x_out[c] = x_in[c];
  }
}

// r = b - A x;  g = S * r
template <typename T, typename C>
__device__ __forceinline__ void residual_cell(T* r, T* g, const T* x,
                                              const T* b,
                                              const C* __restrict__ A,
                                              const C* __restrict__ S,
                                              const Stencil& st, int i, int j,
                                              int Wx, int Wy) {
  const int64_t c = (int64_t)i * Wy + j;
  const T rc = b[c] - stencil_at(A, x, st, i, j, Wx, Wy);
  r[c] = rc;
  g[c] = coef<T>(S, c) * rc;
}

// T * (r - A g) at one fine cell
template <typename T, typename C>
__device__ __forceinline__ T term_at(const T* r, const T* g,
                                     const C* __restrict__ A,
                                     const C* __restrict__ Tp,
                                     const Stencil& st, int i, int j, int Wx,
                                     int Wy) {
  const int64_t c = (int64_t)i * Wy + j;
  return coef<T>(Tp, c) * (r[c] - stencil_at(A, g, st, i, j, Wx, Wy));
}

// b_c[I, J] = sum of ts over the fine k x k box, clipped at the edge
template <typename T>
__device__ __forceinline__ void box_cell(T* bc, const T* ts, int I, int J,
                                         int Wx, int Wy, int Wyc, int k) {
  T acc = T(0);
  for (int dj = 0; dj < k && k * J + dj < Wy; ++dj) {
    T col = T(0);
    for (int di = 0; di < k && k * I + di < Wx; ++di) {
      col += ts[(int64_t)(k * I + di) * Wy + (k * J + dj)];
    }
    acc += col;
  }
  bc[(int64_t)I * Wyc + J] = acc;
}

// b_c[I, J] = sum over the clipped k x k box of T * (r - A g), in one pass
// (same summation order as term pass + box_cell)
template <typename T, typename C>
__device__ __forceinline__ void restrict_cell(T* bc, const T* r, const T* g,
                                              const C* __restrict__ A,
                                              const C* __restrict__ Tp,
                                              const Stencil& st, int I, int J,
                                              int Wx, int Wy, int Wyc, int k) {
  T acc = T(0);
  for (int dj = 0; dj < k && k * J + dj < Wy; ++dj) {
    T col = T(0);
    for (int di = 0; di < k && k * I + di < Wx; ++di) {
      col += term_at(r, g, A, Tp, st, k * I + di, k * J + dj, Wx, Wy);
    }
    acc += col;
  }
  bc[(int64_t)I * Wyc + J] = acc;
}

// x_out = x_in + (Tup - S * (A Tup)); x_out may alias x_in (a cell reads
// only its own x)
template <int K, typename T, typename C>
__device__ __forceinline__ void correct_cell_k(T* x_out, const T* x_in,
                                               const T* xc,
                                               const C* __restrict__ A,
                                               const C* __restrict__ Tp,
                                               const C* __restrict__ S,
                                               const Stencil& st, int i, int j,
                                               int Wx, int Wy, int Wyc) {
  const int64_t c = (int64_t)i * Wy + j;
  const T tup = coef<T>(Tp, c) * xc[coarse_of<K>(i, j, Wyc)];
  x_out[c] = x_in[c] + (tup - coef<T>(S, c) * stencil_tup_at<K>(A, Tp, xc, st,
                                                                i, j, Wx, Wy,
                                                                Wyc));
}

// the same for the level's k (2 or 3; the entry points reject others)
template <typename T, typename C>
__device__ __forceinline__ void correct_cell(T* x_out, const T* x_in,
                                             const T* xc,
                                             const C* __restrict__ A,
                                             const C* __restrict__ Tp,
                                             const C* __restrict__ S,
                                             const Stencil& st, int i, int j,
                                             int Wx, int Wy, int Wyc, int k) {
  if (k == 2) {
    correct_cell_k<2>(x_out, x_in, xc, A, Tp, S, st, i, j, Wx, Wy, Wyc);
  } else {
    correct_cell_k<3>(x_out, x_in, xc, A, Tp, S, st, i, j, Wx, Wy, Wyc);
  }
}

// ---- the non-factored R/P-plane transfers (the reference kernels' else
// branches): R holds nR planes over the coarse grid, P nP planes over the
// fine grid; the terms are summed in offset order, as the plain versions
// sum them.

// b_c[I, J] = sum_q R[q, I, J] * r[k I + dx_q, k J + dy_q], zero outside
// the fine grid
template <typename T, typename C>
__device__ __forceinline__ void restrict_planes_cell(T* bc, const T* r,
                                                     const C* __restrict__ R,
                                                     const Stencil& sr, int I,
                                                     int J, int Wx, int Wy,
                                                     int Wxc, int Wyc, int k) {
  const int64_t cplane = (int64_t)Wxc * Wyc;
  const int64_t c = (int64_t)I * Wyc + J;
  T acc = T(0);
  for (int q = 0; q < sr.n; ++q) {
    const int i = k * I + sr.dx[q];
    const int j = k * J + sr.dy[q];
    if (i >= 0 && i < Wx && j >= 0 && j < Wy) {
      acc += coef<T>(R, q * cplane + c) * r[(int64_t)i * Wy + j];
    }
  }
  bc[c] = acc;
}

// x_out = x_in + sum_q P[q, i, j] * x_c[i / K + dx_q, j / K + dy_q], zero
// outside the coarse grid; x_out may alias x_in (a cell reads only its own
// x)
template <int K, typename T, typename C>
__device__ __forceinline__ void correct_planes_cell_k(
    T* x_out, const T* x_in, const T* xc, const C* __restrict__ P,
    const Stencil& sp, int i, int j, int Wx, int Wy, int Wxc, int Wyc) {
  const int64_t plane = (int64_t)Wx * Wy;
  const int64_t c = (int64_t)i * Wy + j;
  const int I = i / K, J = j / K;
  T acc = T(0);
  for (int q = 0; q < sp.n; ++q) {
    const int ii = I + sp.dx[q];
    const int jj = J + sp.dy[q];
    if (ii >= 0 && ii < Wxc && jj >= 0 && jj < Wyc) {
      acc += coef<T>(P, q * plane + c) * xc[(int64_t)ii * Wyc + jj];
    }
  }
  x_out[c] = x_in[c] + acc;
}

template <typename T, typename C>
__device__ __forceinline__ void correct_planes_cell(
    T* x_out, const T* x_in, const T* xc, const C* __restrict__ P,
    const Stencil& sp, int i, int j, int Wx, int Wy, int Wxc, int Wyc, int k) {
  if (k == 2) {
    correct_planes_cell_k<2>(x_out, x_in, xc, P, sp, i, j, Wx, Wy, Wxc, Wyc);
  } else {
    correct_planes_cell_k<3>(x_out, x_in, xc, P, sp, i, j, Wx, Wy, Wxc, Wyc);
  }
}

// Visit every cell (i, j) of a Wx x Wy grid from a loop over blocks
// first, first + stride, ...: thread t of block v takes flat cells
// v * blockDim.x + t, then strides by stride * blockDim.x.  Coalesced, with
// one 32-bit division per cell (a level has < 2^31 cells).  (Row chunks of
// blockDim.x cells, one division per chunk, idle a block's tail lanes on
// narrow rows: on an H100, kernel_variants.py, K4 took 1.49 ms against
// 0.39 ms that way, and K3 at 1366^2 1.14 ms against 0.78 ms.)
template <typename F>
__device__ __forceinline__ void for_cells(int Wx, int Wy, int first,
                                          int stride, F&& f) {
  const int n = Wx * Wy;
  const int step = stride * blockDim.x;
  for (int c = first * blockDim.x + threadIdx.x; c < n; c += step) {
    const int i = c / Wy;
    f(i, c - i * Wy);
  }
}

// ---- host-side helpers: fill the fixed-capacity parameter structs -------

inline int make_stencil(Stencil* st, const int* offs, int n_off) {
  if (n_off < 0 || n_off > kMaxOff) return 1;
  st->n = n_off;
  for (int k = 0; k < n_off; ++k) {
    st->dx[k] = offs[2 * k];
    st->dy[k] = offs[2 * k + 1];
  }
  return 0;
}

inline int make_colors(ColorGrid* cg, const int* tab, int a, int b) {
  if (a < 1 || b < 1 || a * b > kMaxColorCells) return 1;
  cg->a = a;
  cg->b = b;
  for (int t = 0; t < a * b; ++t) cg->tab[t] = tab[t];
  return 0;
}

// Raise `kernel`'s dynamic shared-memory limit to at least `bytes` on the
// current device, once per kernel, device and size rather than on every
// launch (the default limit is 48 KB).  Returns a CUDA error code.
inline int ensure_dynamic_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  static std::mutex mu;
  static std::map<std::pair<int, const void*>, size_t> raised;
  std::lock_guard<std::mutex> lock(mu);
  size_t& have = raised[{dev, kernel}];
  if (bytes <= have) return 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) have = bytes;
  return (int)err;
}

// One cooperative launch with as many blocks as can be co-resident
// (occupancy per SM x SM count, with `smem` bytes of dynamic shared memory a
// block), so every block reaches each grid barrier.  A kernel's default
// dynamic limit is 48 KB less its static shared memory, so any dynamic size
// is opted into first.
inline int launch_cooperative(const void* fn, int threads, void** args,
                              cudaStream_t stream, size_t smem = 0) {
  int dev = 0;
  int sms = 0;
  int per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess && smem > 0) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads,
                                                        smem);
  }
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  err = cudaLaunchCooperativeKernel(fn, dim3(per_sm * sms), dim3(threads), args,
                                    smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace amg
