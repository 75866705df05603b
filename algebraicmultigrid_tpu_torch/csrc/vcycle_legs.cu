// Fused V-cycle legs on a Lat2D level (Hopper, sm_90a).
//
// Replaces the Pallas TPU kernels of the JAX package's
// ops/pallas/vcycle_kernels.py, factored-prolongator branch:
//   K1  _down_kernel via fused_down: multicolor GS/SOR presmooth over the
//       color-step list, r = b - A x, and the factored restriction
//       b_c = box_k-sum( T * (r - A (S * r)) ),   S = omega * Dtilde^-1;
//   K2  _up_kernel via fused_up: Tup = T * upsample_k(x_c),
//       x += Tup - S * (A Tup), then the postsmooth color steps;
//   K3  _updown_kernel via fused_updown: K2 of one cycle then K1 of the
//       next, with the double step list (steps2_list), as ONE launch.
//
// What bounds it on the card: bytes.  A leg streams the nA stencil planes
// plus dinv/T/S/b/x (about 11 planes of Wx*Wy words at a 9-point level) and
// does ~2 flops per byte read, far below the H100's ~20 flops/byte f32
// balance point, so every pass is memory-bound.
//
// Design.  The TPU kernel keeps a tile plus a halo in VMEM and runs every
// color step on it with halo over-compute; that shape exists because the TPU
// runs the grid in order on one core.  Here blocks run in parallel with no
// order, so each color step is one pass over the whole level: the periodic
// lattice coloring guarantees no two coupled cells share a color, so every
// cell of color c updates in place without races, and the pass boundary is
// the grid-wide barrier between steps.  K1 and K2 make each pass its own
// launch (the launch boundary is the barrier); K3 is one cooperative launch
// whose passes are grid-stride loops separated by grid.sync() — the card's
// counterpart of the TPU's in-order grid — which halves the level's
// launches per cycle.  The first step of a leg reads x from the input and
// writes every cell of the output, so a leg never copies x separately and a
// zero start reads no x.  The correction forms Tup = T * x_c[i/k, j/k] on
// the fly at each stencil neighbour instead of writing a Tup plane.  The
// restriction writes T*(r - A g) per fine cell (coalesced, one thread a
// cell), then sums each (clipped) k x k box with one thread per coarse cell.
// (Summing the boxes straight from the stencil, one thread per coarse cell,
// read every plane at stride k: 18% of a V-cycle's device time on an H100.)
// Fusing the steps with shared-memory tiles and halos, and TMA, is later
// work: this version re-reads the stencil planes once per step.
//
// Every entry point launches on the caller's stream, allocates nothing,
// and returns a CUDA error code (cudaGetLastError() after the launches) for
// the wrapper to check.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "stencil.cuh"

namespace {

namespace coop = cooperative_groups;
using amg::ColorGrid;
using amg::Stencil;
using amg::Steps;

constexpr int kThreads = 256;
// K3's cooperative grid: large blocks, registers capped at 32 to keep 2048
// threads per SM (K3 at 4096^2 on an H100, kernel_variants.py: 2.26 ms at
// 1024 threads x 2 blocks per SM, 2.31 ms at 256 x 8, 3.28 ms at 256
// threads with 40 registers)
constexpr int kCoopThreads = 1024;
constexpr int kCoopMinBlocks = 2;

template <typename T>
__global__ void color_step_kernel(T* x_out, const T* x_in,
                                  const T* __restrict__ b,
                                  const T* __restrict__ A,
                                  const T* __restrict__ dinv, Stencil st,
                                  ColorGrid cg, int color, T omega, int Wx,
                                  int Wy, int full_write) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= Wy) return;
  for (int i = blockIdx.y; i < Wx; i += gridDim.y) {
    amg::step_cell(x_out, x_in, b, A, dinv, st, cg, color, omega, i, j, Wx,
                   Wy, full_write != 0);
  }
}

template <typename T>
__global__ void residual_scale_kernel(T* __restrict__ r, T* __restrict__ g,
                                      const T* __restrict__ x,
                                      const T* __restrict__ b,
                                      const T* __restrict__ A,
                                      const T* __restrict__ S, Stencil st,
                                      int Wx, int Wy) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= Wy) return;
  for (int i = blockIdx.y; i < Wx; i += gridDim.y) {
    amg::residual_cell(r, g, x, b, A, S, st, i, j, Wx, Wy);
  }
}

// ts = T * (r - A g), written over r: a cell reads only its own r, and the
// stencil reads g, so the update is race-free
template <typename T>
__global__ void restrict_terms_kernel(T* r, const T* __restrict__ g,
                                      const T* __restrict__ A,
                                      const T* __restrict__ Tp, Stencil st,
                                      int Wx, int Wy) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= Wy) return;
  for (int i = blockIdx.y; i < Wx; i += gridDim.y) {
    r[(int64_t)i * Wy + j] = amg::term_at(r, g, A, Tp, st, i, j, Wx, Wy);
  }
}

template <typename T>
__global__ void box_sum_kernel(T* __restrict__ bc, const T* __restrict__ ts,
                               int Wx, int Wy, int Wxc, int Wyc, int k) {
  const int J = blockIdx.x * blockDim.x + threadIdx.x;
  if (J >= Wyc) return;
  for (int I = blockIdx.y; I < Wxc; I += gridDim.y) {
    amg::box_cell(bc, ts, I, J, Wx, Wy, Wyc, k);
  }
}

template <typename T>
__global__ void correct_kernel(T* __restrict__ x_out,
                               const T* __restrict__ x_in,
                               const T* __restrict__ xc,
                               const T* __restrict__ A,
                               const T* __restrict__ Tp,
                               const T* __restrict__ S, Stencil st, int Wx,
                               int Wy, int Wyc, int k) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= Wy) return;
  for (int i = blockIdx.y; i < Wx; i += gridDim.y) {
    amg::correct_cell(x_out, x_in, xc, A, Tp, S, st, i, j, Wx, Wy, Wyc, k);
  }
}

// K3: up(i) then down(i+1) in one cooperative launch.  Every thread runs
// every pass and reaches every grid.sync() (no early return).
template <typename T>
__global__ void __launch_bounds__(kCoopThreads, kCoopMinBlocks)
    updown_kernel(T* x_out, const T* __restrict__ x_in,
                  const T* __restrict__ b, const T* __restrict__ A,
                  const T* __restrict__ dinv, const T* __restrict__ Tp,
                  const T* __restrict__ S, const T* __restrict__ xc, T* r,
                  T* g, T* bc, Stencil st, ColorGrid cg, Steps steps, T omega,
                  int Wx, int Wy, int Wxc, int Wyc, int k) {
  coop::grid_group grid = coop::this_grid();
  const int first = blockIdx.x;
  const int stride = gridDim.x;

  amg::for_cells(Wx, Wy, first, stride, [&](int i, int j) {
    amg::correct_cell(x_out, x_in, xc, A, Tp, S, st, i, j, Wx, Wy, Wyc, k);
  });
  grid.sync();
  for (int s = 0; s < steps.n; ++s) {
    const int color = steps.s[s];
    amg::for_cells(Wx, Wy, first, stride, [&](int i, int j) {
      amg::step_cell(x_out, (const T*)x_out, b, A, dinv, st, cg, color, omega,
                     i, j, Wx, Wy, false);
    });
    grid.sync();
  }
  amg::for_cells(Wx, Wy, first, stride, [&](int i, int j) {
    amg::residual_cell(r, g, (const T*)x_out, b, A, S, st, i, j, Wx, Wy);
  });
  grid.sync();
  amg::for_cells(Wx, Wy, first, stride, [&](int i, int j) {
    r[(int64_t)i * Wy + j] =
        amg::term_at((const T*)r, (const T*)g, A, Tp, st, i, j, Wx, Wy);
  });
  grid.sync();
  amg::for_cells(Wxc, Wyc, first, stride, [&](int I, int J) {
    amg::box_cell(bc, (const T*)r, I, J, Wx, Wy, Wyc, k);
  });
}

dim3 grid_for(int rows, int cols) {
  const int gx = (cols + kThreads - 1) / kThreads;
  const int gy = rows < 65535 ? (rows > 0 ? rows : 1) : 65535;
  return dim3(gx, gy);
}

// the steps of one leg; the first reads x_in and writes all of x_out
template <typename T>
void run_steps(T* x_out, const T* x_in, const T* b, const T* A,
               const T* dinv, const Stencil& st, const ColorGrid& cg,
               const int* steps, int n_steps, T omega, int Wx, int Wy,
               bool first_full, cudaStream_t stream) {
  const dim3 grid = grid_for(Wx, Wy);
  for (int s = 0; s < n_steps; ++s) {
    const bool full = first_full && s == 0;
    color_step_kernel<T><<<grid, kThreads, 0, stream>>>(
        x_out, full ? x_in : x_out, b, A, dinv, st, cg, steps[s], omega, Wx,
        Wy, full ? 1 : 0);
  }
}

template <typename T>
int fused_down(T* x_out, const T* x_in, const T* b, const T* A,
               const T* dinv, const T* Tp, const T* S, T* r, T* g, T* bc,
               const int* offs, int n_off, const int* ctab, int ca, int cb,
               const int* steps, int n_steps, double omega, int Wx, int Wy,
               int Wxc, int Wyc, int k, void* stream_ptr) {
  Stencil st;
  ColorGrid cg;
  if (amg::make_stencil(&st, offs, n_off) ||
      amg::make_colors(&cg, ctab, ca, cb) || n_steps < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  run_steps<T>(x_out, x_in, b, A, dinv, st, cg, steps, n_steps, (T)omega, Wx,
               Wy, true, stream);
  residual_scale_kernel<T><<<grid_for(Wx, Wy), kThreads, 0, stream>>>(
      r, g, x_out, b, A, S, st, Wx, Wy);
  restrict_terms_kernel<T><<<grid_for(Wx, Wy), kThreads, 0, stream>>>(
      r, g, A, Tp, st, Wx, Wy);
  box_sum_kernel<T><<<grid_for(Wxc, Wyc), kThreads, 0, stream>>>(
      bc, r, Wx, Wy, Wxc, Wyc, k);
  return (int)cudaGetLastError();
}

template <typename T>
int fused_up(T* x_out, const T* x_in, const T* b, const T* A, const T* dinv,
             const T* Tp, const T* S, const T* xc, const int* offs,
             int n_off, const int* ctab, int ca, int cb, const int* steps,
             int n_steps, double omega, int Wx, int Wy, int Wyc, int k,
             void* stream_ptr) {
  Stencil st;
  ColorGrid cg;
  if (amg::make_stencil(&st, offs, n_off) ||
      amg::make_colors(&cg, ctab, ca, cb) || (k != 2 && k != 3)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  correct_kernel<T><<<grid_for(Wx, Wy), kThreads, 0, stream>>>(
      x_out, x_in, xc, A, Tp, S, st, Wx, Wy, Wyc, k);
  run_steps<T>(x_out, x_out, b, A, dinv, st, cg, steps, n_steps, (T)omega,
               Wx, Wy, false, stream);
  return (int)cudaGetLastError();
}

template <typename T>
int fused_updown(T* x_out, const T* x_in, const T* b, const T* A,
                 const T* dinv, const T* Tp, const T* S, const T* xc, T* r,
                 T* g, T* bc, const int* offs, int n_off, const int* ctab,
                 int ca, int cb, const int* steps, int n_steps, double omega,
                 int Wx, int Wy, int Wxc, int Wyc, int k, void* stream_ptr) {
  Stencil st;
  ColorGrid cg;
  Steps sl;
  if (amg::make_stencil(&st, offs, n_off) ||
      amg::make_colors(&cg, ctab, ca, cb) ||
      amg::make_steps(&sl, steps, n_steps) || (k != 2 && k != 3)) {
    return (int)cudaErrorInvalidValue;
  }
  T om = (T)omega;
  void* args[] = {&x_out, &x_in, &b,  &A,  &dinv,  &Tp, &S,  &xc,
                  &r,     &g,    &bc, &st, &cg,    &sl, &om, &Wx,
                  &Wy,    &Wxc,  &Wyc, &k};
  return amg::launch_cooperative((const void*)updown_kernel<T>, kCoopThreads,
                                 args, (cudaStream_t)stream_ptr);
}

}  // namespace

#define AMG_DEFINE_LEGS(SUFFIX, T)                                            \
  extern "C" int amg_fused_down_##SUFFIX(                                     \
      void* x_out, const void* x_in, const void* b, const void* A,            \
      const void* dinv, const void* Tp, const void* S, void* r, void* g,      \
      void* bc, const int* offs, int n_off, const int* ctab, int ca, int cb,  \
      const int* steps, int n_steps, double omega, int Wx, int Wy, int Wxc,   \
      int Wyc, int k, void* stream) {                                         \
    return fused_down<T>((T*)x_out, (const T*)x_in, (const T*)b,              \
                         (const T*)A, (const T*)dinv, (const T*)Tp,           \
                         (const T*)S, (T*)r, (T*)g, (T*)bc, offs, n_off,      \
                         ctab, ca, cb, steps, n_steps, omega, Wx, Wy, Wxc,    \
                         Wyc, k, stream);                                     \
  }                                                                           \
  extern "C" int amg_fused_up_##SUFFIX(                                       \
      void* x_out, const void* x_in, const void* b, const void* A,            \
      const void* dinv, const void* Tp, const void* S, const void* xc,        \
      const int* offs, int n_off, const int* ctab, int ca, int cb,            \
      const int* steps, int n_steps, double omega, int Wx, int Wy, int Wyc,   \
      int k, void* stream) {                                                  \
    return fused_up<T>((T*)x_out, (const T*)x_in, (const T*)b, (const T*)A,   \
                       (const T*)dinv, (const T*)Tp, (const T*)S,             \
                       (const T*)xc, offs, n_off, ctab, ca, cb, steps,        \
                       n_steps, omega, Wx, Wy, Wyc, k, stream);               \
  }                                                                           \
  extern "C" int amg_fused_updown_##SUFFIX(                                   \
      void* x_out, const void* x_in, const void* b, const void* A,            \
      const void* dinv, const void* Tp, const void* S, const void* xc,        \
      void* r, void* g, void* bc, const int* offs, int n_off,                 \
      const int* ctab, int ca, int cb, const int* steps, int n_steps,         \
      double omega, int Wx, int Wy, int Wxc, int Wyc, int k, void* stream) {  \
    return fused_updown<T>((T*)x_out, (const T*)x_in, (const T*)b,            \
                           (const T*)A, (const T*)dinv, (const T*)Tp,         \
                           (const T*)S, (const T*)xc, (T*)r, (T*)g, (T*)bc,   \
                           offs, n_off, ctab, ca, cb, steps, n_steps, omega,  \
                           Wx, Wy, Wxc, Wyc, k, stream);                      \
  }

AMG_DEFINE_LEGS(f32, float)
AMG_DEFINE_LEGS(f64, double)
