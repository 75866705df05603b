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
// Design of K1 and K2.  Blocks run in parallel with no order, so each color
// step is one pass over the whole level: the periodic lattice coloring
// guarantees no two coupled cells share a color, so every cell of color c
// updates in place without races, and the launch boundary is the barrier
// between steps.  The first step of a leg reads x from the input and
// writes every cell of the output, so a leg never copies x separately and
// a zero start reads no x.  The correction forms Tup = T * x_c[i/k, j/k]
// on the fly at each stencil neighbour instead of writing a Tup plane.
// The restriction writes T*(r - A g) per fine cell (coalesced, one thread a
// cell), then sums each (clipped) k x k box with one thread per coarse
// cell.  (Summing the boxes straight from the stencil, one thread per
// coarse cell, read every plane at stride k: 18% of a V-cycle's device time
// on an H100.)  These legs re-read the stencil planes once per pass.
//
// Design of K3 (leg_tile.cuh has the halo argument).  The TPU kernel keeps
// a tile plus a halo in VMEM and reads the coefficient planes once; so does
// this one: one ordinary launch, one block a tile of the level (extents
// multiples of k, planned by the wrapper from the shapes), x over the tile
// plus a halo of (n_steps + 2) * reach cells in shared memory, the
// correction, every color step, r, g and the restriction of the tile's
// coarse cells there, and only x over the tile and b_c written back, each
// thread's coefficients held in registers across the steps.  No grid
// barrier: halo erosion makes the tiles independent.  (Its first
// version, a cooperative launch of 9 grid-wide passes with r and g in
// device memory, took 2.26 ms at 4096^2 on an H100 against a 0.225 ms
// byte bound.)

// Every entry point launches on the caller's stream, allocates nothing,
// and returns a CUDA error code (cudaGetLastError() after the launches) for
// the wrapper to check.

#include <cuda_runtime.h>

#include <cstdint>

#include "leg_tile.cuh"

namespace {

using amg::ColorGrid;
using amg::Stencil;

constexpr int kThreads = 256;
// K3's block: one tile (leg_tile.cuh) a block, each thread keeping its
// cells' coefficients in registers (tile_leg_reg: warps, cells a thread
// down and across, so a box of up to (warps x down) x (32 x across) cells:
// 64 x 64 for both, the wrapper's REG_BOX).  Only 5- and 9-point levels
// whose box fits take K3; the wrapper plans no tile for others.
constexpr int kReg5Warps = 32, kReg5Rows = 2, kReg5Cols = 2;
constexpr int kReg9Warps = 16, kReg9Rows = 4, kReg9Cols = 2;

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

// the level's descriptor, a kernel parameter, into shared memory for the
// dynamic indexing of its stencil, coloring and steps
__device__ __forceinline__ void copy_desc(amg::LevelDesc* sh,
                                          const amg::LevelDesc& L) {
  const int* src = reinterpret_cast<const int*>(&L);
  int* dst = reinterpret_cast<int*>(sh);
  for (int w = threadIdx.x; w < (int)(sizeof(amg::LevelDesc) / sizeof(int));
       w += blockDim.x) {
    dst[w] = src[w];
  }
  __syncthreads();
}

// K3: up(i) then down(i+1), one block a tile
template <typename T, int K, int NOFF, int WARPS, int CI, int CJ>
__global__ void __launch_bounds__(WARPS * 32)
    updown_reg_kernel(T* x_out, const T* x_in, const T* b, const T* xc,
                      T* bc, const __grid_constant__ amg::LevelDesc L) {
  extern __shared__ __align__(16) unsigned char updown_smem[];
  __shared__ amg::LevelDesc sh;
  copy_desc(&sh, L);
  amg::tile_leg_reg<T, K, NOFF, WARPS, CI, CJ>(
      sh, updown_smem, 0, blockIdx.y, blockIdx.x, x_in, xc, b, x_out, bc);
}

template <typename Kernel, typename T>
int launch_updown(Kernel fn, int threads, dim3 grid, size_t smem,
                  cudaStream_t stream, T* x_out, const T* x_in, const T* b,
                  const T* xc, T* bc, const amg::LevelDesc& L) {
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fn<<<grid, threads, smem, stream>>>(x_out, x_in, b, xc, bc, L);
  return (int)cudaGetLastError();
}

template <typename T, int K>
int launch_updown_k(int n_off, dim3 grid, size_t smem, cudaStream_t stream,
                    T* x_out, const T* x_in, const T* b, const T* xc, T* bc,
                    const amg::LevelDesc& L) {
  if (n_off == 5) {
    return launch_updown(
        updown_reg_kernel<T, K, 5, kReg5Warps, kReg5Rows, kReg5Cols>,
        kReg5Warps * 32, grid, smem, stream, x_out, x_in, b, xc, bc, L);
  }
  return launch_updown(
      updown_reg_kernel<T, K, 9, kReg9Warps, kReg9Rows, kReg9Cols>,
      kReg9Warps * 32, grid, smem, stream, x_out, x_in, b, xc, bc, L);
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
                 const T* dinv, const T* Tp, const T* S, const T* xc, T* bc,
                 const int* offs, int n_off, const int* ctab, int ca, int cb,
                 const int* steps, int n_steps, double omega, int Wx, int Wy,
                 int Wxc, int Wyc, int k, int tile_x, int tile_y,
                 void* stream_ptr) {
  amg::LevelDesc L;
  if (amg::fill_level(&L, A, dinv, Tp, S, 0, 0, 0, 0, 0, Wx, Wy, Wxc, Wyc, k,
                      tile_x, tile_y, offs, n_off, ctab, ca, cb, steps,
                      n_steps, omega) ||
      tile_x < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(amg::tiles_of(Wy, tile_y), amg::tiles_of(Wx, tile_x));
  if (grid.y > 65535u) return (int)cudaErrorInvalidValue;
  const int halo = amg::leg_halo(n_steps, L.reach, true);
  const int E0 = tile_x + 2 * halo, E1 = tile_y + 2 * halo;
  const bool fits =
      (n_off == 5 && E0 <= kReg5Warps * kReg5Rows && E1 <= 32 * kReg5Cols) ||
      (n_off == 9 && E0 <= kReg9Warps * kReg9Rows && E1 <= 32 * kReg9Cols);
  if (!fits) return (int)cudaErrorInvalidValue;
  const size_t smem =
      amg::tile_smem_bytes(tile_x, tile_y, halo, L.reach, (int)sizeof(T));
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  return k == 2 ? launch_updown_k<T, 2>(n_off, grid, smem, stream, x_out,
                                        x_in, b, xc, bc, L)
                : launch_updown_k<T, 3>(n_off, grid, smem, stream, x_out,
                                        x_in, b, xc, bc, L);
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
      void* bc, const int* offs, int n_off, const int* ctab, int ca, int cb,  \
      const int* steps, int n_steps, double omega, int Wx, int Wy, int Wxc,   \
      int Wyc, int k, int tile_x, int tile_y, void* stream) {                 \
    return fused_updown<T>((T*)x_out, (const T*)x_in, (const T*)b,            \
                           (const T*)A, (const T*)dinv, (const T*)Tp,         \
                           (const T*)S, (const T*)xc, (T*)bc, offs, n_off,    \
                           ctab, ca, cb, steps, n_steps, omega, Wx, Wy, Wxc,  \
                           Wyc, k, tile_x, tile_y, stream);                   \
  }

AMG_DEFINE_LEGS(f32, float)
AMG_DEFINE_LEGS(f64, double)
