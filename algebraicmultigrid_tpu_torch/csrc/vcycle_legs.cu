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
// Design of K1, K2 and K3 (leg_tile.cuh has the halo argument).  The TPU
// kernels keep a tile plus a halo in VMEM and read the coefficient planes
// once; so do these: one ordinary launch, one block a tile of the level
// (extents multiples of k, planned by the wrapper from the shapes), x over
// the tile plus a halo of n_steps * reach cells (two reaches more with a
// restriction) in shared memory, the correction, every color step, r, g
// and the restriction of the tile's coarse cells there, and only x over
// the tile and b_c written back, each thread's coefficients held in
// registers across the steps.  No grid barrier: halo erosion makes the
// tiles independent.  K1's tiles read everything in one memory phase;
// K2's on a 5-point float32 level are walked by one block an SM with the
// next tile's box staged in shared memory meanwhile (the pipelined up
// leg); so are K3's on a 5-point level with bf16 planes under float32
// vectors, the next box landing by TMA (updown_stage.cuh, the staged K3:
// 0.75 ms at 4096^2 against 0.90 one block a tile).  On an H100
// (kernel_variants.py legs) these were the fastest of the variants for
// each leg: K1 at 4096^2 0.55 ms against 0.66 with K3's phases and 0.71
// pipelined, K2 0.53 against 0.56-0.58 in tiles.
//
// A level with no tile (13 points, more than 64 steps, a box past the
// register map) runs K1 and K2 pass by pass, as their first design did:
// one pass over the level per color step (the periodic lattice coloring
// leaves no two coupled cells the same color, so a color updates in place
// and the launch boundary is the barrier between steps), the first step
// reading x_in and writing all of x_out; the correction forms Tup = T *
// x_c[i/k, j/k] at each stencil neighbour; the restriction writes T*(r -
// A g) per fine cell, then sums each (clipped) k x k box with one thread
// per coarse cell.  Those passes re-read the planes once each: K1 took
// 1.385 ms at 4096^2 that way, K3's first version (a cooperative launch
// of 9 grid-wide passes) 2.26 ms, against a ~0.22 ms byte bound.

// The non-factored R/P-plane branches (amg_fused_down_nf_*, amg_fused_up_nf_*;
// the reference kernels' else branches, _down_kernel and _up_kernel): a
// level without the factored stash keeps nR restriction planes over the
// coarse grid and nP prolongation planes over the fine grid (21 and 5 at
// 4096^2's L0, 25 and 9 below), and restricts with b_c[c] = sum_q R_q[c]
// r[k c + d_q] and corrects with x += sum_q P_q[i] x_c[i / k + d_q].
// Bytes bound them like the factored legs.  On a tiled level (the plan's
// tile_x > 0) each is one launch of independent tiles, as the factored
// legs (leg_tile.cuh tile_down_nf, tile_up_nf): each R and P coefficient is
// read once a leg, so those planes are read where they are used and need
// no registers; A, dinv and b sit in the registers across the steps as in
// the factored tile.  The down tile keeps r on the tile plus the R
// offsets' spill in shared memory, the up tile x_c over its box's coarse
// window.  A level with no tile runs them pass by pass, their first design
// (K1: the presmooth passes, a pass writing r = b - A x, a pass with one
// thread a coarse cell; K2: a pass with one thread a fine cell, then the
// postsmooth passes), each pass re-reading the planes and x: on an H100
// with bf16 planes K1 at 4096^2's L0 took 1.10 ms that way against 0.58 in
// tiles, K2 1.00 against 0.56 (kernel_variants.py legs nf).  K3 takes
// factored levels only, as the reference's fused_updown does.
//
// bf16 coefficient planes (the entries *_f32_bf16 and *_f64_bf16: the
// reference's AMG_COEF_DTYPE=bfloat16, which stores A, D^-1, T and S of the
// legs in bf16 under float32 or float64 vectors).  The same kernels with
// the plane type C = __nv_bfloat16 beside the vectors: each coefficient is
// converted to the vectors' type where it is loaded (stencil.cuh coef;
// through float, exactly), so the registers, shared memory and the
// arithmetic are the vectors', as the reference's kernel bodies are once a
// bf16 plane meets an f32 or f64 vector.  A leg reads 2 bytes a coefficient
// in place of 4 or 8.  The pipelined up leg stages the planes a pair of
// coefficients a 4-byte cp.async (PairStage), b and x beside them an
// element a copy; with float64 vectors the stage and the tile buffers fit
// a block's shared memory where float64 planes did not (the wrapper's
// plan), so the pipelined route runs under both vector types.
//
// Every entry point launches on the caller's stream, allocates nothing,
// and returns a CUDA error code (cudaGetLastError() after the launches) for
// the wrapper to check.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "leg_tile.cuh"
#include "updown_stage.cuh"

namespace {

using amg::ColorGrid;
using amg::Stencil;

constexpr int kThreads = 256;
// The tiled legs' block: one tile (leg_tile.cuh) a block, each thread
// keeping its cells' coefficients in registers (tile_leg_reg: warps, cells
// a thread down and across, so a box of up to (warps x down) x (32 x
// across) cells: 64 x 64 for both, the wrapper's REG_BOX).  Only 5- and
// 9-point levels whose box fits take a tile; the wrapper plans none for
// others.
constexpr int kReg5Warps = 32, kReg5Rows = 2, kReg5Cols = 2;
constexpr int kReg9Warps = 16, kReg9Rows = 4, kReg9Cols = 2;

// T: the vectors and the arithmetic; C: the coefficient planes
template <typename T, typename C>
__global__ void color_step_kernel(T* x_out, const T* x_in,
                                  const T* __restrict__ b,
                                  const C* __restrict__ A,
                                  const C* __restrict__ dinv, Stencil st,
                                  ColorGrid cg, int color, T omega, int Wx,
                                  int Wy, int full_write) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= Wy) return;
  for (int i = blockIdx.y; i < Wx; i += gridDim.y) {
    amg::step_cell(x_out, x_in, b, A, dinv, st, cg, color, omega, i, j, Wx,
                   Wy, full_write != 0);
  }
}

template <typename T, typename C>
__global__ void residual_scale_kernel(T* __restrict__ r, T* __restrict__ g,
                                      const T* __restrict__ x,
                                      const T* __restrict__ b,
                                      const C* __restrict__ A,
                                      const C* __restrict__ S, Stencil st,
                                      int Wx, int Wy) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= Wy) return;
  for (int i = blockIdx.y; i < Wx; i += gridDim.y) {
    amg::residual_cell(r, g, x, b, A, S, st, i, j, Wx, Wy);
  }
}

// ts = T * (r - A g), written over r: a cell reads only its own r, and the
// stencil reads g, so the update is race-free
template <typename T, typename C>
__global__ void restrict_terms_kernel(T* r, const T* __restrict__ g,
                                      const C* __restrict__ A,
                                      const C* __restrict__ Tp, Stencil st,
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

template <typename T, typename C>
__global__ void correct_kernel(T* __restrict__ x_out,
                               const T* __restrict__ x_in,
                               const T* __restrict__ xc,
                               const C* __restrict__ A,
                               const C* __restrict__ Tp,
                               const C* __restrict__ S, Stencil st, int Wx,
                               int Wy, int Wyc, int k) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= Wy) return;
  for (int i = blockIdx.y; i < Wx; i += gridDim.y) {
    amg::correct_cell(x_out, x_in, xc, A, Tp, S, st, i, j, Wx, Wy, Wyc, k);
  }
}

// ---- the non-factored R/P-plane legs' pass route ------------------------

// r = b - A x
template <typename T, typename C>
__global__ void residual_kernel(T* __restrict__ r, const T* __restrict__ x,
                                const T* __restrict__ b,
                                const C* __restrict__ A, Stencil st, int Wx,
                                int Wy) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= Wy) return;
  for (int i = blockIdx.y; i < Wx; i += gridDim.y) {
    const int64_t c = (int64_t)i * Wy + j;
    r[c] = b[c] - amg::stencil_at(A, x, st, i, j, Wx, Wy);
  }
}

// one thread a coarse cell: b_c = sum_q R_q * r[k c + d_q]
template <typename T, typename C>
__global__ void restrict_planes_kernel(T* __restrict__ bc,
                                       const T* __restrict__ r,
                                       const C* __restrict__ R, Stencil sr,
                                       int Wx, int Wy, int Wxc, int Wyc,
                                       int k) {
  const int J = blockIdx.x * blockDim.x + threadIdx.x;
  if (J >= Wyc) return;
  for (int I = blockIdx.y; I < Wxc; I += gridDim.y) {
    amg::restrict_planes_cell(bc, r, R, sr, I, J, Wx, Wy, Wxc, Wyc, k);
  }
}

// one thread a fine cell: x_out = x_in + sum_q P_q * x_c[c / k + d_q]
template <typename T, typename C>
__global__ void correct_planes_kernel(T* __restrict__ x_out,
                                      const T* __restrict__ x_in,
                                      const T* __restrict__ xc,
                                      const C* __restrict__ P, Stencil sp,
                                      int Wx, int Wy, int Wxc, int Wyc,
                                      int k) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= Wy) return;
  for (int i = blockIdx.y; i < Wx; i += gridDim.y) {
    amg::correct_planes_cell(x_out, x_in, xc, P, sp, i, j, Wx, Wy, Wxc, Wyc,
                             k);
  }
}

// the level's descriptor (or a stencil), a kernel parameter, into shared
// memory for the dynamic indexing of its stencil, coloring and steps
template <typename S>
__device__ __forceinline__ void copy_desc(S* sh, const S& L) {
  const int* src = reinterpret_cast<const int*>(&L);
  int* dst = reinterpret_cast<int*>(sh);
  for (int w = threadIdx.x; w < (int)(sizeof(S) / sizeof(int));
       w += blockDim.x) {
    dst[w] = src[w];
  }
  __syncthreads();
}

// K1, K2 and K3 on a tiled level, one block a tile: a down leg (xc
// nullptr), an up leg (bc nullptr) or the updown leg (both)
template <typename T, int K, int NOFF, int WARPS, int CI, int CJ, bool EARLY,
          typename C>
__global__ void __launch_bounds__(WARPS * 32)
    leg_reg_kernel(T* x_out, const T* x_in, const T* b, const T* xc, T* bc,
                   const __grid_constant__ amg::LevelDesc L) {
  extern __shared__ __align__(16) unsigned char leg_smem[];
  __shared__ amg::LevelDesc sh;
  copy_desc(&sh, L);
  amg::tile_leg_reg<T, K, NOFF, WARPS, CI, CJ, EARLY, C, C>(
      sh, leg_smem, 0, blockIdx.y, blockIdx.x, x_in, xc, b, x_out, bc);
}

// K1 and K2 on a tiled non-factored level, one block a tile: the down leg
// (the R planes, bc) or the up leg (the P planes, xc); so: their offsets
template <typename T, int K, int NOFF, int WARPS, int CI, int CJ, bool DOWN,
          typename C>
__global__ void __launch_bounds__(WARPS * 32)
    leg_nf_kernel(T* x_out, const T* x_in, const T* b, const T* xc, T* bc,
                  const C* planes, const __grid_constant__ amg::LevelDesc L,
                  const __grid_constant__ Stencil so) {
  extern __shared__ __align__(16) unsigned char leg_smem[];
  __shared__ amg::LevelDesc sh;
  __shared__ Stencil sho;
  copy_desc(&sh, L);
  copy_desc(&sho, so);
  if constexpr (DOWN) {
    amg::tile_down_nf<T, K, NOFF, WARPS, CI, CJ, C, C, C>(
        sh, planes, sho, leg_smem, 0, blockIdx.y, blockIdx.x, x_in, b, x_out,
        bc);
  } else {
    amg::tile_up_nf<T, K, NOFF, WARPS, CI, CJ, C, C>(
        sh, planes, sho, leg_smem, 0, blockIdx.y, blockIdx.x, sh.tile_x,
        sh.tile_y, x_in, xc, b, x_out);
  }
}

// ---- the pipelined up leg (K2 on 5-point levels) ------------------------
//
// One block an SM walks the level's tiles.  While a tile corrects and
// steps from its registers and tile buffers, the next tile's box lands in
// a stage in shared memory through cp.async, so the SM's loads overlap its
// work.  The stage holds the box planes (A, dinv, b, x, S), T over the box
// plus one reach and x_c over that area's coarse cells; zero outside the
// grid (cp.async zero-fills).  With 2-byte planes the stage is laid out
// for copies of a pair of coefficients (PairStage).

// one element from device to shared memory, zero where !valid
template <typename T>
__device__ __forceinline__ void cp_async_el(T* dst, const T* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
               "l"(src), "n"((int)sizeof(T)),
               "r"(valid ? (int)sizeof(T) : 0));
}

// two 2-byte elements (4 bytes, 4-byte aligned at both ends), zero where
// !valid: cp.async copies 4, 8 or 16 bytes, not 2
template <typename C>
__device__ __forceinline__ void cp_async_pair(C* dst, const C* src,
                                              bool valid) {
  static_assert(sizeof(C) == 2, "a pair of 2-byte coefficients");
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// bytes of a tile's stage with planes of the vectors' type, to 16
__host__ __device__ inline unsigned stage_bytes(int E0, int E1, int noff,
                                                int reach, int k,
                                                int itemsize) {
  const int U0 = E0 + 2 * reach, U1 = E1 + 2 * reach;
  const int words =
      (noff + 4) * E0 * E1 + U0 * U1 + (U0 / k + 2) * (U1 / k + 2);
  return ((unsigned)words * itemsize + 15u) / 16u * 16u;
}

// The stage of a tile's box with 2-byte planes: b and x over the box and
// x_c over the coarse cells of T's area (the vectors' type), then the
// planes A (noff), dinv and S over the box and T over the box plus one
// reach (T's area).  cp.async copies 4, 8 or 16 bytes, so the planes go a
// pair of coefficients a copy: a row of a box array holds E1s cells from
// the even grid column oy - s, a row of T's area U1s cells from
// oy - reach - su, E1s and U1s even.  On a level of even Wy whose planes
// are 4-byte aligned (the wrapper's plan) a pair then lies inside the grid
// or outside it whole.  b and x share the box arrays' rows.
struct PairStage {
  int E1s, U1s, s, su;  // row lengths and first-cell columns (box, T's area)
  int n;                // cells of a box array
  unsigned coef_off;    // bytes before the planes
  unsigned bytes;       // all of it, to 16
};

__host__ __device__ inline PairStage pair_stage(int E0, int E1, int oy,
                                                int noff, int reach, int k,
                                                int itemsize) {
  const int U0 = E0 + 2 * reach, U1 = E1 + 2 * reach;
  PairStage sg;
  sg.E1s = (E1 + 2) & ~1;
  sg.U1s = (U1 + 2) & ~1;
  sg.s = oy & 1;
  sg.su = (oy - reach) & 1;
  sg.n = E0 * sg.E1s;
  const int ncx = (U0 / k + 2) * (U1 / k + 2);
  sg.coef_off = (unsigned)(2 * sg.n + ncx) * itemsize;
  sg.bytes =
      (sg.coef_off + (unsigned)((noff + 2) * sg.n + U0 * sg.U1s) * 2u + 15u) /
      16u * 16u;
  return sg;
}

// the stage's bytes for planes of type C under vectors of type T
template <typename T, typename C>
__host__ __device__ inline unsigned pipe_stage_bytes(int E0, int E1,
                                                     int reach, int k) {
  if constexpr (sizeof(C) == 2) {
    return pair_stage(E0, E1, 0, 5, reach, k, (int)sizeof(T)).bytes;
  } else {
    return stage_bytes(E0, E1, 5, reach, k, (int)sizeof(T));
  }
}

// the coarse cells of T over the box plus one reach: rows ci0.., columns
// cj0.., xw a row in the stage
struct CoarseArea {
  int ci0, ci1, cj0, cj1, xw;
};

__device__ __forceinline__ CoarseArea coarse_area(const amg::LevelDesc& L,
                                                  const amg::Box& bx, int K) {
  const int r = L.reach, U0 = bx.E0 + 2 * r, U1 = bx.E1 + 2 * r;
  CoarseArea ca;
  ca.ci0 = max(bx.ox - r, 0) / K;
  ca.ci1 = (min(bx.ox - r + U0, L.Wx) - 1) / K;
  ca.cj0 = max(bx.oy - r, 0) / K;
  ca.cj1 = (min(bx.oy - r + U1, L.Wy) - 1) / K;
  ca.xw = U1 / K + 2;
  return ca;
}

// a tile's inputs from its stage (the interface of amg::DeviceIn; an up
// leg reads no T on its box)
template <typename T, int K>
struct StagedIn {
  const T* st;
  const T* tp;   // T over the box plus one reach
  const T* xcs;  // x_c over its coarse cells
  int n, noff, U1, Wx, Wy, r, ox, oy, ci0, cj0, xw;

  __device__ int index(int, int, int e) const { return e; }
  __device__ T a(int q, int e, bool in, int64_t) const {
    return in ? st[q * n + e] : T(0);
  }
  __device__ T d(int e, bool in, int64_t) const {
    return in ? st[noff * n + e] : T(0);
  }
  __device__ T rhs(int e, bool in, int64_t) const {
    return in ? st[(noff + 1) * n + e] : T(0);
  }
  __device__ T xv(int e, bool in, int64_t) const {
    return in ? st[(noff + 2) * n + e] : T(0);
  }
  __device__ T s(int e, bool in, int64_t) const {
    return in ? st[(noff + 3) * n + e] : T(0);
  }
  __device__ T t(int, bool, int64_t) const { return T(0); }
  __device__ T tup(int u0, int u1) const {
    const int i = ox - r + u0, j = oy - r + u1;
    return amg::inside(i, j, Wx, Wy)
               ? tp[u0 * U1 + u1] * xcs[(i / K - ci0) * xw + (j / K - cj0)]
               : T(0);
  }
};

template <typename T, int K>
__device__ __forceinline__ StagedIn<T, K> staged_in(const amg::LevelDesc& L,
                                                    const amg::Box& bx,
                                                    const T* st, int noff) {
  const int n = bx.E0 * bx.E1, r = L.reach;
  const int U0 = bx.E0 + 2 * r, U1 = bx.E1 + 2 * r;
  const CoarseArea ca = coarse_area(L, bx, K);
  const T* tp = st + (noff + 4) * n;
  return StagedIn<T, K>{st, tp, tp + U0 * U1, n, noff, U1, L.Wx, L.Wy, r,
                        bx.ox, bx.oy, ca.ci0, ca.cj0, ca.xw};
}

// the same from a PairStage: coefficients converted to T where read, and
// every box array indexed by its padded rows
template <typename T, typename C, int K>
struct StagedPairs {
  const T* v;    // b, then x, over the box
  const T* xcs;  // x_c over its coarse cells
  const C* cf;   // A (noff planes), dinv, S over the box
  const C* tp;   // T over the box plus one reach
  int n, noff, E1s, s0, U1s, su, Wx, Wy, r, ox, oy, ci0, cj0, xw;

  __device__ int index(int e0, int e1, int) const {
    return e0 * E1s + s0 + e1;
  }
  __device__ T a(int q, int e, bool in, int64_t) const {
    return in ? amg::coef<T>(cf, q * n + e) : T(0);
  }
  __device__ T d(int e, bool in, int64_t) const {
    return in ? amg::coef<T>(cf, noff * n + e) : T(0);
  }
  __device__ T rhs(int e, bool in, int64_t) const { return in ? v[e] : T(0); }
  __device__ T xv(int e, bool in, int64_t) const {
    return in ? v[n + e] : T(0);
  }
  __device__ T s(int e, bool in, int64_t) const {
    return in ? amg::coef<T>(cf, (noff + 1) * n + e) : T(0);
  }
  __device__ T t(int, bool, int64_t) const { return T(0); }
  __device__ T tup(int u0, int u1) const {
    const int i = ox - r + u0, j = oy - r + u1;
    return amg::inside(i, j, Wx, Wy)
               ? amg::coef<T>(tp, u0 * U1s + su + u1) *
                     xcs[(i / K - ci0) * xw + (j / K - cj0)]
               : T(0);
  }
};

template <typename T, typename C, int K>
__device__ __forceinline__ StagedPairs<T, C, K> staged_pairs(
    const amg::LevelDesc& L, const amg::Box& bx, unsigned char* base,
    int noff) {
  const PairStage sg =
      pair_stage(bx.E0, bx.E1, bx.oy, noff, L.reach, K, (int)sizeof(T));
  const CoarseArea ca = coarse_area(L, bx, K);
  const T* v = reinterpret_cast<const T*>(base);
  const C* cf = reinterpret_cast<const C*>(base + sg.coef_off);
  return StagedPairs<T, C, K>{v, v + 2 * sg.n, cf, cf + (noff + 2) * sg.n,
                              sg.n, noff, sg.E1s, sg.s, sg.U1s, sg.su, L.Wx,
                              L.Wy, L.reach, bx.ox, bx.oy, ca.ci0, ca.cj0,
                              ca.xw};
}

// the cp.async of x_c over the coarse cells of T's area
template <typename T, int K>
__device__ __forceinline__ void stage_xc(const amg::LevelDesc& L,
                                         const amg::Box& bx, T* xcs,
                                         const T* xc) {
  const CoarseArea ca = coarse_area(L, bx, K);
  const int cols = ca.cj1 - ca.cj0 + 1, cells = (ca.ci1 - ca.ci0 + 1) * cols;
  for (int v = threadIdx.x; v < cells; v += blockDim.x) {
    const int v0 = v / cols, v1 = v - v0 * cols;
    cp_async_el(xcs + v0 * ca.xw + v1,
                xc + (int64_t)(ca.ci0 + v0) * L.Wyc + (ca.cj0 + v1), true);
  }
}

// issue the cp.async of a tile's stage (the caller commits the group)
template <typename T, int K, int NOFF>
__device__ void stage_tile(const amg::LevelDesc& L, const amg::Box& bx, T* st,
                           const T* x, const T* b, const T* xc) {
  const int n = bx.E0 * bx.E1, E1 = bx.E1, r = L.reach;
  const int64_t plane = (int64_t)L.Wx * L.Wy;
  const T* A = (const T*)L.A;
  const T* dinv = (const T*)L.dinv;
  const T* Tp = (const T*)L.Tp;
  const T* S = (const T*)L.S;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int e0 = e / E1, e1 = e - e0 * E1;
    const int i = bx.ox + e0, j = bx.oy + e1;
    const bool in = amg::inside(i, j, L.Wx, L.Wy);
    const int64_t g = in ? (int64_t)i * L.Wy + j : 0;
#pragma unroll
    for (int q = 0; q < NOFF; ++q) {
      cp_async_el(st + q * n + e, A + q * plane + g, in);
    }
    cp_async_el(st + NOFF * n + e, dinv + g, in);
    cp_async_el(st + (NOFF + 1) * n + e, b + g, in);
    cp_async_el(st + (NOFF + 2) * n + e, x + g, in);
    cp_async_el(st + (NOFF + 3) * n + e, S + g, in);
  }
  const int U0 = bx.E0 + 2 * r, U1 = E1 + 2 * r;
  T* tp = st + (NOFF + 4) * n;
  for (int u = threadIdx.x; u < U0 * U1; u += blockDim.x) {
    const int u0 = u / U1, u1 = u - u0 * U1;
    const int i = bx.ox - r + u0, j = bx.oy - r + u1;
    const bool in = amg::inside(i, j, L.Wx, L.Wy);
    cp_async_el(tp + u, Tp + (in ? (int64_t)i * L.Wy + j : 0), in);
  }
  stage_xc<T, K>(L, bx, tp + U0 * U1, xc);
}

// the same into a PairStage: b and x an element a copy, the planes a pair
// of coefficients a copy (j even)
template <typename T, typename C, int K, int NOFF>
__device__ void stage_pairs(const amg::LevelDesc& L, const amg::Box& bx,
                            unsigned char* base, const T* x, const T* b,
                            const T* xc) {
  const int E1 = bx.E1, r = L.reach;
  const PairStage sg =
      pair_stage(bx.E0, E1, bx.oy, NOFF, r, K, (int)sizeof(T));
  const int64_t plane = (int64_t)L.Wx * L.Wy;
  const C* A = (const C*)L.A;
  const C* dinv = (const C*)L.dinv;
  const C* Tp = (const C*)L.Tp;
  const C* S = (const C*)L.S;
  T* v = reinterpret_cast<T*>(base);
  C* cf = reinterpret_cast<C*>(base + sg.coef_off);
  for (int e = threadIdx.x; e < bx.E0 * E1; e += blockDim.x) {
    const int e0 = e / E1, e1 = e - e0 * E1;
    const int i = bx.ox + e0, j = bx.oy + e1;
    const bool in = amg::inside(i, j, L.Wx, L.Wy);
    const int64_t g = in ? (int64_t)i * L.Wy + j : 0;
    const int es = e0 * sg.E1s + sg.s + e1;
    cp_async_el(v + es, b + g, in);
    cp_async_el(v + sg.n + es, x + g, in);
  }
  const int pairs = sg.E1s / 2;
  for (int w = threadIdx.x; w < bx.E0 * pairs; w += blockDim.x) {
    const int e0 = w / pairs, p = w - e0 * pairs;
    const int i = bx.ox + e0, j = bx.oy - sg.s + 2 * p;
    const bool in = amg::inside(i, j, L.Wx, L.Wy);
    const int64_t g = in ? (int64_t)i * L.Wy + j : 0;
    const int es = e0 * sg.E1s + 2 * p;
#pragma unroll
    for (int q = 0; q < NOFF; ++q) {
      cp_async_pair(cf + q * sg.n + es, A + q * plane + g, in);
    }
    cp_async_pair(cf + NOFF * sg.n + es, dinv + g, in);
    cp_async_pair(cf + (NOFF + 1) * sg.n + es, S + g, in);
  }
  const int U0 = bx.E0 + 2 * r, upairs = sg.U1s / 2;
  C* tp = cf + (NOFF + 2) * sg.n;
  for (int w = threadIdx.x; w < U0 * upairs; w += blockDim.x) {
    const int u0 = w / upairs, p = w - u0 * upairs;
    const int i = bx.ox - r + u0, j = bx.oy - r - sg.su + 2 * p;
    const bool in = amg::inside(i, j, L.Wx, L.Wy);
    cp_async_pair(tp + u0 * sg.U1s + 2 * p,
                  Tp + (in ? (int64_t)i * L.Wy + j : 0), in);
  }
  stage_xc<T, K>(L, bx, v + 2 * sg.n, xc);
}

// K2 on a 5-point level, pipelined
template <typename T, typename C, int K>
__global__ void __launch_bounds__(kReg5Warps * 32)
    up_pipe_kernel(T* x_out, const T* x_in, const T* b, const T* xc, T*,
                   const __grid_constant__ amg::LevelDesc L) {
  extern __shared__ __align__(16) unsigned char pipe_smem[];
  __shared__ amg::LevelDesc sh;
  copy_desc(&sh, L);
  const int h = amg::leg_halo(sh.n_steps, sh.reach, false);
  const int ntj = amg::tiles_of(sh.Wy, sh.tile_y);
  const int nt = amg::tiles_of(sh.Wx, sh.tile_x) * ntj;
  const int E0 = sh.tile_x + 2 * h, E1 = sh.tile_y + 2 * h;
  if (E0 > kReg5Warps * kReg5Rows || E1 > 32 * kReg5Cols || sh.st.n != 5 ||
      (sizeof(C) == 2 && sh.Wy % 2 != 0)) {
    __trap();
  }
  T* st = reinterpret_cast<T*>(pipe_smem);
  const unsigned off = pipe_stage_bytes<T, C>(E0, E1, sh.reach, K);
  auto box_of = [&](int t) {
    return amg::make_box(t / ntj, t % ntj, sh.tile_x, sh.tile_y, h);
  };
  auto stage = [&](const amg::Box& bx) {
    if constexpr (sizeof(C) == 2) {
      stage_pairs<T, C, K, 5>(sh, bx, pipe_smem, x_in, b, xc);
    } else {
      stage_tile<T, K, 5>(sh, bx, st, x_in, b, xc);
    }
  };
  auto source = [&](const amg::Box& bx) {
    if constexpr (sizeof(C) == 2) {
      return staged_pairs<T, C, K>(sh, bx, pipe_smem, 5);
    } else {
      return staged_in<T, K>(sh, bx, st, 5);
    }
  };
  if ((int)blockIdx.x < nt) stage(box_of(blockIdx.x));
  cp_async_commit();
  for (int t = blockIdx.x; t < nt; t += gridDim.x) {
    cp_async_wait_all();
    __syncthreads();
    const amg::Box bx = box_of(t);
    const amg::TileSmem<T> sm =
        amg::tile_buffers<T>(pipe_smem, off, bx, sh.reach);
    const auto src = source(bx);
    amg::CellRegs<T, 5, kReg5Rows, kReg5Cols> R;
    amg::tile_load<T, K, 5, kReg5Warps, kReg5Rows, kReg5Cols, true>(
        sh, sm, bx, src, true, false, R);
    // the stage is free: the next tile's loads fly while this one works
    if (t + (int)gridDim.x < nt) stage(box_of(t + gridDim.x));
    cp_async_commit();
    amg::tile_run<T, 5, kReg5Warps, kReg5Rows, kReg5Cols, true>(
        sh, sm, bx, src, R, true, x_out, (T*)nullptr);
  }
  cp_async_wait_all();
}

template <typename Kernel, typename T>
int launch_leg(Kernel fn, int threads, dim3 grid, size_t smem,
               cudaStream_t stream, T* x_out, const T* x_in, const T* b,
               const T* xc, T* bc, const amg::LevelDesc& L) {
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fn<<<grid, threads, smem, stream>>>(x_out, x_in, b, xc, bc, L);
  return (int)cudaGetLastError();
}

template <typename T, typename C, int K, bool EARLY>
int launch_tiles_k(int n_off, dim3 grid, size_t smem, cudaStream_t stream,
                   T* x_out, const T* x_in, const T* b, const T* xc, T* bc,
                   const amg::LevelDesc& L) {
  if (n_off == 5) {
    return launch_leg(
        leg_reg_kernel<T, K, 5, kReg5Warps, kReg5Rows, kReg5Cols, EARLY, C>,
        kReg5Warps * 32, grid, smem, stream, x_out, x_in, b, xc, bc, L);
  }
  return launch_leg(
      leg_reg_kernel<T, K, 9, kReg9Warps, kReg9Rows, kReg9Cols, EARLY, C>,
      kReg9Warps * 32, grid, smem, stream, x_out, x_in, b, xc, bc, L);
}

// A leg of a tiled level (L.tile_x > 0) as one launch: the updown leg K3
// (xc and bc), a down leg K1 (bc) or an up leg K2 (xc), the up leg
// pipelined where asked.  K1's tiles read all they need in their first
// memory phase (leg_tile.cuh EARLY), K2's and K3's x, S and T in later
// phases, a pipelined K2 its staged box in its first (kernel_variants.py
// legs: the fastest for each leg on an H100).  A pipelined leg needs its
// Tup area, not only its box, within the thread map, and with 2-byte
// coefficients an even Wy and 4-byte aligned planes (PairStage).
template <typename T, typename C>
int run_tiles(const amg::LevelDesc& L, int n_off, bool pipelined,
              cudaStream_t stream, T* x_out, const T* x_in, const T* b,
              const T* xc, T* bc) {
  const bool down = bc != nullptr, up = xc != nullptr;
  const bool early = down && !up;
  const int halo = amg::leg_halo(L.n_steps, L.reach, down);
  const int E0 = L.tile_x + 2 * halo, E1 = L.tile_y + 2 * halo;
  const int wide = pipelined ? 2 * L.reach : 0;
  const int F0 = E0 + wide, F1 = E1 + wide;
  const bool fits =
      (n_off == 5 && F0 <= kReg5Warps * kReg5Rows && F1 <= 32 * kReg5Cols) ||
      (n_off == 9 && F0 <= kReg9Warps * kReg9Rows && F1 <= 32 * kReg9Cols);
  if (!fits) return (int)cudaErrorInvalidValue;
  const int ntx = amg::tiles_of(L.Wx, L.tile_x);
  const int nty = amg::tiles_of(L.Wy, L.tile_y);
  const size_t tile =
      amg::tile_smem_bytes(L.tile_x, L.tile_y, halo, L.reach, (int)sizeof(T));
  if (pipelined) {
    const uintptr_t planes =
        reinterpret_cast<uintptr_t>(L.A) | reinterpret_cast<uintptr_t>(L.dinv) |
        reinterpret_cast<uintptr_t>(L.Tp) | reinterpret_cast<uintptr_t>(L.S);
    if (n_off != 5 || down || !up ||
        (sizeof(C) == 2 && (L.Wy % 2 != 0 || (planes & 3) != 0))) {
      return (int)cudaErrorInvalidValue;
    }
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err != cudaSuccess) return (int)err;
    const size_t smem = pipe_stage_bytes<T, C>(E0, E1, L.reach, L.k) + tile;
    const dim3 grid(ntx * nty < sms ? ntx * nty : sms);
    return launch_leg(L.k == 2 ? up_pipe_kernel<T, C, 2>
                               : up_pipe_kernel<T, C, 3>,
                      kReg5Warps * 32, grid, smem, stream, x_out, x_in, b, xc,
                      bc, L);
  }
  if (ntx > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(nty, ntx);
  if (L.k == 2) {
    return early ? launch_tiles_k<T, C, 2, true>(n_off, grid, tile, stream,
                                                 x_out, x_in, b, xc, bc, L)
                 : launch_tiles_k<T, C, 2, false>(n_off, grid, tile, stream,
                                                  x_out, x_in, b, xc, bc, L);
  }
  return early ? launch_tiles_k<T, C, 3, true>(n_off, grid, tile, stream,
                                               x_out, x_in, b, xc, bc, L)
               : launch_tiles_k<T, C, 3, false>(n_off, grid, tile, stream,
                                                x_out, x_in, b, xc, bc, L);
}

template <typename Kernel, typename T, typename C>
int launch_nf(Kernel fn, int threads, dim3 grid, size_t smem,
              cudaStream_t stream, T* x_out, const T* x_in, const T* b,
              const T* xc, T* bc, const C* planes, const amg::LevelDesc& L,
              const Stencil& so) {
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fn<<<grid, threads, smem, stream>>>(x_out, x_in, b, xc, bc, planes, L, so);
  return (int)cudaGetLastError();
}

template <typename T, typename C, int K, bool DOWN>
int launch_nf_k(int n_off, dim3 grid, size_t smem, cudaStream_t stream,
                T* x_out, const T* x_in, const T* b, const T* xc, T* bc,
                const C* planes, const amg::LevelDesc& L, const Stencil& so) {
  if (n_off == 5) {
    return launch_nf(
        leg_nf_kernel<T, K, 5, kReg5Warps, kReg5Rows, kReg5Cols, DOWN, C>,
        kReg5Warps * 32, grid, smem, stream, x_out, x_in, b, xc, bc, planes,
        L, so);
  }
  return launch_nf(
      leg_nf_kernel<T, K, 9, kReg9Warps, kReg9Rows, kReg9Cols, DOWN, C>,
      kReg9Warps * 32, grid, smem, stream, x_out, x_in, b, xc, bc, planes, L,
      so);
}

// A non-factored leg of a tiled level (L.tile_x > 0) as one launch: the
// down leg K1 (bc, the R planes) or the up leg K2 (xc, the P planes), with
// the thread maps of the factored tiles
template <typename T, typename C>
int run_nf_tiles(const amg::LevelDesc& L, const Stencil& so, const C* planes,
                 cudaStream_t stream, T* x_out, const T* x_in, const T* b,
                 const T* xc, T* bc) {
  const bool down = bc != nullptr;
  const int n_off = L.st.n;
  const int halo =
      down ? amg::nf_down_halo(L.n_steps, L.reach, amg::nf_spill(so, L.k))
           : amg::leg_halo(L.n_steps, L.reach, false);
  const int E0 = L.tile_x + 2 * halo, E1 = L.tile_y + 2 * halo;
  const bool fits =
      (n_off == 5 && E0 <= kReg5Warps * kReg5Rows && E1 <= 32 * kReg5Cols) ||
      (n_off == 9 && E0 <= kReg9Warps * kReg9Rows && E1 <= 32 * kReg9Cols);
  const int ntx = amg::tiles_of(L.Wx, L.tile_x);
  const int nty = amg::tiles_of(L.Wy, L.tile_y);
  if (!fits || ntx > 65535 || so.n < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = amg::nf_smem_bytes(
      L.tile_x, L.tile_y, halo,
      amg::nf_scratch(down, L.tile_x, L.tile_y, halo, so, L.k),
      (int)sizeof(T));
  const dim3 grid(nty, ntx);
  if (L.k == 2) {
    return down ? launch_nf_k<T, C, 2, true>(n_off, grid, smem, stream, x_out,
                                             x_in, b, xc, bc, planes, L, so)
                : launch_nf_k<T, C, 2, false>(n_off, grid, smem, stream,
                                              x_out, x_in, b, xc, bc, planes,
                                              L, so);
  }
  return down ? launch_nf_k<T, C, 3, true>(n_off, grid, smem, stream, x_out,
                                           x_in, b, xc, bc, planes, L, so)
              : launch_nf_k<T, C, 3, false>(n_off, grid, smem, stream, x_out,
                                            x_in, b, xc, bc, planes, L, so);
}

dim3 grid_for(int rows, int cols) {
  const int gx = (cols + kThreads - 1) / kThreads;
  const int gy = rows < 65535 ? (rows > 0 ? rows : 1) : 65535;
  return dim3(gx, gy);
}

// the steps of one leg; the first reads x_in and writes all of x_out
template <typename T, typename C>
void run_steps(T* x_out, const T* x_in, const T* b, const C* A,
               const C* dinv, const Stencil& st, const ColorGrid& cg,
               const int* steps, int n_steps, T omega, int Wx, int Wy,
               bool first_full, cudaStream_t stream) {
  const dim3 grid = grid_for(Wx, Wy);
  for (int s = 0; s < n_steps; ++s) {
    const bool full = first_full && s == 0;
    color_step_kernel<T, C><<<grid, kThreads, 0, stream>>>(
        x_out, full ? x_in : x_out, b, A, dinv, st, cg, steps[s], omega, Wx,
        Wy, full ? 1 : 0);
  }
}

// K1: on a tiled level (tile_x > 0) one launch of tiles (r and g unused),
// else pass by pass
template <typename T, typename C>
int fused_down(T* x_out, const T* x_in, const T* b, const C* A,
               const C* dinv, const C* Tp, const C* S, T* r, T* g, T* bc,
               const int* offs, int n_off, const int* ctab, int ca, int cb,
               const int* steps, int n_steps, double omega, int Wx, int Wy,
               int Wxc, int Wyc, int k, int tile_x, int tile_y,
               void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (tile_x > 0) {
    amg::LevelDesc L;
    if (amg::fill_level(&L, A, dinv, Tp, S, 0, 0, 0, 0, 0, Wx, Wy, Wxc, Wyc,
                        k, tile_x, tile_y, offs, n_off, ctab, ca, cb, steps,
                        n_steps, omega)) {
      return (int)cudaErrorInvalidValue;
    }
    return run_tiles<T, C>(L, n_off, false, stream, x_out, x_in, b,
                           (const T*)nullptr, bc);
  }
  Stencil st;
  ColorGrid cg;
  if (amg::make_stencil(&st, offs, n_off) ||
      amg::make_colors(&cg, ctab, ca, cb) || n_steps < 1) {
    return (int)cudaErrorInvalidValue;
  }
  run_steps<T, C>(x_out, x_in, b, A, dinv, st, cg, steps, n_steps, (T)omega,
                  Wx, Wy, true, stream);
  residual_scale_kernel<T, C><<<grid_for(Wx, Wy), kThreads, 0, stream>>>(
      r, g, x_out, b, A, S, st, Wx, Wy);
  restrict_terms_kernel<T, C><<<grid_for(Wx, Wy), kThreads, 0, stream>>>(
      r, g, A, Tp, st, Wx, Wy);
  box_sum_kernel<T><<<grid_for(Wxc, Wyc), kThreads, 0, stream>>>(
      bc, r, Wx, Wy, Wxc, Wyc, k);
  return (int)cudaGetLastError();
}

// K2: on a tiled level one launch of tiles, else pass by pass
template <typename T, typename C>
int fused_up(T* x_out, const T* x_in, const T* b, const C* A, const C* dinv,
             const C* Tp, const C* S, const T* xc, const int* offs,
             int n_off, const int* ctab, int ca, int cb, const int* steps,
             int n_steps, double omega, int Wx, int Wy, int Wxc, int Wyc,
             int k, int tile_x, int tile_y, int pipelined, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (tile_x > 0) {
    amg::LevelDesc L;
    if (amg::fill_level(&L, A, dinv, Tp, S, 0, 0, 0, 0, 0, Wx, Wy, Wxc, Wyc,
                        k, tile_x, tile_y, offs, n_off, ctab, ca, cb, steps,
                        n_steps, omega)) {
      return (int)cudaErrorInvalidValue;
    }
    return run_tiles<T, C>(L, n_off, pipelined != 0, stream, x_out, x_in, b,
                           xc, (T*)nullptr);
  }
  Stencil st;
  ColorGrid cg;
  if (amg::make_stencil(&st, offs, n_off) ||
      amg::make_colors(&cg, ctab, ca, cb) || (k != 2 && k != 3)) {
    return (int)cudaErrorInvalidValue;
  }
  correct_kernel<T, C><<<grid_for(Wx, Wy), kThreads, 0, stream>>>(
      x_out, x_in, xc, A, Tp, S, st, Wx, Wy, Wyc, k);
  run_steps<T, C>(x_out, x_out, b, A, dinv, st, cg, steps, n_steps, (T)omega,
                  Wx, Wy, false, stream);
  return (int)cudaGetLastError();
}

template <typename T, typename C>
int fused_updown(T* x_out, const T* x_in, const T* b, const C* A,
                 const C* dinv, const C* Tp, const C* S, const T* xc, T* bc,
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
  return run_tiles<T, C>(L, n_off, false, (cudaStream_t)stream_ptr, x_out,
                         x_in, b, xc, bc);
}

// K1 on a non-factored level: on a tiled level (tile_x > 0) one launch of
// tiles (r unused), else the presmooth passes (the first reads x_in,
// nullptr the zero start), r = b - A x, then the R-plane restriction
template <typename T, typename C>
int fused_down_nf(T* x_out, const T* x_in, const T* b, const C* A,
                  const C* dinv, const C* R, T* r, T* bc, const int* offs,
                  int n_off, const int* ctab, int ca, int cb,
                  const int* steps, int n_steps, double omega,
                  const int* offs_r, int n_r, int Wx, int Wy, int Wxc,
                  int Wyc, int k, int tile_x, int tile_y, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  Stencil st, sr;
  ColorGrid cg;
  if (amg::make_stencil(&st, offs, n_off) ||
      amg::make_stencil(&sr, offs_r, n_r) ||
      amg::make_colors(&cg, ctab, ca, cb) || n_steps < 1 || k < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (tile_x > 0) {
    amg::LevelDesc L;
    if (amg::fill_level(&L, A, dinv, nullptr, nullptr, 0, 0, 0, 0, 0, Wx, Wy,
                        Wxc, Wyc, k, tile_x, tile_y, offs, n_off, ctab, ca,
                        cb, steps, n_steps, omega)) {
      return (int)cudaErrorInvalidValue;
    }
    return run_nf_tiles<T, C>(L, sr, R, stream, x_out, x_in, b,
                              (const T*)nullptr, bc);
  }
  run_steps<T, C>(x_out, x_in, b, A, dinv, st, cg, steps, n_steps, (T)omega,
                  Wx, Wy, true, stream);
  residual_kernel<T, C><<<grid_for(Wx, Wy), kThreads, 0, stream>>>(
      r, x_out, b, A, st, Wx, Wy);
  restrict_planes_kernel<T, C><<<grid_for(Wxc, Wyc), kThreads, 0, stream>>>(
      bc, r, R, sr, Wx, Wy, Wxc, Wyc, k);
  return (int)cudaGetLastError();
}

// K2 on a non-factored level: on a tiled level one launch of tiles, else
// the P-plane correction, then the postsmooth passes in place
template <typename T, typename C>
int fused_up_nf(T* x_out, const T* x_in, const T* b, const C* A,
                const C* dinv, const C* P, const T* xc, const int* offs,
                int n_off, const int* ctab, int ca, int cb, const int* steps,
                int n_steps, double omega, const int* offs_p, int n_p, int Wx,
                int Wy, int Wxc, int Wyc, int k, int tile_x, int tile_y,
                void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  Stencil st, sp;
  ColorGrid cg;
  if (amg::make_stencil(&st, offs, n_off) ||
      amg::make_stencil(&sp, offs_p, n_p) ||
      amg::make_colors(&cg, ctab, ca, cb) || (k != 2 && k != 3)) {
    return (int)cudaErrorInvalidValue;
  }
  if (tile_x > 0) {
    amg::LevelDesc L;
    if (amg::fill_level(&L, A, dinv, nullptr, nullptr, 0, 0, 0, 0, 0, Wx, Wy,
                        Wxc, Wyc, k, tile_x, tile_y, offs, n_off, ctab, ca,
                        cb, steps, n_steps, omega)) {
      return (int)cudaErrorInvalidValue;
    }
    return run_nf_tiles<T, C>(L, sp, P, stream, x_out, x_in, b, xc,
                              (T*)nullptr);
  }
  correct_planes_kernel<T, C><<<grid_for(Wx, Wy), kThreads, 0, stream>>>(
      x_out, x_in, xc, P, sp, Wx, Wy, Wxc, Wyc, k);
  run_steps<T, C>(x_out, x_out, b, A, dinv, st, cg, steps, n_steps, (T)omega,
                  Wx, Wy, false, stream);
  return (int)cudaGetLastError();
}

}  // namespace

// The shared memory of a non-factored tile (down: the R offsets, else the
// P offsets), for the wrapper's plan to be checked against; -1 for an
// offset list past the stencil's capacity.
extern "C" int amg_nf_tile_smem_bytes(int down, int tx, int ty, int n_steps,
                                      int reach, const int* offs, int n,
                                      int k, int itemsize) {
  Stencil s;
  if (amg::make_stencil(&s, offs, n) || k < 1) return -1;
  const int halo =
      down ? amg::nf_down_halo(n_steps, reach, amg::nf_spill(s, k))
           : amg::leg_halo(n_steps, reach, false);
  return (int)amg::nf_smem_bytes(
      tx, ty, halo, amg::nf_scratch(down != 0, tx, ty, halo, s, k), itemsize);
}

// The tensor maps of a staged K3's bf16 planes (A, dinv, S over E0 rows of
// the box, T over E0 + 2 reach) into out, 4 x 128 bytes, for the wrapper to
// keep with the leg cache.  Returns a CUDA error code.
extern "C" int amg_updown_plane_maps(void* out, const void* A,
                                     const void* dinv, const void* Tp,
                                     const void* S, int Wx, int Wy, int E0,
                                     int reach) {
  return amg::updown_plane_maps(out, A, dinv, Tp, S, Wx, Wy, E0, reach);
}

// The stage of a staged K3's E0 x E1 box, in bytes, for the wrapper's plan
// to be checked against.
extern "C" int amg_updown_stage_bytes(int E0, int E1, int reach, int k,
                                      int coef_itemsize, int itemsize) {
  return (int)amg::updown_stage(E0, E1, reach, k, coef_itemsize, itemsize)
      .bytes;
}

// K3 staged (updown_stage.cuh; the wrapper's plan_updown_staged): float32
// vectors under bf16 planes on a tiled 5-point level, the planes' tensor
// maps encoded once by amg_updown_plane_maps
extern "C" int amg_fused_updown_staged_f32_bf16(
    void* x_out, const void* x_in, const void* b, const void* A,
    const void* dinv, const void* Tp, const void* S, const void* xc, void* bc,
    const void* plane_maps, const int* offs, int n_off, const int* ctab,
    int ca, int cb, const int* steps, int n_steps, double omega, int Wx,
    int Wy, int Wxc, int Wyc, int k, int tile_x, int tile_y, void* stream) {
  amg::LevelDesc L;
  if (amg::fill_level(&L, A, dinv, Tp, S, 0, 0, 0, 0, 0, Wx, Wy, Wxc, Wyc, k,
                      tile_x, tile_y, offs, n_off, ctab, ca, cb, steps,
                      n_steps, omega) ||
      tile_x < 1) {
    return (int)cudaErrorInvalidValue;
  }
  return amg::run_updown_staged<float, __nv_bfloat16>(
      L, plane_maps, (cudaStream_t)stream, (float*)x_out, (const float*)x_in,
      (const float*)b, (const float*)xc, (float*)bc);
}

// one entry per (vector, plane) type: T vectors, C planes A, dinv, T, S
#define AMG_DEFINE_LEGS(SUFFIX, T, C)                                          \
  extern "C" int amg_fused_down_##SUFFIX(                                      \
      void* x_out, const void* x_in, const void* b, const void* A,             \
      const void* dinv, const void* Tp, const void* S, void* r, void* g,       \
      void* bc, const int* offs, int n_off, const int* ctab, int ca, int cb,   \
      const int* steps, int n_steps, double omega, int Wx, int Wy, int Wxc,    \
      int Wyc, int k, int tile_x, int tile_y, void* stream) {                  \
    return fused_down<T, C>((T*)x_out, (const T*)x_in, (const T*)b,            \
                         (const C*)A, (const C*)dinv, (const C*)Tp,            \
                         (const C*)S, (T*)r, (T*)g, (T*)bc, offs, n_off,       \
                         ctab, ca, cb, steps, n_steps, omega, Wx, Wy, Wxc,     \
                         Wyc, k, tile_x, tile_y, stream);                      \
  }                                                                            \
  extern "C" int amg_fused_up_##SUFFIX(                                        \
      void* x_out, const void* x_in, const void* b, const void* A,             \
      const void* dinv, const void* Tp, const void* S, const void* xc,         \
      const int* offs, int n_off, const int* ctab, int ca, int cb,             \
      const int* steps, int n_steps, double omega, int Wx, int Wy, int Wxc,    \
      int Wyc, int k, int tile_x, int tile_y, int pipelined, void* stream) {   \
    return fused_up<T, C>((T*)x_out, (const T*)x_in, (const T*)b, (const C*)A, \
                       (const C*)dinv, (const C*)Tp, (const C*)S,              \
                       (const T*)xc, offs, n_off, ctab, ca, cb, steps,         \
                       n_steps, omega, Wx, Wy, Wxc, Wyc, k, tile_x, tile_y,    \
                       pipelined, stream);                                     \
  }                                                                            \
  extern "C" int amg_fused_updown_##SUFFIX(                                    \
      void* x_out, const void* x_in, const void* b, const void* A,             \
      const void* dinv, const void* Tp, const void* S, const void* xc,         \
      void* bc, const int* offs, int n_off, const int* ctab, int ca, int cb,   \
      const int* steps, int n_steps, double omega, int Wx, int Wy, int Wxc,    \
      int Wyc, int k, int tile_x, int tile_y, void* stream) {                  \
    return fused_updown<T, C>((T*)x_out, (const T*)x_in, (const T*)b,          \
                           (const C*)A, (const C*)dinv, (const C*)Tp,          \
                           (const C*)S, (const T*)xc, (T*)bc, offs, n_off,     \
                           ctab, ca, cb, steps, n_steps, omega, Wx, Wy, Wxc,   \
                           Wyc, k, tile_x, tile_y, stream);                    \
  }

// the non-factored entries: C planes A, dinv, R, P; a tile as the
// factored entries take it ((0, 0): pass by pass)
#define AMG_DEFINE_LEGS_NF(SUFFIX, T, C)                                       \
  extern "C" int amg_fused_down_nf_##SUFFIX(                                   \
      void* x_out, const void* x_in, const void* b, const void* A,             \
      const void* dinv, const void* R, void* r, void* bc, const int* offs,     \
      int n_off, const int* ctab, int ca, int cb, const int* steps,            \
      int n_steps, double omega, const int* offs_r, int n_r, int Wx, int Wy,   \
      int Wxc, int Wyc, int k, int tile_x, int tile_y, void* stream) {         \
    return fused_down_nf<T, C>((T*)x_out, (const T*)x_in, (const T*)b,         \
                               (const C*)A, (const C*)dinv, (const C*)R,       \
                               (T*)r, (T*)bc, offs, n_off, ctab, ca, cb,       \
                               steps, n_steps, omega, offs_r, n_r, Wx, Wy,     \
                               Wxc, Wyc, k, tile_x, tile_y, stream);           \
  }                                                                            \
  extern "C" int amg_fused_up_nf_##SUFFIX(                                     \
      void* x_out, const void* x_in, const void* b, const void* A,             \
      const void* dinv, const void* P, const void* xc, const int* offs,        \
      int n_off, const int* ctab, int ca, int cb, const int* steps,            \
      int n_steps, double omega, const int* offs_p, int n_p, int Wx, int Wy,   \
      int Wxc, int Wyc, int k, int tile_x, int tile_y, void* stream) {         \
    return fused_up_nf<T, C>((T*)x_out, (const T*)x_in, (const T*)b,           \
                             (const C*)A, (const C*)dinv, (const C*)P,         \
                             (const T*)xc, offs, n_off, ctab, ca, cb, steps,   \
                             n_steps, omega, offs_p, n_p, Wx, Wy, Wxc, Wyc, k, \
                             tile_x, tile_y, stream);                          \
  }

AMG_DEFINE_LEGS(f32, float, float)
AMG_DEFINE_LEGS(f64, double, double)
AMG_DEFINE_LEGS(f32_bf16, float, __nv_bfloat16)
AMG_DEFINE_LEGS(f64_bf16, double, __nv_bfloat16)
AMG_DEFINE_LEGS_NF(f32, float, float)
AMG_DEFINE_LEGS_NF(f64, double, double)
AMG_DEFINE_LEGS_NF(f32_bf16, float, __nv_bfloat16)
AMG_DEFINE_LEGS_NF(f64_bf16, double, __nv_bfloat16)
