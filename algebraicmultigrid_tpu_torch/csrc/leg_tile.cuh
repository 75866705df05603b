// One leg of the V-cycle on a Lat2D level, computed tile by tile with the
// tile plus a halo of x in shared memory: the device code of the legs K1,
// K2 and K3 (vcycle_legs.cu), of the tail levels of the whole-tail kernel
// K4 (tail_levels.cuh) and of the top level of the whole-subcycle kernel
// K9 (subcycle_kernel.cu); below them, the non-factored legs of K1, K2
// and K4's grid levels (tile_down_nf, tile_up_nf: the R and P planes in
// place of T and S).
//
// A leg is up to four parts, in this order:
//   correction  x = x_in + (Tup - S (A Tup)),  Tup = T * upsample_k(x_c);
//   color steps x += omega dinv (b - A x) on the cells of each step's color;
//   restriction r = b - A x, g = S r, b_c = box_k-sum(T (r - A g));
//   store       x to the output over the tile.
// K3 is correction + steps + restriction (the up leg of one cycle and the
// down leg of the next), a down leg steps + restriction (from x_in or from
// zero), an up leg correction + steps.
//
// Halo erosion (the design of K5/K7, sweep_tile.cuh, carried through the
// whole leg).  A tile's extents are multiples of k and it starts at a
// multiple of k, so every coarse cell's (clipped) k x k box lies in exactly
// one tile, which sums it.  The block loads x over the tile plus a halo of
// H cells per side (the box), zero outside the grid, forming the
// correction there: it reads only device memory (x_in, T, S, the planes and
// x_c, Tup staged on the box plus one reach), so it is exact on the whole
// box.  Color step s updates only the cells at least (s+1)*reach from the
// box's faces, whose neighbours were exact after step s-1, so after n steps
// x is exact n*reach inside the box.  The restriction needs r and g on the
// tile plus one reach and x exact one reach further: a leg with a
// restriction has H = (n + 2) * reach, one without H = n * reach.  Tiles
// never wait for each other, and r and g never leave shared memory.
//
// Every cell sums its stencil in offset order, as stencil.cuh does, and
// each coarse cell its box column by column, as box_cell does.  Only the
// coefficient planes are read through the non-coherent path: in K4 and K9
// the vectors (x, b, x_c) are written by earlier phases of the same launch.
// The planes A, T and S are of type C and dinv of type D (stencil.cuh): a
// bf16 coefficient is converted to T where it is loaded, so the registers,
// the shared-memory buffers and the arithmetic are all of type T.
//
// Each thread keeps its cells' coefficients in registers (tile_leg_reg), so
// a tile is taken only by a 5- or 9-point level whose box (tile + 2 halo)
// fits the block's thread map, 64 x 64 cells: the wrappers plan it from the
// shapes, and a level past it runs K2 then K1 (K3) or pass by pass (K1,
// K2, K4, K9).  Such a box's buffers take at most ~100 KB of shared
// memory.  A byte per box cell holds its color (0xFF outside the grid),
// read by every step.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "stencil.cuh"

namespace amg {

constexpr unsigned char kOutside = 0xFF;

// One Lat2D level of a leg: its planes, shapes, stencil, coloring and step
// list, its tile (0 x 0: the level runs pass by pass) and, in the whole-tail
// kernels' work buffer, the element offsets of its vectors.
struct LevelDesc {
  const void* A;  // [nA, Wx, Wy] stencil planes
  const void* dinv;
  const void* Tp;
  const void* S;
  int64_t x_off;  // element offsets into the work buffer (a tail's level 0
  int64_t b_off;  // uses the call's x_out and b_in instead of x_off, b_off)
  int64_t r_off;
  int64_t g_off;
  int64_t m_off;  // x between a tiled level's down and up legs
  int Wx, Wy, Wxc, Wyc, k;
  int reach;           // max |offset| of the stencil
  int tile_x, tile_y;  // tile extents, multiples of k; 0: pass by pass
  int n_steps;
  int steps[kMaxSteps];
  double omega;
  Stencil st;
  ColorGrid cg;
};

// Fill one descriptor; returns a CUDA error code.
inline int fill_level(LevelDesc* L, const void* A, const void* dinv,
                      const void* Tp, const void* S, int64_t x_off,
                      int64_t b_off, int64_t r_off, int64_t g_off,
                      int64_t m_off, int Wx, int Wy, int Wxc, int Wyc, int k,
                      int tile_x, int tile_y, const int* offs, int n_off,
                      const int* ctab, int ca, int cb, const int* steps,
                      int n_steps, double omega) {
  if (n_steps < 1 || n_steps > kMaxSteps || (k != 2 && k != 3) ||
      tile_x < 0 || tile_y < 0 || tile_x % k != 0 || tile_y % k != 0 ||
      (tile_x == 0) != (tile_y == 0) || make_stencil(&L->st, offs, n_off) ||
      make_colors(&L->cg, ctab, ca, cb)) {
    return (int)cudaErrorInvalidValue;
  }
  L->A = A;
  L->dinv = dinv;
  L->Tp = Tp;
  L->S = S;
  L->x_off = x_off;
  L->b_off = b_off;
  L->r_off = r_off;
  L->g_off = g_off;
  L->m_off = m_off;
  L->Wx = Wx;
  L->Wy = Wy;
  L->Wxc = Wxc;
  L->Wyc = Wyc;
  L->k = k;
  L->reach = 0;
  for (int q = 0; q < n_off; ++q) {
    const int ax = offs[2 * q] < 0 ? -offs[2 * q] : offs[2 * q];
    const int ay = offs[2 * q + 1] < 0 ? -offs[2 * q + 1] : offs[2 * q + 1];
    L->reach = ax > L->reach ? ax : L->reach;
    L->reach = ay > L->reach ? ay : L->reach;
  }
  L->tile_x = tile_x;
  L->tile_y = tile_y;
  L->n_steps = n_steps;
  for (int s = 0; s < n_steps; ++s) L->steps[s] = steps[s];
  L->omega = omega;
  return 0;
}

// halo of a leg with or without a restriction
__host__ __device__ inline int leg_halo(int n_steps, int reach,
                                        bool restriction) {
  return (n_steps + (restriction ? 2 : 0)) * reach;
}

// Shared memory of one tile: x over the box, a scratch area (Tup over the
// box plus one reach, or r and g over the tile plus one reach) and a color
// byte per box cell.
__host__ __device__ inline size_t tile_smem_bytes(int tx, int ty, int halo,
                                                  int reach, int itemsize) {
  const size_t e = (size_t)(tx + 2 * halo) * (ty + 2 * halo);
  const size_t up = (size_t)(tx + 2 * halo + 2 * reach) *
                    (ty + 2 * halo + 2 * reach);
  const size_t rg = 2 * (size_t)(tx + 2 * reach) * (ty + 2 * reach);
  return (e + (up > rg ? up : rg)) * itemsize + ((e + 15) / 16) * 16;
}

// The loaded box of tile (ti, tj): its cell (e0, e1) is grid cell
// (ox + e0, oy + e1); the tile is [i0, i0 + tx) x [j0, j0 + ty).
struct Box {
  int i0, j0, tx, ty, h, E0, E1, ox, oy;
};

__device__ __forceinline__ Box make_box(int ti, int tj, int tx, int ty,
                                        int h) {
  Box bx;
  bx.i0 = ti * tx;
  bx.j0 = tj * ty;
  bx.tx = tx;
  bx.ty = ty;
  bx.h = h;
  bx.E0 = tx + 2 * h;
  bx.E1 = ty + 2 * h;
  bx.ox = bx.i0 - h;
  bx.oy = bx.j0 - h;
  return bx;
}

__device__ __forceinline__ bool inside(int i, int j, int Wx, int Wy) {
  return i >= 0 && i < Wx && j >= 0 && j < Wy;
}

// f(e0, e1) for e0 in [lo0, hi0), e1 in [lo1, hi1): warps over rows, lanes
// along a row
template <typename F>
__device__ __forceinline__ void for_rect(int lo0, int hi0, int lo1, int hi1,
                                         F&& f) {
  const int lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  for (int e0 = lo0 + (int)(threadIdx.x >> 5); e0 < hi0; e0 += nw) {
    for (int e1 = lo1 + lane; e1 < hi1; e1 += 32) f(e0, e1);
  }
}

template <typename T>
struct TileSmem {
  T* xs;             // x over the box
  T* sc;             // scratch: Tup, or r then g
  unsigned char* cs; // colors over the box
};

template <typename T>
__device__ __forceinline__ TileSmem<T> carve(unsigned char* base,
                                             const Box& bx, int reach) {
  const int e = bx.E0 * bx.E1;
  const int up = (bx.E0 + 2 * reach) * (bx.E1 + 2 * reach);
  const int rg = 2 * (bx.tx + 2 * reach) * (bx.ty + 2 * reach);
  TileSmem<T> sm;
  sm.xs = reinterpret_cast<T*>(base);
  sm.sc = sm.xs + e;
  sm.cs = reinterpret_cast<unsigned char*>(sm.sc + (up > rg ? up : rg));
  return sm;
}

// the dynamic shared memory this block was launched with
__device__ __forceinline__ unsigned dynamic_smem_bytes() {
  unsigned v;
  asm volatile("mov.u32 %0, %%dynamic_smem_size;" : "=r"(v));
  return v;
}

// A tile's buffers, after checking that the launch gave the block room
// for them (a wrong size traps rather than overrun shared memory).
template <typename T>
__device__ __forceinline__ TileSmem<T> tile_buffers(unsigned char* base,
                                                    unsigned offset,
                                                    const Box& bx,
                                                    int reach) {
  if (offset + tile_smem_bytes(bx.tx, bx.ty, bx.h, reach, (int)sizeof(T)) >
      dynamic_smem_bytes()) {
    __trap();
  }
  return carve<T>(base + offset, bx, reach);
}

// Tup = T * upsample_k(x_c) over the box plus one reach, 0 outside the grid
// (T's plane of type C)
template <int K, typename T, typename C>
__device__ void box_tup(const LevelDesc& L, const TileSmem<T>& sm,
                        const Box& bx, const T* xc) {
  const C* __restrict__ Tp = (const C*)L.Tp;
  const int r = L.reach, U1 = bx.E1 + 2 * r;
  for_rect(0, bx.E0 + 2 * r, 0, U1, [&](int u0, int u1) {
    const int i = bx.ox - r + u0, j = bx.oy - r + u1;
    sm.sc[u0 * U1 + u1] = inside(i, j, L.Wx, L.Wy)
                              ? coef<T>(Tp, (int64_t)i * L.Wy + j) *
                                    xc[coarse_of<K>(i, j, L.Wyc)]
                              : T(0);
  });
}

// The tile's coarse cells of b_c from T (r - A g) on the tile (ts, over
// the tile plus one reach): each its clipped k x k box, column by column.
template <typename T>
__device__ void box_sums(const LevelDesc& L, const Box& bx, const T* ts,
                         T* bc) {
  const int k = L.k, r = L.reach, G1 = bx.ty + 2 * r;
  const int Wx = L.Wx, Wy = L.Wy;
  const int kx = bx.tx / k, ky = bx.ty / k;
  const int I0 = bx.i0 / k, J0 = bx.j0 / k;
  for_rect(0, kx, 0, ky, [&](int w0, int w1) {
    const int I = I0 + w0, J = J0 + w1;
    if (I >= L.Wxc || J >= L.Wyc) return;
    T acc = T(0);
    for (int dj = 0; dj < k && k * J + dj < Wy; ++dj) {
      T col = T(0);
      for (int di = 0; di < k && k * I + di < Wx; ++di) {
        col += ts[(k * w0 + di + r) * G1 + (k * w1 + dj + r)];
      }
      acc += col;
    }
    bc[(int64_t)I * L.Wyc + J] = acc;
  });
}

// ---- where a tile's inputs come from ------------------------------------
//
// A source gives what a tile reads at its box cell (e0, e1) (its own index
// e of the cell, from index(e0, e1, flat box index), grid index g, `in`:
// inside the grid; zero outside): a coefficient plane q, dinv, b, x (zero
// where the leg starts from zero), S and T; and Tup = T * upsample_k(x_c) at
// (u0, u1) of the box plus one reach.  DeviceIn reads device memory, the
// coefficient planes through the non-coherent path; vcycle_legs.cu's
// pipelined up leg reads a copy of the box staged in shared memory.

template <typename T, int K, typename C = T, typename D = C>
struct DeviceIn {
  using Coef = C;
  const C* A;
  const D* dinv;
  const C* Tp;
  const C* S;
  const T* x;   // nullptr: zero
  const T* xc;  // nullptr: no correction
  const T* b;
  int64_t plane;
  int Wx, Wy, Wyc, r, ox, oy;

  __device__ int index(int, int, int e) const { return e; }
  __device__ T a(int q, int, bool in, int64_t g) const {
    return in ? coef_ldg<T>(A, q * plane + g) : T(0);
  }
  __device__ T d(int, bool in, int64_t g) const {
    return in ? coef_ldg<T>(dinv, g) : T(0);
  }
  __device__ T rhs(int, bool in, int64_t g) const { return in ? b[g] : T(0); }
  __device__ T xv(int, bool in, int64_t g) const {
    return in && x != nullptr ? x[g] : T(0);
  }
  __device__ T s(int, bool in, int64_t g) const {
    return in ? coef_ldg<T>(S, g) : T(0);
  }
  __device__ T t(int, bool in, int64_t g) const {
    return in ? coef_ldg<T>(Tp, g) : T(0);
  }
  __device__ T tup(int u0, int u1) const {
    const int i = ox - r + u0, j = oy - r + u1;
    return inside(i, j, Wx, Wy) ? coef_ldg<T>(Tp, (int64_t)i * Wy + j) *
                                      xc[coarse_of<K>(i, j, Wyc)]
                                : T(0);
  }
};

template <typename T, int K, typename C = T, typename D = C>
__device__ __forceinline__ DeviceIn<T, K, C, D> device_in(const LevelDesc& L,
                                                          const Box& bx,
                                                          const T* x,
                                                          const T* xc,
                                                          const T* b) {
  return DeviceIn<T, K, C, D>{(const C*)L.A, (const D*)L.dinv, (const C*)L.Tp,
                              (const C*)L.S, x, xc, b, (int64_t)L.Wx * L.Wy,
                              L.Wx, L.Wy, L.Wyc, L.reach, bx.ox, bx.oy};
}

// box cell (e0, e1) in r and g's area (the tile plus one reach) / the tile
__device__ __forceinline__ bool in_rg(const Box& bx, int r, int e0, int e1) {
  return e0 >= bx.h - r && e0 < bx.h + bx.tx + r && e1 >= bx.h - r &&
         e1 < bx.h + bx.ty + r;
}
__device__ __forceinline__ bool in_tile(const Box& bx, int e0, int e1) {
  return e0 >= bx.h && e0 < bx.h + bx.tx && e1 >= bx.h && e1 < bx.h + bx.ty;
}

// ---- the leg of one tile ------------------------------------------------
//
// Thread (w, lane) of WARPS warps owns the box cells (w + WARPS a,
// lane + 32 c), a < CI, c < CJ, and loads their NOFF planes, dinv and b
// into registers once, all in flight together; the steps read only shared
// memory.  (Reading the planes in place at every step makes each step a
// chain of dependent loads per cell: K3 at 4096^2 took 1.8-2.1 ms that way
// on an H100, kernel_variants.py, against 0.95 ms here.)  The box must fit
// (WARPS CI) x (32 CJ) cells: the wrappers' plans give a tile only to 5-
// and 9-point levels whose box fits; a box past it traps.
//
// A leg is tile_load (the first memory phase, ending on a barrier) then
// tile_run.  With EARLY every read of the tile is in tile_load (x before
// its correction, S and T too, into registers and the tile buffers), so a
// tile waits on device memory once; without it the correction reads x and
// S, the restriction S and T, each in its own phase (K3, K4, K9).

// the owned cells' registers; s and t only with EARLY
template <typename T, int NOFF, int CI, int CJ>
struct CellRegs {
  T a[CI][CJ][NOFF];
  T d[CI][CJ];
  T b[CI][CJ];
  T s[CI][CJ];
  T t[CI][CJ];
};

// The owned cells' coefficients and colors; x over the box (EARLY or no
// correction), Tup over the box plus one reach (a correction); with EARLY
// also S where the leg reads it (the box for a correction, r and g's area
// for a restriction) and T on the tile.  Ends on a block barrier.
template <typename T, int K, int NOFF, int WARPS, int CI, int CJ, bool EARLY,
          class Src>
__device__ __forceinline__ void tile_load(const LevelDesc& L,
                                          const TileSmem<T>& sm, const Box& bx,
                                          const Src& src, bool correct,
                                          bool restriction,
                                          CellRegs<T, NOFF, CI, CJ>& R) {
  const int Wx = L.Wx, Wy = L.Wy, r = L.reach, E0 = bx.E0, E1 = bx.E1;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int a = 0; a < CI; ++a) {
#pragma unroll
    for (int c = 0; c < CJ; ++c) {
      const int e0 = w + WARPS * a, e1 = lane + 32 * c;
      const int i = bx.ox + e0, j = bx.oy + e1;
      const bool box = e0 < E0 && e1 < E1;
      const bool in = box && inside(i, j, Wx, Wy);
      const int64_t g = in ? (int64_t)i * Wy + j : 0;
      const int e = box ? e0 * E1 + e1 : 0;
      const int es = box ? src.index(e0, e1, e) : 0;
#pragma unroll
      for (int q = 0; q < NOFF; ++q) R.a[a][c][q] = src.a(q, es, in, g);
      R.d[a][c] = src.d(es, in, g);
      R.b[a][c] = src.rhs(es, in, g);
      if constexpr (EARLY) {
        R.s[a][c] = correct || (restriction && in_rg(bx, r, e0, e1))
                        ? src.s(es, in, g)
                        : T(0);
        R.t[a][c] = restriction && in_tile(bx, e0, e1) ? src.t(es, in, g)
                                                       : T(0);
      }
      if (box) {
        sm.cs[e] =
            in ? (unsigned char)L.cg.tab[(i % L.cg.a) * L.cg.b + (j % L.cg.b)]
               : kOutside;
        if (EARLY || !correct) sm.xs[e] = src.xv(es, in, g);
      }
    }
  }
  if (correct) {
    // Tup over the box plus one reach: from the thread map where it fits
    // (each thread's loads in flight together), else cell by cell
    const int U0 = E0 + 2 * r, U1 = E1 + 2 * r;
    if (U0 <= WARPS * CI && U1 <= 32 * CJ) {
      T tv[CI][CJ];
#pragma unroll
      for (int a = 0; a < CI; ++a) {
#pragma unroll
        for (int c = 0; c < CJ; ++c) {
          const int u0 = w + WARPS * a, u1 = lane + 32 * c;
          tv[a][c] = u0 < U0 && u1 < U1 ? src.tup(u0, u1) : T(0);
        }
      }
#pragma unroll
      for (int a = 0; a < CI; ++a) {
#pragma unroll
        for (int c = 0; c < CJ; ++c) {
          const int u0 = w + WARPS * a, u1 = lane + 32 * c;
          if (u0 < U0 && u1 < U1) sm.sc[u0 * U1 + u1] = tv[a][c];
        }
      }
    } else if constexpr (EARLY) {
      __trap();  // the plans give an EARLY correction a Tup area that fits
    } else {
      box_tup<K, T, typename Src::Coef>(L, sm, bx, src.xc);
    }
  }
  __syncthreads();
}

// The color steps, from registers and shared memory (sx: the stencil's
// offsets in the box): step s updates the cells of its color at least
// (s + 1) reach inside the box.  Ends on a block barrier.  (tile_run keeps
// its own copy of these steps and of tile_store inline: calling them there
// changed the factored kernels' register allocation, K3 at 4096^2 8%
// slower on an H100, kernel_variants.py against.)
template <typename T, int NOFF, int WARPS, int CI, int CJ>
__device__ __forceinline__ void tile_steps(const LevelDesc& L,
                                           const TileSmem<T>& sm,
                                           const Box& bx,
                                           const CellRegs<T, NOFF, CI, CJ>& R,
                                           const int (&sx)[NOFF]) {
  const int r = L.reach, E0 = bx.E0, E1 = bx.E1;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const T omega = (T)L.omega;
  for (int s = 0; s < L.n_steps; ++s) {
    const int lo = (s + 1) * r;
    const unsigned char color = (unsigned char)L.steps[s];
#pragma unroll
    for (int a = 0; a < CI; ++a) {
#pragma unroll
      for (int c = 0; c < CJ; ++c) {
        const int e0 = w + WARPS * a, e1 = lane + 32 * c;
        if (e0 < lo || e0 >= E0 - lo || e1 < lo || e1 >= E1 - lo) continue;
        const int e = e0 * E1 + e1;
        if (sm.cs[e] != color) continue;
        T acc = T(0);
#pragma unroll
        for (int q = 0; q < NOFF; ++q) acc += R.a[a][c][q] * sm.xs[e + sx[q]];
        sm.xs[e] = sm.xs[e] + omega * R.d[a][c] * (R.b[a][c] - acc);
      }
    }
    __syncthreads();
  }
}

// x over the tile (its cells in the grid) to x_out.  Ends on a block
// barrier.
template <typename T, int WARPS, int CI, int CJ>
__device__ __forceinline__ void tile_store(const LevelDesc& L,
                                           const TileSmem<T>& sm,
                                           const Box& bx, T* x_out) {
  const int Wy = L.Wy, E1 = bx.E1, h = bx.h;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int a = 0; a < CI; ++a) {
#pragma unroll
    for (int c = 0; c < CJ; ++c) {
      const int e0 = w + WARPS * a, e1 = lane + 32 * c;
      const int t0 = e0 - h, t1 = e1 - h;
      if (t0 < 0 || t0 >= bx.tx || t1 < 0 || t1 >= bx.ty) continue;
      const int e = e0 * E1 + e1;
      if (sm.cs[e] != kOutside) {
        x_out[(int64_t)(bx.ox + e0) * Wy + (bx.oy + e1)] = sm.xs[e];
      }
    }
  }
  __syncthreads();
}

// The rest of the leg, from registers and shared memory: the correction
// (x = x_in + (Tup - S (A Tup)) over the box), the color steps, and either
// x over the tile to x_out or the restriction (r and g on the tile plus one
// reach, T (r - A g) on the tile, the tile's coarse cells of b_c) with x
// over the tile.  Ends on a block barrier.
template <typename T, int NOFF, int WARPS, int CI, int CJ, bool EARLY,
          class Src>
__device__ __forceinline__ void tile_run(const LevelDesc& L,
                                         const TileSmem<T>& sm, const Box& bx,
                                         const Src& src,
                                         const CellRegs<T, NOFF, CI, CJ>& R,
                                         bool correct, T* x_out, T* bc) {
  const int Wy = L.Wy, r = L.reach, E0 = bx.E0, E1 = bx.E1, h = bx.h;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;

  // the stencil's offsets in the box; those of the Tup and r/g areas are
  // formed in their phases, so that fewer registers stay live
  int sx[NOFF];
#pragma unroll
  for (int q = 0; q < NOFF; ++q) sx[q] = L.st.dx[q] * E1 + L.st.dy[q];

  if (correct) {
    const int U1 = E1 + 2 * r;
    int su[NOFF];
#pragma unroll
    for (int q = 0; q < NOFF; ++q) su[q] = L.st.dx[q] * U1 + L.st.dy[q];
#pragma unroll
    for (int a = 0; a < CI; ++a) {
#pragma unroll
      for (int c = 0; c < CJ; ++c) {
        const int e0 = w + WARPS * a, e1 = lane + 32 * c;
        if (e0 >= E0 || e1 >= E1) continue;
        const int e = e0 * E1 + e1;
        T v = T(0);
        if (sm.cs[e] != kOutside) {
          const int64_t g = (int64_t)(bx.ox + e0) * Wy + (bx.oy + e1);
          const int u = (e0 + r) * U1 + (e1 + r);
          T acc = T(0);
#pragma unroll
          for (int q = 0; q < NOFF; ++q) acc += R.a[a][c][q] * sm.sc[u + su[q]];
          if constexpr (EARLY) {
            v = sm.xs[e] + (sm.sc[u] - R.s[a][c] * acc);
          } else {
            v = src.xv(e, true, g) + (sm.sc[u] - src.s(e, true, g) * acc);
          }
        }
        sm.xs[e] = v;
      }
    }
    __syncthreads();
  }

  // the color steps
  const T omega = (T)L.omega;
  for (int s = 0; s < L.n_steps; ++s) {
    const int lo = (s + 1) * r;
    const unsigned char color = (unsigned char)L.steps[s];
#pragma unroll
    for (int a = 0; a < CI; ++a) {
#pragma unroll
      for (int c = 0; c < CJ; ++c) {
        const int e0 = w + WARPS * a, e1 = lane + 32 * c;
        if (e0 < lo || e0 >= E0 - lo || e1 < lo || e1 >= E1 - lo) continue;
        const int e = e0 * E1 + e1;
        if (sm.cs[e] != color) continue;
        T acc = T(0);
#pragma unroll
        for (int q = 0; q < NOFF; ++q) acc += R.a[a][c][q] * sm.xs[e + sx[q]];
        sm.xs[e] = sm.xs[e] + omega * R.d[a][c] * (R.b[a][c] - acc);
      }
    }
    __syncthreads();
  }

  if (bc == nullptr) {
#pragma unroll
    for (int a = 0; a < CI; ++a) {
#pragma unroll
      for (int c = 0; c < CJ; ++c) {
        const int e0 = w + WARPS * a, e1 = lane + 32 * c;
        const int t0 = e0 - h, t1 = e1 - h;
        if (t0 < 0 || t0 >= bx.tx || t1 < 0 || t1 >= bx.ty) continue;
        const int e = e0 * E1 + e1;
        if (sm.cs[e] != kOutside) {
          x_out[(int64_t)(bx.ox + e0) * Wy + (bx.oy + e1)] = sm.xs[e];
        }
      }
    }
    __syncthreads();
    return;
  }

  // r and g on the tile plus one reach (0 outside the grid)
  const int G0 = bx.tx + 2 * r, G1 = bx.ty + 2 * r;
  T* rs = sm.sc;
  T* gs = sm.sc + G0 * G1;
#pragma unroll
  for (int a = 0; a < CI; ++a) {
#pragma unroll
    for (int c = 0; c < CJ; ++c) {
      const int e0 = w + WARPS * a, e1 = lane + 32 * c;
      const int u0 = e0 - (h - r), u1 = e1 - (h - r);
      if (u0 < 0 || u0 >= G0 || u1 < 0 || u1 >= G1) continue;
      const int e = e0 * E1 + e1;
      T rv = T(0), gv = T(0);
      if (sm.cs[e] != kOutside) {
        T acc = T(0);
#pragma unroll
        for (int q = 0; q < NOFF; ++q) acc += R.a[a][c][q] * sm.xs[e + sx[q]];
        rv = R.b[a][c] - acc;
        if constexpr (EARLY) {
          gv = R.s[a][c] * rv;
        } else {
          gv = src.s(e, true, (int64_t)(bx.ox + e0) * Wy + (bx.oy + e1)) * rv;
        }
      }
      rs[u0 * G1 + u1] = rv;
      gs[u0 * G1 + u1] = gv;
    }
  }
  __syncthreads();

  // T (r - A g) over r on the tile, and x over the tile to x_out
  int sg[NOFF];
#pragma unroll
  for (int q = 0; q < NOFF; ++q) sg[q] = L.st.dx[q] * G1 + L.st.dy[q];
#pragma unroll
  for (int a = 0; a < CI; ++a) {
#pragma unroll
    for (int c = 0; c < CJ; ++c) {
      const int e0 = w + WARPS * a, e1 = lane + 32 * c;
      const int t0 = e0 - h, t1 = e1 - h;
      if (t0 < 0 || t0 >= bx.tx || t1 < 0 || t1 >= bx.ty) continue;
      const int e = e0 * E1 + e1;
      if (sm.cs[e] == kOutside) continue;
      const int64_t g = (int64_t)(bx.ox + e0) * Wy + (bx.oy + e1);
      const int u = (t0 + r) * G1 + (t1 + r);
      T acc = T(0);
#pragma unroll
      for (int q = 0; q < NOFF; ++q) acc += R.a[a][c][q] * gs[u + sg[q]];
      T tv;
      if constexpr (EARLY) {
        tv = R.t[a][c];
      } else {
        tv = src.t(e, true, g);
      }
      rs[u] = tv * (rs[u] - acc);
      x_out[g] = sm.xs[e];
    }
  }
  __syncthreads();
  box_sums<T>(L, bx, rs, bc);
  __syncthreads();
}

// One leg of tile (ti, tj) from device memory.  With xc the correction of
// x_in, else x starts from x_in (nullptr: zero); with bc the restriction
// (the halo of a down leg), else only x over the tile is written.  Ends on
// a block barrier.
template <typename T, int K, int NOFF, int WARPS, int CI, int CJ,
          bool EARLY = false, typename C = T, typename D = C>
__device__ void tile_leg_reg(const LevelDesc& L, unsigned char* base,
                             unsigned offset, int ti, int tj, const T* x_in,
                             const T* xc, const T* b, T* x_out, T* bc) {
  const Box bx = make_box(ti, tj, L.tile_x, L.tile_y,
                          leg_halo(L.n_steps, L.reach, bc != nullptr));
  if (bx.E0 > WARPS * CI || bx.E1 > 32 * CJ || blockDim.x != WARPS * 32) {
    __trap();
  }
  const TileSmem<T> sm = tile_buffers<T>(base, offset, bx, L.reach);
  const DeviceIn<T, K, C, D> src = device_in<T, K, C, D>(L, bx, x_in, xc, b);
  CellRegs<T, NOFF, CI, CJ> R;
  tile_load<T, K, NOFF, WARPS, CI, CJ, EARLY>(L, sm, bx, src, xc != nullptr,
                                              bc != nullptr, R);
  tile_run<T, NOFF, WARPS, CI, CJ, EARLY>(L, sm, bx, src, R, xc != nullptr,
                                          x_out, bc);
}

// The thread map of the whole-tail and whole-subcycle kernels' tiled legs:
// 16 warps of 4 x 2 cells, a box of up to 64 x 64 cells (512 threads a
// block, up to 128 registers a thread)
constexpr int kLegWarps = 16, kLegRows = 4, kLegCols = 2;

// A leg of a tiled level in the whole-tail and whole-subcycle kernels (see
// tile_leg_reg for the arguments); the plan gives tiles to 5- and 9-point
// levels only.
template <typename T, int K, typename C, typename D>
__device__ void tile_leg_k(const LevelDesc& L, unsigned char* base,
                           unsigned offset, int ti, int tj, const T* x_in,
                           const T* xc, const T* b, T* x_out, T* bc) {
  if (L.st.n == 9) {
    tile_leg_reg<T, K, 9, kLegWarps, kLegRows, kLegCols, false, C, D>(
        L, base, offset, ti, tj, x_in, xc, b, x_out, bc);
  } else if (L.st.n == 5) {
    tile_leg_reg<T, K, 5, kLegWarps, kLegRows, kLegCols, false, C, D>(
        L, base, offset, ti, tj, x_in, xc, b, x_out, bc);
  } else {
    __trap();
  }
}

template <typename T, typename C = T, typename D = C>
__device__ void tile_leg(const LevelDesc& L, unsigned char* base,
                         unsigned offset, int ti, int tj, const T* x_in,
                         const T* xc, const T* b, T* x_out, T* bc) {
  if (L.k == 2) {
    tile_leg_k<T, 2, C, D>(L, base, offset, ti, tj, x_in, xc, b, x_out, bc);
  } else {
    tile_leg_k<T, 3, C, D>(L, base, offset, ti, tj, x_in, xc, b, x_out, bc);
  }
}

// ---- the non-factored legs in tiles --------------------------------------
//
// A level without the factored stash restricts with b_c[c] = sum_q R_q[c]
// r[k c + d_q] (R over the coarse grid) and corrects with x += sum_q P_q[i]
// x_c[i / k + d_q] (P over the fine grid).  Each R and P coefficient is read
// once a leg, by its coarse cell or its box cell, so those planes are read
// from device memory where they are used; only A, dinv and b are reused
// across the steps and sit in the registers (CellRegs, as in the factored
// tile, without S and T).
//
// The down leg (K1): the steps from x_in (or zero), then r = b - A x on
// the tile plus the R offsets' spill (nf_spill) in shared memory, then the
// tile's coarse cells of b_c, each with one thread, consecutive threads
// along a coarse row.  x must be exact one reach beyond r's area, so the
// halo is (n_steps + 1) reach + spill (nf_down_halo).  The up leg (K2): x_c
// over the box's coarse window (nf_window, the P offsets' span around the
// box's coarse cells) staged in shared memory, x = x_in + the P-plane sum
// on every box cell in the grid (exact: it reads only device memory), then
// the steps; the halo is n_steps reach.  Terms in offset order, as
// restrict_planes_cell and correct_planes_cell sum them (stencil.cuh).

// the span of a stencil's offsets (and 0) along each axis
struct OffsetSpan {
  int lo0, hi0, lo1, hi1;
};

__host__ __device__ inline OffsetSpan offset_span(const Stencil& s) {
  OffsetSpan o{0, 0, 0, 0};
  for (int q = 0; q < s.n; ++q) {
    o.lo0 = s.dx[q] < o.lo0 ? s.dx[q] : o.lo0;
    o.hi0 = s.dx[q] > o.hi0 ? s.dx[q] : o.hi0;
    o.lo1 = s.dy[q] < o.lo1 ? s.dy[q] : o.lo1;
    o.hi1 = s.dy[q] > o.hi1 ? s.dy[q] : o.hi1;
  }
  return o;
}

// Cells of r a down tile needs beyond each face: its coarse cells (fine
// k I .. k I + k - 1) read fine k I + d over the R offsets d.
__host__ __device__ inline int nf_spill(const Stencil& sr, int k) {
  const OffsetSpan o = offset_span(sr);
  const int lo = -o.lo0 > -o.lo1 ? -o.lo0 : -o.lo1;
  const int hi = (o.hi0 > o.hi1 ? o.hi0 : o.hi1) - (k - 1);
  return lo > hi ? lo : hi;
}

__host__ __device__ inline int nf_down_halo(int n_steps, int reach,
                                            int spill) {
  return (n_steps + 1) * reach + spill;
}

// Coarse cells of x_c an up tile stages along an axis of E box cells: the
// box's coarse cells (at most ceil(E / k) + 1) and the P offsets' span.
__host__ __device__ inline int nf_window(int E, int k, int lo, int hi) {
  return (E + k - 1) / k + 1 + hi - lo;
}

// The scratch elements of a non-factored tile: r over the tile and spill
// (down), or the x_c window (up); s the R or P stencil.
__host__ __device__ inline int nf_scratch(bool down, int tx, int ty,
                                          int halo, const Stencil& s,
                                          int k) {
  if (down) {
    const int sp = nf_spill(s, k);
    return (tx + 2 * sp) * (ty + 2 * sp);
  }
  const OffsetSpan o = offset_span(s);
  return nf_window(tx + 2 * halo, k, o.lo0, o.hi0) *
         nf_window(ty + 2 * halo, k, o.lo1, o.hi1);
}

// Shared memory of a non-factored tile: x over the box, the scratch area
// and a color byte per box cell.
__host__ __device__ inline size_t nf_smem_bytes(int tx, int ty, int halo,
                                                int scratch, int itemsize) {
  const size_t e = (size_t)(tx + 2 * halo) * (ty + 2 * halo);
  return (e + (size_t)scratch) * itemsize + ((e + 15) / 16) * 16;
}

template <typename T>
__device__ __forceinline__ TileSmem<T> nf_buffers(unsigned char* base,
                                                  unsigned offset,
                                                  const Box& bx,
                                                  int scratch) {
  if (offset + nf_smem_bytes(bx.tx, bx.ty, bx.h, scratch, (int)sizeof(T)) >
      dynamic_smem_bytes()) {
    __trap();
  }
  TileSmem<T> sm;
  sm.xs = reinterpret_cast<T*>(base + offset);
  sm.sc = sm.xs + bx.E0 * bx.E1;
  sm.cs = reinterpret_cast<unsigned char*>(sm.sc + scratch);
  return sm;
}

// R and P terms a batch: the batch's loads are issued together, an index
// past the last plane reading the batch's first and adding zero.  On an
// H100 (kernel_variants.py legs nf, 4096^2's NoSymmetry hierarchy) the
// plain loops (one plane an iteration) took K1 at L0 0.85 ms with float32
// planes against 0.59 batched, K2 at L0 0.74 against 0.70; with bf16
// planes K1 0.61 against 0.58, K2 at L1 0.25 against 0.22.  Three P planes
// a batch spilled at L0 (K2 0.63 ms with bf16 planes).
constexpr int kRBatch = 8, kPBatch = 2;

template <int K>
__device__ __forceinline__ int floor_div(int a) {
  return a >= 0 ? a / K : -((K - 1 - a) / K);
}

// The down leg of tile (ti, tj) on a non-factored level: the steps from
// x_in (nullptr: zero), x over the tile to x_out and the tile's coarse
// cells of b_c from the R planes Rp (of type CR) with offsets sr.  Ends on
// a block barrier.
template <typename T, int K, int NOFF, int WARPS, int CI, int CJ,
          typename C = T, typename D = C, typename CR = C>
__device__ void tile_down_nf(const LevelDesc& L, const CR* __restrict__ Rp,
                             const Stencil& sr, unsigned char* base,
                             unsigned offset, int ti, int tj, const T* x_in,
                             const T* b, T* x_out, T* bc) {
  const int sp = nf_spill(sr, K);
  const Box bx = make_box(ti, tj, L.tile_x, L.tile_y,
                          nf_down_halo(L.n_steps, L.reach, sp));
  if (bx.E0 > WARPS * CI || bx.E1 > 32 * CJ || blockDim.x != WARPS * 32) {
    __trap();
  }
  const int G0 = bx.tx + 2 * sp, G1 = bx.ty + 2 * sp, E1 = bx.E1;
  const TileSmem<T> sm = nf_buffers<T>(base, offset, bx, G0 * G1);
  const DeviceIn<T, K, C, D> src =
      device_in<T, K, C, D>(L, bx, x_in, (const T*)nullptr, b);
  CellRegs<T, NOFF, CI, CJ> R;
  tile_load<T, K, NOFF, WARPS, CI, CJ, false>(L, sm, bx, src, false, false,
                                              R);
  int sx[NOFF];
#pragma unroll
  for (int q = 0; q < NOFF; ++q) sx[q] = L.st.dx[q] * E1 + L.st.dy[q];
  tile_steps<T, NOFF, WARPS, CI, CJ>(L, sm, bx, R, sx);

  // r = b - A x on the tile plus the spill (0 outside the grid), and x
  // over the tile to x_out
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, o = bx.h - sp;
  T* rs = sm.sc;
#pragma unroll
  for (int a = 0; a < CI; ++a) {
#pragma unroll
    for (int c = 0; c < CJ; ++c) {
      const int e0 = w + WARPS * a, e1 = lane + 32 * c;
      const int u0 = e0 - o, u1 = e1 - o;
      if (u0 < 0 || u0 >= G0 || u1 < 0 || u1 >= G1) continue;
      const int e = e0 * E1 + e1;
      T rv = T(0);
      if (sm.cs[e] != kOutside) {
        T acc = T(0);
#pragma unroll
        for (int q = 0; q < NOFF; ++q) acc += R.a[a][c][q] * sm.xs[e + sx[q]];
        rv = R.b[a][c] - acc;
        if (in_tile(bx, e0, e1)) {
          x_out[(int64_t)(bx.ox + e0) * L.Wy + (bx.oy + e1)] = sm.xs[e];
        }
      }
      rs[u0 * G1 + u1] = rv;
    }
  }
  __syncthreads();

  // b_c[I, J] = sum_q R_q[I, J] r[k I + dx_q, k J + dy_q]
  const int ky = bx.ty / K, nc = (bx.tx / K) * ky;
  const int I0 = bx.i0 / K, J0 = bx.j0 / K;
  const int64_t cplane = (int64_t)L.Wxc * L.Wyc;
  for (int v = threadIdx.x; v < nc; v += blockDim.x) {
    const int w0 = v / ky, w1 = v - w0 * ky;
    const int I = I0 + w0, J = J0 + w1;
    if (I >= L.Wxc || J >= L.Wyc) continue;
    const int64_t cell = (int64_t)I * L.Wyc + J;
    const T* rc = rs + (K * w0 + sp) * G1 + (K * w1 + sp);
    T acc = T(0);
    for (int q0 = 0; q0 < sr.n; q0 += kRBatch) {
      T rq[kRBatch], rr[kRBatch];
#pragma unroll
      for (int u = 0; u < kRBatch; ++u) {
        const int q = q0 + u < sr.n ? q0 + u : q0;
        rq[u] = coef_ldg<T>(Rp, q * cplane + cell);
        rr[u] = q0 + u < sr.n ? rc[sr.dx[q] * G1 + sr.dy[q]] : T(0);
      }
#pragma unroll
      for (int u = 0; u < kRBatch; ++u) acc += rq[u] * rr[u];
    }
    bc[cell] = acc;
  }
  __syncthreads();
}

// The up leg of tile (ti, tj) of tx x ty cells on a non-factored level
// (K2's tile is its level's, K4's its Transfer's): x = x_in + the P-plane
// sum (Pp of type C, offsets so) over the box, the steps, and x over the
// tile to x_out.  Ends on a block barrier.
template <typename T, int K, int NOFF, int WARPS, int CI, int CJ,
          typename C = T, typename D = C>
__device__ void tile_up_nf(const LevelDesc& L, const C* __restrict__ Pp,
                           const Stencil& so, unsigned char* base,
                           unsigned offset, int ti, int tj, int tx, int ty,
                           const T* x_in, const T* xc, const T* b, T* x_out) {
  const Box bx =
      make_box(ti, tj, tx, ty, leg_halo(L.n_steps, L.reach, false));
  if (bx.E0 > WARPS * CI || bx.E1 > 32 * CJ || blockDim.x != WARPS * 32) {
    __trap();
  }
  const OffsetSpan os = offset_span(so);
  const int C0 = nf_window(bx.E0, K, os.lo0, os.hi0);
  const int C1 = nf_window(bx.E1, K, os.lo1, os.hi1);
  const int E1 = bx.E1;
  const TileSmem<T> sm = nf_buffers<T>(base, offset, bx, C0 * C1);

  // x_c over the window: its cell (v0, v1) is coarse cell (c0 + v0, c1 +
  // v1), 0 outside the coarse grid
  const int c0 = floor_div<K>(bx.ox) + os.lo0;
  const int c1 = floor_div<K>(bx.oy) + os.lo1;
  for (int v = threadIdx.x; v < C0 * C1; v += blockDim.x) {
    const int v0 = v / C1, v1 = v - v0 * C1, I = c0 + v0, J = c1 + v1;
    sm.sc[v] = I >= 0 && I < L.Wxc && J >= 0 && J < L.Wyc
                   ? xc[(int64_t)I * L.Wyc + J]
                   : T(0);
  }
  const DeviceIn<T, K, C, D> src =
      device_in<T, K, C, D>(L, bx, x_in, (const T*)nullptr, b);
  CellRegs<T, NOFF, CI, CJ> R;
  tile_load<T, K, NOFF, WARPS, CI, CJ, false>(L, sm, bx, src, false, false,
                                              R);

  // x += sum_q P_q[i, j] x_c[i / k + dx_q, j / k + dy_q] on the owned box
  // cells in the grid, each summing its terms in offset order
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int64_t plane = (int64_t)L.Wx * L.Wy;
  // owned cell (a, c) is grid cell g0 + WARPS a Wy + 32 c; bit a CJ + c of
  // `in`: it lies in the box and the grid
  static_assert(CI * CJ <= 32, "a bit an owned cell");
  const int64_t g0 = (int64_t)(bx.ox + w) * L.Wy + (bx.oy + lane);
  unsigned in = 0;
  int wc[CI][CJ];
  T acc[CI][CJ];
#pragma unroll
  for (int a = 0; a < CI; ++a) {
#pragma unroll
    for (int c = 0; c < CJ; ++c) {
      const int e0 = w + WARPS * a, e1 = lane + 32 * c;
      const int i = bx.ox + e0, j = bx.oy + e1;
      const bool cell = e0 < bx.E0 && e1 < E1 && inside(i, j, L.Wx, L.Wy);
      in |= cell ? 1u << (a * CJ + c) : 0u;
      wc[a][c] = cell ? (i / K - c0) * C1 + (j / K - c1) : 0;
      acc[a][c] = T(0);
    }
  }
  for (int q0 = 0; q0 < so.n; q0 += kPBatch) {
    T pv[kPBatch][CI][CJ];
#pragma unroll
    for (int u = 0; u < kPBatch; ++u) {
      const int64_t gq = (q0 + u < so.n ? q0 + u : q0) * plane;
#pragma unroll
      for (int a = 0; a < CI; ++a) {
#pragma unroll
        for (int c = 0; c < CJ; ++c) {
          const bool cell = in >> (a * CJ + c) & 1u;
          pv[u][a][c] = coef_ldg<T>(
              Pp, gq + (cell ? g0 + (int64_t)(WARPS * a) * L.Wy + 32 * c : 0));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kPBatch; ++u) {
      if (q0 + u >= so.n) break;
      const int dq = so.dx[q0 + u] * C1 + so.dy[q0 + u];
#pragma unroll
      for (int a = 0; a < CI; ++a) {
#pragma unroll
        for (int c = 0; c < CJ; ++c) {
          if (in >> (a * CJ + c) & 1u) {
            acc[a][c] += pv[u][a][c] * sm.sc[wc[a][c] + dq];
          }
        }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < CI; ++a) {
#pragma unroll
    for (int c = 0; c < CJ; ++c) {
      if (in >> (a * CJ + c) & 1u) {
        const int e = (w + WARPS * a) * E1 + (lane + 32 * c);
        sm.xs[e] = sm.xs[e] + acc[a][c];
      }
    }
  }
  __syncthreads();

  int sx[NOFF];
#pragma unroll
  for (int q = 0; q < NOFF; ++q) sx[q] = L.st.dx[q] * E1 + L.st.dy[q];
  tile_steps<T, NOFF, WARPS, CI, CJ>(L, sm, bx, R, sx);
  tile_store<T, WARPS, CI, CJ>(L, sm, bx, x_out);
}

// tiles of a level's grid: (rows of tiles, tiles a row)
__host__ __device__ inline int tiles_of(int W, int t) {
  return (W + t - 1) / t;
}

}  // namespace amg
