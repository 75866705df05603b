// One whole multicolor GS/SOR smoother application on a lattice level, as
// ONE launch: the first design of K5 (gs_sweep.cu, Lat2D levels) and of K7
// (sweep3d.cu, 3-D LatND levels), which their march (sweep_march.cuh)
// replaced and which stays as the march's comparison.
//
// The smoother runs the color steps c = steps[0], steps[1], ... in order;
// step c updates every grid cell of color c:
//
//   x <- x + omega * dinv * (b - sum_k A[k] * x[. + d_k])
//
// with x read as 0 outside the grid.  The color of a cell comes from its
// coordinates and the periodic table of the lattice coloring, so no two
// coupled cells share a color and a step is race-free in place.
//
// Design (halo over-compute).  The grid is cut into tiles; a block loads
// its tile plus a halo of H_a = n_steps * reach_a cells per axis of x into
// shared memory and runs every step there, with __syncthreads() between
// steps.  Step s updates only the cells at least (s+1)*reach_a from the
// loaded box's faces, whose neighbours were right after step s-1, so after
// the last step the tile itself is exact, and tiles never wait for each
// other: one launch, no grid barrier.  The coefficient planes, b and dinv
// are read in place (unpadded, row-major [n0, n1, n2]) through the
// read-only path, each by the steps that need it; only x lives in shared
// memory.  Cells outside the grid hold 0 and are never updated, which
// gives the zero-outside-the-grid reads of the plain version; the last
// partial tile is masked the same way.
//
// The kernel is written for three axes (axis 2 contiguous); a 2-D level is
// the grid (1, Wx, Wy) with ND = 2, which drops the axis-0 loops.
//
// Its byte bound: one application moves the n_off planes, b, dinv and x
// once and x out once (about 11 words a cell for a 7-point 3-D level),
// against ~2 flops a byte; the halo over-compute adds the halo's share of
// those reads.  On an H100 it runs at ~7x that bound and latency-bound:
// smaller boxes (more blocks an SM) beat the smaller halo share of large
// ones (kernel_variants.py sweeps), and a step idles the lanes whose cell
// has another color.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "stencil.cuh"

namespace amg {

struct SweepParams {
  int dims[3];    // grid extents, axis 2 contiguous
  int ext[3];     // loaded box: tile + 2 * halo per axis
  int halo[3];    // n_steps * reach per axis
  int reach[3];   // max |offset| per axis
  int per[3];     // color periods
  int n_off;
  int n_steps;
  int pad;        // x's rows past the grid, copied to x_out by block 0
  int shift[kMaxOff];        // offset k as a flat index shift in the box
  int tab[kMaxColorCells];   // color of (i0 % per0, i1 % per1, i2 % per2)
  int steps[kMaxSteps];
};

constexpr int kSweepThreads = 256;

// thread block shape: axis 2 across a warp, the rest over axes 1 and 0
template <int ND>
struct SweepBlock {
  static constexpr int x = 32;
  static constexpr int y = ND == 3 ? 4 : 8;
  static constexpr int z = ND == 3 ? 2 : 1;
};

template <typename T, int ND>
__global__ void __launch_bounds__(kSweepThreads)
    tiled_sweep_kernel(T* __restrict__ x_out, const T* __restrict__ x_in,
                       const T* __restrict__ b, const T* __restrict__ A,
                       const T* __restrict__ dinv, const SweepParams p,
                       const T omega) {
  extern __shared__ __align__(16) unsigned char sweep_smem[];
  T* xs = reinterpret_cast<T*>(sweep_smem);
  using Blk = SweepBlock<ND>;

  const int E0 = p.ext[0], E1 = p.ext[1], E2 = p.ext[2];
  const int n0 = p.dims[0], n1 = p.dims[1], n2 = p.dims[2];
  const int o0 = ND == 3 ? (int)blockIdx.z * (E0 - 2 * p.halo[0]) - p.halo[0] : 0;
  const int o1 = (int)blockIdx.y * (E1 - 2 * p.halo[1]) - p.halo[1];
  const int o2 = (int)blockIdx.x * (E2 - 2 * p.halo[2]) - p.halo[2];
  const int64_t plane = (int64_t)n0 * n1 * n2;
  const int tx = threadIdx.x, ty = threadIdx.y, tz = threadIdx.z;

  // x's padding rows past the grid pass through unchanged
  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0) {
    const int nth = Blk::x * Blk::y * Blk::z;
    for (int i = (tz * Blk::y + ty) * Blk::x + tx; i < p.pad; i += nth) x_out[plane + i] = x_in[plane + i];
  }

  // x over the loaded box, 0 outside the grid
  for (int e0 = tz; e0 < E0; e0 += Blk::z) {
    const int g0 = o0 + e0;
    const bool in0 = g0 >= 0 && g0 < n0;
    for (int e1 = ty; e1 < E1; e1 += Blk::y) {
      const int g1 = o1 + e1;
      const bool in01 = in0 && g1 >= 0 && g1 < n1;
      const int64_t row = ((int64_t)g0 * n1 + g1) * n2;
      T* xrow = xs + (e0 * E1 + e1) * E2;
      for (int e2 = tx; e2 < E2; e2 += Blk::x) {
        const int g2 = o2 + e2;
        xrow[e2] = (in01 && g2 >= 0 && g2 < n2) ? x_in[row + g2] : T(0);
      }
    }
  }
  __syncthreads();

  for (int s = 0; s < p.n_steps; ++s) {
    const int c = p.steps[s];
    const int l0 = (s + 1) * p.reach[0];
    const int l1 = (s + 1) * p.reach[1];
    const int l2 = (s + 1) * p.reach[2];
    for (int e0 = l0 + tz; e0 < E0 - l0; e0 += Blk::z) {
      const int g0 = o0 + e0;
      if (g0 < 0 || g0 >= n0) continue;
      for (int e1 = l1 + ty; e1 < E1 - l1; e1 += Blk::y) {
        const int g1 = o1 + e1;
        if (g1 < 0 || g1 >= n1) continue;
        const int crow = ((g0 % p.per[0]) * p.per[1] + g1 % p.per[1]) * p.per[2];
        const int64_t row = ((int64_t)g0 * n1 + g1) * n2;
        const int erow = (e0 * E1 + e1) * E2;
        for (int e2 = l2 + tx; e2 < E2 - l2; e2 += Blk::x) {
          const int g2 = o2 + e2;
          if (g2 < 0 || g2 >= n2 || p.tab[crow + g2 % p.per[2]] != c) continue;
          const int64_t gi = row + g2;
          const int ei = erow + e2;
          T acc = T(0);
          for (int k = 0; k < p.n_off; ++k) {
            acc += A[k * plane + gi] * xs[ei + p.shift[k]];
          }
          xs[ei] = xs[ei] + omega * dinv[gi] * (b[gi] - acc);
        }
      }
    }
    __syncthreads();
  }

  // the tile: the box less its halo
  const int H0 = p.halo[0], H1 = p.halo[1], H2 = p.halo[2];
  for (int e0 = H0 + tz; e0 < E0 - H0; e0 += Blk::z) {
    const int g0 = o0 + e0;
    if (g0 < 0 || g0 >= n0) continue;
    for (int e1 = H1 + ty; e1 < E1 - H1; e1 += Blk::y) {
      const int g1 = o1 + e1;
      if (g1 < 0 || g1 >= n1) continue;
      const int64_t row = ((int64_t)g0 * n1 + g1) * n2;
      const T* xrow = xs + (e0 * E1 + e1) * E2;
      for (int e2 = H2 + tx; e2 < E2 - H2; e2 += Blk::x) {
        const int g2 = o2 + e2;
        if (g2 >= 0 && g2 < n2) x_out[row + g2] = xrow[e2];
      }
    }
  }
}

// Fill the parameters from the host's arrays and launch; returns a CUDA
// error code (cudaErrorInvalidValue for parameters the kernel does not
// take).  offs holds n_off triples (d0, d1, d2), tab per0*per1*per2 colors;
// pad counts x's rows past the grid, which x_out takes unchanged.
template <typename T, int ND>
int launch_tiled_sweep(void* x_out, const void* x_in, const void* b,
                       const void* A, const void* dinv, const int* dims,
                       const int* offs, int n_off, const int* per,
                       const int* tab, const int* steps, int n_steps,
                       const int* ext, int pad, double omega, void* stream) {
  const int bad = (int)cudaErrorInvalidValue;
  SweepParams p;
  if (n_off < 1 || n_off > kMaxOff || n_steps < 1 || n_steps > kMaxSteps || pad < 0) {
    return bad;
  }
  for (int a = 0; a < 3; ++a) {
    p.dims[a] = dims[a];
    p.ext[a] = ext[a];
    p.per[a] = per[a];
    p.reach[a] = 0;
    if (dims[a] < 1 || per[a] < 1) return bad;
  }
  if (ND == 2 && (dims[0] != 1 || ext[0] != 1)) return bad;
  if (p.per[0] * p.per[1] * p.per[2] > kMaxColorCells) return bad;
  for (int k = 0; k < n_off; ++k) {
    for (int a = 0; a < 3; ++a) {
      const int d = offs[3 * k + a];
      p.reach[a] = d < 0 ? (-d > p.reach[a] ? -d : p.reach[a])
                         : (d > p.reach[a] ? d : p.reach[a]);
    }
  }
  size_t cells = 1;
  unsigned tiles[3];
  for (int a = 0; a < 3; ++a) {
    p.halo[a] = n_steps * p.reach[a];
    const int tile = ext[a] - 2 * p.halo[a];
    if (tile < 1) return bad;
    tiles[a] = (unsigned)((dims[a] + tile - 1) / tile);
    cells *= (size_t)ext[a];
  }
  if (tiles[0] > 65535u || tiles[1] > 65535u) return bad;
  p.n_off = n_off;
  p.n_steps = n_steps;
  p.pad = pad;
  for (int k = 0; k < n_off; ++k) {
    p.shift[k] = (offs[3 * k] * ext[1] + offs[3 * k + 1]) * ext[2] + offs[3 * k + 2];
  }
  for (int t = 0; t < p.per[0] * p.per[1] * p.per[2]; ++t) p.tab[t] = tab[t];
  for (int s = 0; s < n_steps; ++s) p.steps[s] = steps[s];

  const size_t smem = cells * sizeof(T);
  const int err = ensure_dynamic_smem(reinterpret_cast<const void*>(tiled_sweep_kernel<T, ND>), smem);
  if (err) return err;
  using Blk = SweepBlock<ND>;
  tiled_sweep_kernel<T, ND>
      <<<dim3(tiles[2], tiles[1], tiles[0]), dim3(Blk::x, Blk::y, Blk::z), smem,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<T*>(x_out), static_cast<const T*>(x_in),
          static_cast<const T*>(b), static_cast<const T*>(A),
          static_cast<const T*>(dinv), p, static_cast<T>(omega));
  return (int)cudaGetLastError();
}

}  // namespace amg
