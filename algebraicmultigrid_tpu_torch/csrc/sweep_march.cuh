// The march: one multicolor GS/SOR smoother application on a lattice level
// as one launch in which each block marches along axis 0 over a column of
// the grid: K7 on a 3-D LatND level (sweep3d.cu, axis 0 the TPU kernel's
// slab axis) and K5 on a Lat2D level (gs_sweep.cu).  A Wx x Wy Lat2D level
// is the grid (Wx, 1, Wy): its offsets (0, dx, dy) become (dx, 0, dy), its
// color periods (1, a, b) become (a, 1, b), the planes, x, b and dinv are
// read in place, and a column is a 1 x E2 strip of rows with no axis-1
// halo, so the march walks the level's rows.
//
// The smoother runs the color steps c = steps[0], steps[1], ... in order;
// step s updates every cell of color steps[s]:
//
//   x <- x + omega * dinv * (b - sum_k A[k] * x[. + d_k])
//
// with x read as 0 outside the grid.  No two coupled cells share a color,
// so a step is race-free in place.
//
// Design.  A block owns a column: a tile on axes 1 and 2 plus a halo of
// H_a = n_steps * reach_a cells on those axes (the box E1 x E2), and a
// segment [a, b) of axis 0 plus H_0 = n_steps * reach_0 planes at each end
// (the planes L = a - H_0 ... U - 1 = b + H_0 - 1).  The block walks them
// in batches of P planes (a compile-time constant of the instance: K7's
// kMarchBatch = 4, K5's by stencil in gs_sweep.cu).  When the batch ending at plane M
// has landed in a ring of x planes in shared memory (loaded by cp.async
// kMarchDepth batches ahead), step s runs on the P planes ending at
// M - (s+1)*reach_0 over the box eroded by (s+1)*reach on axes 1 and 2,
// steps in order with a barrier between them, and the P planes ending at
// M - n_steps*reach_0 are final: the block stores its tile of those in
// [a, b).  Each x cell is read from device memory once a column (the box's
// halo and the segment's end planes again by the neighbouring columns), and
// every step reads x from shared memory.  The coefficient planes, b and
// dinv are read in place, each cell's once a step that updates it.
//
// What lost (kernel_variants.py sweeps and sweeps march2d, PERF.md): b
// and dinv, or also the coefficient planes, staged in rings beside x's
// (their rings cut the box and the batch; on K5's strips too, by 16-byte
// cp.async); one cell a thread, or four; loads two batches ahead; a step's
// coefficients in registers a step ahead; K7 in batches of 1 or 2 planes.
// The variants edit this file's source.
//
// Why it is exact (the wavefront form of sweep_tile.cuh's halo argument).
// Call plane p "at state s" once steps 0..s have run on it.  Step s runs on
// plane p in the time whose batch ends at M, with M - (s+1)*r0 - P < p <=
// M - (s+1)*r0, and reads the planes p - r0 ... p + r0.  Step s-1 ran on
// plane p + r0 in the same time (p + r0 lies in its window, M - s*r0 - P <
// p + r0 <= M - s*r0), earlier in it, or in an earlier time, so each
// neighbour is at state s-1 or later; and step s' > s reaches plane p + r0
// only in a later time or later in this one, so no neighbour has gone past
// state s.  The P planes of one step's window change only cells of that
// step's color, which no cell of that color reads.  A neighbour at state s
// rather than s-1 differs only in cells of color steps[s], which are never
// coupled to a cell of that color: the values step s reads are those of the
// step-by-step sweep.  On axes 1 and 2 and at the segment's ends the halo
// erodes as in the tile kernel: initially every loaded cell is exact; step
// s updates only cells (s+1)*reach from the loaded faces (planes [L +
// (s+1)*r0, U - (s+1)*r0)), whose neighbours were exact after step s-1, so
// after the last step the tile of planes [a, b) is exact.  Cells outside
// the grid hold 0 and are never updated.
//
// Thread map.  A thread owns kMarchUnit = 2 axis-2 neighbours, which for
// the 2-color 7-point table hold one cell of each color, so every lane of
// a step has a cell to update (one cell a thread idles half the lanes).
//
// Its byte bound: the n_off planes, b, dinv and x read once and x written
// once (11 words a cell for a 7-point level); the column's halo and the
// segments' end planes add their share of x's reads.
//
// The planes are of type C: T itself, or __nv_bfloat16 under float vectors
// (K7's bf16 entry, the reference's AMG_COEF_DTYPE=bfloat16 on a 3-D
// level), each coefficient converted to T where it is loaded (stencil.cuh
// coef_ldg), so the ring, dinv, b and the arithmetic stay in T and a
// 7-point cell reads 7 * 2 + 4 * 4 bytes in place of 11 * 4.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "stencil.cuh"

namespace amg {

// the offsets a march takes at most: its wide instance (NOFF = -1, K5 on
// the structured Ruge-Stueben hierarchy's coarse Lat2D levels, whose
// Galerkin stencils reach 37 and 45 offsets); the generic one (NOFF = 0)
// takes kMaxOff
constexpr int kMarchMaxOff = 64;

struct MarchParams {
  int dims[3];      // grid extents, axis 2 contiguous
  int ext[2];       // the y-z box: tile + 2 * halo on axes 1 and 2
  int halo[3];      // n_steps * reach per axis
  int reach[3];     // max |offset| per axis
  int per[3];       // color periods
  int n_off;
  int n_steps;
  int seg;          // planes a segment owns (the last may own fewer)
  int ring;         // x's ring depth in planes
  int pad;          // x's rows past the grid, copied to x_out by block 0
  int d0[kMarchMaxOff];     // offset k's axis-0 component
  int shift[kMarchMaxOff];  // offset k's axes-1/2 part as a flat shift in a box plane
  int tab[kMaxColorCells];
  int steps[kMaxSteps];
};

// the planes a time step loads, steps and stores (K7's; K5's by stencil)
constexpr int kMarchBatch = 4;
// the batches loaded ahead of the one the steps wait for
constexpr int kMarchDepth = 1;
// the axis-2 neighbours a thread updates in a step
constexpr int kMarchUnit = 2;
// a thread's cells of the box to load and store: at most kMarchCells (the
// launch keeps the box within kMarchCells * blockDim.x cells)
constexpr int kMarchCells = 3;

// x's ring: with the batch ending at plane M, the planes M - (n_steps+1)*r0
// - P + 1 ... M + kMarchDepth*P that time M reads or has in flight, and
// P - r0 more (at least 0) so that the next time's loads do not reach the
// planes this time stores
__host__ __device__ inline int march_ring(int n_steps, int r0, int P) {
  return (n_steps + 1) * r0 + P + kMarchDepth * P + (P > r0 ? P - r0 : 0);
}

// shared memory of a march block: x's ring over the y-z box
__host__ __device__ inline size_t march_smem_bytes(int E1, int E2, int ring, int itemsize) {
  return (size_t)ring * E1 * E2 * itemsize;
}

// one element from device to shared memory, zero where !valid
template <typename T>
__device__ __forceinline__ void march_cp_async(T* dst, const T* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
               "l"(src), "n"((int)sizeof(T)), "r"(valid ? (int)sizeof(T) : 0));
}

__device__ __forceinline__ void march_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most kMarchDepth of this thread's groups are in flight
__device__ __forceinline__ void march_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kMarchDepth) : "memory");
}

// NOFF: the offsets' count as a compile-time constant (5 and 9, the 2-D
// 5- and 9-point stencils, and 7, the 3-D 7-point one: the offsets' ring
// pointers in registers), or 0 for any count up to kMaxOff, -1 for any up
// to kMarchMaxOff.  MAXT: the block's threads
// at most, as each entry compiles the kernel: 1024 for K7's y-z boxes, 512
// for K5's strips, which leaves a thread 128 registers rather than 64 (the
// 9-point instance takes 80).  P: the planes a time step loads, steps and
// stores.  C: the planes' type (default T).
template <typename T, int NOFF, int MAXT, int P, typename C = T>
__global__ void __launch_bounds__(MAXT)
    march_sweep_kernel(T* __restrict__ x_out, const T* __restrict__ x_in,
                       const T* __restrict__ b, const C* __restrict__ A,
                       const T* __restrict__ dinv, const MarchParams p,
                       const T omega) {
  extern __shared__ __align__(16) unsigned char march_smem[];
  constexpr int KOFF = NOFF > 0 ? NOFF : (NOFF == 0 ? kMaxOff : kMarchMaxOff);
  const int n_off = NOFF > 0 ? NOFF : p.n_off;
  const int E1 = p.ext[0], E2 = p.ext[1], E = E1 * E2;
  const int RX = p.ring;
  T* xr = reinterpret_cast<T*>(march_smem);  // [RX][E]
  const int n0 = p.dims[0], n1 = p.dims[1], n2 = p.dims[2];
  const int r0 = p.reach[0], r1 = p.reach[1], r2 = p.reach[2];
  const int H1 = p.halo[1], H2 = p.halo[2];
  const int o1 = (int)blockIdx.y * (E1 - 2 * H1) - H1;
  const int o2 = (int)blockIdx.x * (E2 - 2 * H2) - H2;
  const int a = (int)blockIdx.z * p.seg;
  const int bend = min(a + p.seg, n0);
  const int L = a - p.halo[0], U = bend + p.halo[0];
  const int64_t plane = (int64_t)n0 * n1 * n2;
  const int64_t pstride = (int64_t)n1 * n2;
  const int tid = threadIdx.x, nth = blockDim.x;

  // x's padding rows past the grid pass through unchanged
  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0) {
    for (int i = tid; i < p.pad; i += nth) x_out[plane + i] = x_in[plane + i];
  }

  // this thread's load/store cells (e = tid + j * nth): their offset in a
  // grid plane (-1 outside the grid) and whether they are the tile's
  int le[kMarchCells];
  int64_t lg[kMarchCells];
  bool ltile[kMarchCells];
#pragma unroll
  for (int j = 0; j < kMarchCells; ++j) {
    const int e = tid + j * nth;
    le[j] = e < E ? e : -1;
    const int e1 = e / E2, e2 = e - e1 * E2;
    const int g1 = o1 + e1, g2 = o2 + e2;
    const bool in = e < E && g1 >= 0 && g1 < n1 && g2 >= 0 && g2 < n2;
    lg[j] = in ? (int64_t)g1 * n2 + g2 : -1;
    ltile[j] = in && e1 >= H1 && e1 < E1 - H1 && e2 >= H2 && e2 < E2 - H2;
  }
  // this thread's step cells: kMarchUnit axis-2 neighbours of one row
  const int per_row = (E2 + kMarchUnit - 1) / kMarchUnit;
  const bool has_unit = tid < E1 * per_row;
  const int ue1 = tid / per_row;
  const int ue2 = kMarchUnit * (tid - ue1 * per_row);
  const int ug1 = o1 + ue1;
  bool uin[kMarchUnit];
  int ucol[kMarchUnit];
  int64_t ug[kMarchUnit];
#pragma unroll
  for (int v = 0; v < kMarchUnit; ++v) {
    const int g2 = o2 + ue2 + v;
    uin[v] = has_unit && ue2 + v < E2 && ug1 >= 0 && ug1 < n1 && g2 >= 0 && g2 < n2;
    ucol[v] = uin[v] ? (ug1 % p.per[1]) * p.per[2] + g2 % p.per[2] : 0;
    ug[v] = (int64_t)ug1 * n2 + g2;
  }
  int d0[KOFF], shift[KOFF];
#pragma unroll
  for (int k = 0; k < KOFF; ++k) {
    d0[k] = k < n_off ? p.d0[k] : 0;
    shift[k] = k < n_off ? p.shift[k] : 0;
  }

  // plane m's x over the box into its ring slot, 0 outside the grid
  auto load = [&](int m) {
    const bool in0 = m >= 0 && m < n0;
    T* xs = xr + ((m - L) % RX) * E;
    const int64_t gm = (int64_t)m * pstride;
#pragma unroll
    for (int j = 0; j < kMarchCells; ++j) {
      if (le[j] < 0) continue;
      const bool in = in0 && lg[j] >= 0;
      march_cp_async(xs + le[j], x_in + (in ? gm + lg[j] : 0), in);
    }
  };

  // time t (its batch the planes m0 = L + t*P ... M = m0 + P - 1) loads
  // the batch kMarchDepth ahead as one group (empty past U), so batch t's
  // group is always kMarchDepth groups behind the newest
  auto load_batch = [&](int m0) {
#pragma unroll
    for (int j = 0; j < P; ++j) {
      if (m0 + j < U) load(m0 + j);
    }
  };
#pragma unroll
  for (int t = 0; t < kMarchDepth; ++t) {
    load_batch(L + t * P);
    march_commit();
  }
  const int percells = p.per[1] * p.per[2];
  const int S = p.n_steps;
  for (int m0 = L; m0 < U; m0 += P) {
    const int M = m0 + P - 1;
    load_batch(m0 + kMarchDepth * P);
    march_commit();
    march_wait();
    __syncthreads();

    for (int s = 0; s < S; ++s) {
      const int l1 = (s + 1) * r1, l2 = (s + 1) * r2;
      const int c = p.steps[s];
      const bool row_in = ue1 >= l1 && ue1 < E1 - l1;
      // step s's window: the P planes a reach behind step s-1's
#pragma unroll
      for (int pl = M - (s + 1) * r0 - P + 1; pl <= M - (s + 1) * r0; ++pl) {
        if (!row_in || pl < L + (s + 1) * r0 || pl >= U - (s + 1) * r0 || pl < 0 || pl >= n0) continue;
        const int sx = (pl - L) % RX;
        // the offsets' x planes in the ring (|d0| <= r0 < RX), as offsets
        int xk[KOFF];
#pragma unroll
        for (int k = 0; k < KOFF; ++k) {
          int slot = sx + d0[k];
          slot += slot < 0 ? RX : 0;
          slot -= slot >= RX ? RX : 0;
          xk[k] = slot * E + shift[k];
        }
        T* xs = xr + sx * E;
        const int ptab = (pl % p.per[0]) * percells;
        const int64_t gpl = (int64_t)pl * pstride;
#pragma unroll
        for (int v = 0; v < kMarchUnit; ++v) {
          const int e2 = ue2 + v;
          if (!uin[v] || e2 < l2 || e2 >= E2 - l2 || p.tab[ptab + ucol[v]] != c) continue;
          const int e = ue1 * E2 + e2;
          T acc = T(0);
#pragma unroll
          for (int k = 0; k < KOFF; ++k) {
            if (k < n_off) acc += coef_ldg<T>(A, k * plane + gpl + ug[v]) * xr[xk[k] + e];
          }
          xs[e] = xs[e] + omega * __ldg(dinv + gpl + ug[v]) * (__ldg(b + gpl + ug[v]) - acc);
        }
      }
      __syncthreads();
    }

    // the planes M - S*r0 - P + 1 ... M - S*r0 are final: store the
    // segment's own
    for (int q = max(M - S * r0 - P + 1, a); q <= M - S * r0 && q < bend; ++q) {
      const T* xs = xr + ((q - L) % RX) * E;
      const int64_t gq = (int64_t)q * pstride;
#pragma unroll
      for (int j = 0; j < kMarchCells; ++j) {
        if (ltile[j]) x_out[gq + lg[j]] = xs[le[j]];
      }
    }
  }
}

// a march kernel's pointer type: every instance's signature, declared once
// more (never defined) so that naming the type instantiates no kernel
template <typename T, typename C>
void march_kernel_signature(T* __restrict__, const T* __restrict__, const T* __restrict__,
                            const C* __restrict__, const T* __restrict__, const MarchParams, const T);
template <typename T, typename C = T>
using MarchKernel = decltype(&march_kernel_signature<T, C>);

// an instance of the march as an entry launches it: the kernel, its batch
// P, its thread bound and the offsets it takes at most
template <typename T, typename C = T>
struct MarchInstance {
  MarchKernel<T, C> kernel;
  int batch;
  int max_threads;
  int max_off;
};

// the threads of a block over an E1 x E2 box: one step unit a thread,
// whole warps
inline int march_threads(int E1, int E2) {
  return ((E1 * ((E2 + kMarchUnit - 1) / kMarchUnit) + 31) / 32) * 32;
}

// the blocks of `inst` an SM holds with `smem` bytes a block (registers,
// shared memory and threads), for the planner's waves; -1 on an error
template <typename T, typename C>
int march_blocks_per_sm(const MarchInstance<T, C>& inst, int threads, size_t smem) {
  if (ensure_dynamic_smem(reinterpret_cast<const void*>(inst.kernel), smem)) return -1;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, inst.kernel, threads, smem) != cudaSuccess) return -1;
  return n;
}

// Fill the parameters and launch; returns a CUDA error code
// (cudaErrorInvalidValue for parameters the kernel does not take).  offs
// holds n_off triples (d0, d1, d2), tab per0*per1*per2 colors; plan =
// (E1, E2, seg): the y-z box and the planes a segment owns; pad counts x's
// rows past the grid, which x_out takes unchanged; inst the entry's
// instance for n_off, its planes A of type C.
template <typename T, typename C>
int launch_march_sweep(const MarchInstance<T, C>& inst, void* x_out, const void* x_in, const void* b,
                       const void* A, const void* dinv, const int* dims,
                       const int* offs, int n_off, const int* per,
                       const int* tab, const int* steps, int n_steps,
                       const int* plan, int pad, double omega, void* stream) {
  const int bad = (int)cudaErrorInvalidValue;
  MarchParams p;
  if (n_off < 1 || n_off > inst.max_off || n_steps < 1 || n_steps > kMaxSteps || pad < 0) return bad;
  for (int a = 0; a < 3; ++a) {
    p.dims[a] = dims[a];
    p.per[a] = per[a];
    p.reach[a] = 0;
    if (dims[a] < 1 || per[a] < 1) return bad;
  }
  if (p.per[0] * p.per[1] * p.per[2] > kMaxColorCells) return bad;
  for (int k = 0; k < n_off; ++k) {
    for (int a = 0; a < 3; ++a) {
      const int d = offs[3 * k + a] < 0 ? -offs[3 * k + a] : offs[3 * k + a];
      if (d > p.reach[a]) p.reach[a] = d;
    }
  }
  p.ext[0] = plan[0];
  p.ext[1] = plan[1];
  p.seg = plan[2];
  if (p.seg < 1) return bad;
  unsigned tiles[2];
  for (int a = 0; a < 3; ++a) p.halo[a] = n_steps * p.reach[a];
  for (int a = 0; a < 2; ++a) {
    const int tile = p.ext[a] - 2 * p.halo[a + 1];
    if (tile < 1) return bad;
    tiles[a] = (unsigned)((dims[a + 1] + tile - 1) / tile);
  }
  const unsigned segs = (unsigned)((dims[0] + p.seg - 1) / p.seg);
  if (tiles[0] > 65535u || segs > 65535u) return bad;
  p.ring = march_ring(n_steps, p.reach[0], inst.batch);
  p.n_off = n_off;
  p.n_steps = n_steps;
  p.pad = pad;
  for (int k = 0; k < n_off; ++k) {
    p.d0[k] = offs[3 * k];
    p.shift[k] = offs[3 * k + 1] * p.ext[1] + offs[3 * k + 2];
  }
  for (int t = 0; t < p.per[0] * p.per[1] * p.per[2]; ++t) p.tab[t] = tab[t];
  for (int s = 0; s < n_steps; ++s) p.steps[s] = steps[s];

  const size_t smem = march_smem_bytes(p.ext[0], p.ext[1], p.ring, (int)sizeof(T));
  // one step unit a thread, and at most kMarchCells box cells a thread to
  // load and store
  const int threads = march_threads(p.ext[0], p.ext[1]);
  if (threads > inst.max_threads || p.ext[0] * p.ext[1] > kMarchCells * threads) return bad;
  const int err = ensure_dynamic_smem(reinterpret_cast<const void*>(inst.kernel), smem);
  if (err) return err;
  inst.kernel<<<dim3(tiles[1], tiles[0], segs), threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(x_out), static_cast<const T*>(x_in), static_cast<const T*>(b),
      static_cast<const C*>(A), static_cast<const T*>(dinv), p, static_cast<T>(omega));
  return (int)cudaGetLastError();
}

}  // namespace amg
