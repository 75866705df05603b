// Phased whole-subcycle V-cycle (K9) on Lat2D levels (Hopper, sm_90a), as
// ONE cooperative launch.
//
// Replaces the Pallas TPU kernel _subcycle_kernel of the JAX package's
// ops/pallas/subcycle_kernel.py (via fused_subcycle): one V-cycle from the
// zero guess over levels [t, end] -- the presmooth, residual and factored
// restriction of level t, the whole-tail recursion of every deeper level
// plus the dense coarse solve, then the factored prolong-correct and the
// postsmooth of level t -- in three phases separated by grid.sync():
//
//   A  level t in 2-D tiles: each block loads no x (the zero start), runs
//      every presmooth color step on its tile plus a halo in shared memory,
//      forms r = b - A x and g = S r over the tile plus one reach, then
//      T (r - A g) over the tile and the box-k sums of the coarse cells the
//      tile owns; it writes its tile of x to x_mid and those cells to b_c;
//   B  the tail recursion of tail_levels.cuh (K4's code) from the zero
//      guess on b_c, writing x_c;
//   C  level t in the same tiles: each block loads exact x_mid over its
//      tile plus a halo, adds Tup - S (A Tup) with Tup = T upsample_k(x_c)
//      formed on the fly, runs the postsmooth steps in shared memory and
//      writes its tile of x.
//
// What bounds it on the card: at 4096^2 level t is L1 (1366^2, 9 planes,
// ~0.1 GB in f32, a ~0.035 ms byte bound with the tail's planes) and the
// tail is K4's; neither bound is near.  On an H100 (profile_torch.py,
// kernel_variants.py) K9 takes ~1.03 ms with 72-cell tiles: phase B is
// K4's ~0.43 ms of grid barriers, and phases A and C, latency-bound, take
// about what the per-pass L1 legs take (~0.6 ms): a color step leaves
// three lanes in four idle on a 4-color level and reads the planes at
// stride 2, and each step's __syncthreads stalls the SM's one block.
//
// Design.  The TPU kernel walks full-width slabs of level t in order on one
// core and keeps x_mid and the coarse vectors in VMEM.  Here the blocks take
// 2-D tiles in a grid-stride loop, in no order.  A tile's interior is a
// multiple of k on both axes and starts at a multiple of k, so every coarse
// cell's (clipped) k x k box lies in exactly one tile and each coarse cell
// has one owner, which sums it in the order of stencil.cuh::restrict_cell.
// Phase A's halo is n_steps*reach + 2*reach: step s updates only the cells
// at least (s+1)*reach from the box's faces (the erosion of K5/K7,
// sweep_tile.cuh), so x is exact n_steps*reach inside the box, r and g one
// reach further in and T (r - A g) on the tile.  Phase C's halo is
// n_steps*reach: the correction reads x_mid only at its own cell and T and
// x_c through stencil_tup_at from device memory, so it is exact on the
// whole box.  Level t is read in place (unpadded planes, b and D^-1) and
// never re-read once per color step as the per-pass legs K1/K2 re-read it;
// reads outside the grid are zero, and cells outside the grid hold 0 and
// are never updated.  The tail levels keep K4's whole-plane passes.  The
// wrapper passes x_mid, b_c, x_c and the tail's work buffer; the kernel
// allocates nothing.  The grid is as many blocks as fit on the card at
// once with the shared memory phase A needs (launch_cooperative).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tail_levels.cuh"

namespace {

using amg::kMaxTailLevels;
using amg::TailLevel;

// one 1024-thread block per SM, as K4: on an H100 (kernel_variants.py
// subcycle, f32, 4096^2) 1.03 ms at its best tile against 1.37 with
// 512-thread blocks two an SM, 1.56 with 256 x 4 and 1.89 with 256 x 2, the
// tail phase's block-0 levels and grid barriers costing most
constexpr int kSubThreads = 1024;
constexpr int kSubMinBlocks = 1;

__device__ __forceinline__ bool in_grid(int i, int j, int Wx, int Wy) {
  return i >= 0 && i < Wx && j >= 0 && j < Wy;
}

// The color steps on a box of E x E cells of x in shared memory whose cell
// (0, 0) is the grid's (ox, oy): step s updates the cells of its color at
// least (s+1)*reach from the box's faces.
template <typename T>
__device__ void box_steps(const TailLevel& L, T* xs, const T* b, int E,
                          int ox, int oy, int reach) {
  const T* __restrict__ A = (const T*)L.A;
  const T* __restrict__ dinv = (const T*)L.dinv;
  const int Wx = L.Wx, Wy = L.Wy;
  const int64_t plane = (int64_t)Wx * Wy;
  const T omega = (T)L.omega;
  for (int s = 0; s < L.n_steps; ++s) {
    const int lo = (s + 1) * reach;
    const int hi = E - lo;
    const int color = L.steps[s];
    for (int e = threadIdx.x; e < E * E; e += blockDim.x) {
      const int e0 = e / E;
      const int e1 = e - e0 * E;
      const int i = ox + e0;
      const int j = oy + e1;
      if (e0 < lo || e0 >= hi || e1 < lo || e1 >= hi || !in_grid(i, j, Wx, Wy) ||
          L.cg.tab[(i % L.cg.a) * L.cg.b + (j % L.cg.b)] != color) {
        continue;
      }
      const int64_t c = (int64_t)i * Wy + j;
      T acc = T(0);
      for (int q = 0; q < L.st.n; ++q) {
        acc += A[q * plane + c] * xs[e + L.st.dx[q] * E + L.st.dy[q]];
      }
      xs[e] = xs[e] + omega * dinv[c] * (b[c] - acc);
    }
    __syncthreads();
  }
}

// Phase A on tile (ti, tj): presmooth from zero, x to x_mid, the owned
// coarse cells of the restriction to bc.  xs holds the box, rs and gs the
// tile plus one reach.
template <typename T>
__device__ void down_tile(const TailLevel& L, const T* b, T* x_mid, T* bc,
                          T* xs, T* rs, T* gs, int ti, int tj, int tile,
                          int halo, int reach) {
  const T* __restrict__ A = (const T*)L.A;
  const T* __restrict__ Tp = (const T*)L.Tp;
  const T* __restrict__ S = (const T*)L.S;
  const int Wx = L.Wx, Wy = L.Wy, k = L.k;
  const int64_t plane = (int64_t)Wx * Wy;
  const int E = tile + 2 * halo;
  const int G = tile + 2 * reach;
  const int ox = ti * tile - halo, oy = tj * tile - halo;
  const int gx = ti * tile - reach, gy = tj * tile - reach;

  for (int e = threadIdx.x; e < E * E; e += blockDim.x) xs[e] = T(0);
  __syncthreads();
  box_steps<T>(L, xs, b, E, ox, oy, reach);

  // r = b - A x and g = S r on the tile plus one reach (0 outside the grid)
  for (int u = threadIdx.x; u < G * G; u += blockDim.x) {
    const int u0 = u / G;
    const int u1 = u - u0 * G;
    const int i = gx + u0, j = gy + u1;
    T r = T(0), g = T(0);
    if (in_grid(i, j, Wx, Wy)) {
      const int64_t c = (int64_t)i * Wy + j;
      const int e = (u0 + halo - reach) * E + (u1 + halo - reach);
      T acc = T(0);
      for (int q = 0; q < L.st.n; ++q) {
        acc += A[q * plane + c] * xs[e + L.st.dx[q] * E + L.st.dy[q]];
      }
      r = b[c] - acc;
      g = S[c] * r;
    }
    rs[u] = r;
    gs[u] = g;
  }
  // the tile of x to x_mid
  for (int e = threadIdx.x; e < tile * tile; e += blockDim.x) {
    const int e0 = e / tile;
    const int e1 = e - e0 * tile;
    const int i = ti * tile + e0, j = tj * tile + e1;
    if (in_grid(i, j, Wx, Wy)) {
      x_mid[(int64_t)i * Wy + j] = xs[(e0 + halo) * E + (e1 + halo)];
    }
  }
  __syncthreads();

  // T (r - A g) on the tile, over r: a cell reads only its own r
  for (int e = threadIdx.x; e < tile * tile; e += blockDim.x) {
    const int e0 = e / tile;
    const int e1 = e - e0 * tile;
    const int i = ti * tile + e0, j = tj * tile + e1;
    if (!in_grid(i, j, Wx, Wy)) continue;
    const int64_t c = (int64_t)i * Wy + j;
    const int u = (e0 + reach) * G + (e1 + reach);
    T acc = T(0);
    for (int q = 0; q < L.st.n; ++q) {
      acc += A[q * plane + c] * gs[u + L.st.dx[q] * G + L.st.dy[q]];
    }
    rs[u] = Tp[c] * (rs[u] - acc);
  }
  __syncthreads();

  // the owned coarse cells: each sums its clipped k x k box
  const int kt = tile / k;
  for (int w = threadIdx.x; w < kt * kt; w += blockDim.x) {
    const int w0 = w / kt;
    const int w1 = w - w0 * kt;
    const int I = ti * kt + w0, J = tj * kt + w1;
    if (I >= L.Wxc || J >= L.Wyc) continue;
    T acc = T(0);
    for (int dj = 0; dj < k && k * J + dj < Wy; ++dj) {
      T col = T(0);
      for (int di = 0; di < k && k * I + di < Wx; ++di) {
        col += rs[(k * w0 + di + reach) * G + (k * w1 + dj + reach)];
      }
      acc += col;
    }
    bc[(int64_t)I * L.Wyc + J] = acc;
  }
  __syncthreads();
}

// Phase C on tile (ti, tj): x_mid plus the correction over the box, the
// postsmooth, the tile to x_out.
template <int K, typename T>
__device__ void up_tile(const TailLevel& L, const T* b, const T* x_mid,
                        const T* xc, T* x_out, T* xs, int ti, int tj,
                        int tile, int halo, int reach) {
  const T* __restrict__ A = (const T*)L.A;
  const T* __restrict__ Tp = (const T*)L.Tp;
  const T* __restrict__ S = (const T*)L.S;
  const int Wx = L.Wx, Wy = L.Wy;
  const int E = tile + 2 * halo;
  const int ox = ti * tile - halo, oy = tj * tile - halo;

  for (int e = threadIdx.x; e < E * E; e += blockDim.x) {
    const int e0 = e / E;
    const int e1 = e - e0 * E;
    const int i = ox + e0, j = oy + e1;
    T v = T(0);
    if (in_grid(i, j, Wx, Wy)) {
      const int64_t c = (int64_t)i * Wy + j;
      const T tup = Tp[c] * xc[amg::coarse_of<K>(i, j, L.Wyc)];
      v = x_mid[c] + (tup - S[c] * amg::stencil_tup_at<K>(A, Tp, xc, L.st, i,
                                                           j, Wx, Wy, L.Wyc));
    }
    xs[e] = v;
  }
  __syncthreads();
  box_steps<T>(L, xs, b, E, ox, oy, reach);

  for (int e = threadIdx.x; e < tile * tile; e += blockDim.x) {
    const int e0 = e / tile;
    const int e1 = e - e0 * tile;
    const int i = ti * tile + e0, j = tj * tile + e1;
    if (in_grid(i, j, Wx, Wy)) {
      x_out[(int64_t)i * Wy + j] = xs[(e0 + halo) * E + (e1 + halo)];
    }
  }
  __syncthreads();
}

// lv[0] is level t, lv[1 .. n_tail] its tail.  Dynamic shared memory holds
// the n_tail + 1 descriptors, then the tile buffers.  Every thread of the
// grid reaches every grid.sync() (no early return).
template <typename T>
__global__ void __launch_bounds__(kSubThreads, kSubMinBlocks)
    subcycle_kernel(const TailLevel* lv, int n_tail, int n_grid, T* work,
                    T* x_out, const T* b, T* x_mid, T* bc, T* xc,
                    const T* __restrict__ Mc, int n7, int64_t b7_off,
                    int64_t x7_off, int tile, int halo_down, int halo_up,
                    int reach) {
  extern __shared__ __align__(16) unsigned char sub_smem[];
  TailLevel* sh = reinterpret_cast<TailLevel*>(sub_smem);
  amg::load_levels(sh, lv, n_tail + 1);
  const TailLevel& L = sh[0];
  const int tiles_y = (L.Wy + tile - 1) / tile;
  const int tiles = ((L.Wx + tile - 1) / tile) * tiles_y;
  const int Ed = tile + 2 * halo_down;
  const int G = tile + 2 * reach;
  T* xs = reinterpret_cast<T*>(sh + n_tail + 1);
  T* rs = xs + Ed * Ed;
  T* gs = rs + G * G;

  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    down_tile<T>(L, b, x_mid, bc, xs, rs, gs, t / tiles_y, t % tiles_y, tile,
                 halo_down, reach);
  }
  cooperative_groups::this_grid().sync();
  amg::tail_cycle<T>(sh + 1, n_tail, n_grid, work, xc, nullptr, bc, Mc, n7,
                     b7_off, x7_off);
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    if (L.k == 2) {
      up_tile<2, T>(L, b, x_mid, xc, x_out, xs, t / tiles_y, t % tiles_y,
                    tile, halo_up, reach);
    } else {
      up_tile<3, T>(L, b, x_mid, xc, x_out, xs, t / tiles_y, t % tiles_y,
                    tile, halo_up, reach);
    }
  }
}

template <typename T>
int fused_subcycle(const void* desc, int n_tail, int n_grid, T* work,
                   T* x_out, const T* b, T* x_mid, T* bc, T* xc, const T* Mc,
                   int n7, int64_t b7_off, int64_t x7_off, int tile, int k,
                   int halo_down, int halo_up, int reach, void* stream_ptr) {
  if (n_tail < 1 || n_tail > kMaxTailLevels || n_grid < 0 ||
      n_grid > n_tail || n7 < 1 || (k != 2 && k != 3) || tile < k ||
      tile % k != 0 || reach < 0 || halo_down < 2 * reach || halo_up < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t ed = (size_t)(tile + 2 * halo_down);
  const size_t eu = (size_t)(tile + 2 * halo_up);
  const size_t g = (size_t)(tile + 2 * reach);
  const size_t down_words = ed * ed + 2 * g * g;
  const size_t smem = sizeof(TailLevel) * (n_tail + 1) +
                      (down_words > eu * eu ? down_words : eu * eu) * sizeof(T);
  const TailLevel* lv = (const TailLevel*)desc;
  void* args[] = {&lv,   &n_tail, &n_grid, &work,   &x_out,  &b,
                  &x_mid, &bc,    &xc,     &Mc,     &n7,     &b7_off,
                  &x7_off, &tile, &halo_down, &halo_up, &reach};
  return amg::launch_cooperative((const void*)subcycle_kernel<T>, kSubThreads,
                                 args, (cudaStream_t)stream_ptr, smem);
}

}  // namespace

// Bytes of shared memory a block may take (the wrapper sizes the tile to
// fit the descriptors and the tile buffers in it).
extern "C" int amg_subcycle_smem_limit() {
  int dev = 0;
  int optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess) {
    return -1;
  }
  return optin;
}

#define AMG_DEFINE_SUBCYCLE(SUFFIX, T)                                       \
  extern "C" int amg_fused_subcycle_##SUFFIX(                                \
      const void* desc, int n_tail, int n_grid, void* work, void* x_out,     \
      const void* b, void* x_mid, void* bc, void* xc, const void* Mc,        \
      int n7, long long b7_off, long long x7_off, int tile, int k,           \
      int halo_down, int halo_up, int reach, void* stream) {                 \
    return fused_subcycle<T>(desc, n_tail, n_grid, (T*)work, (T*)x_out,      \
                             (const T*)b, (T*)x_mid, (T*)bc, (T*)xc,         \
                             (const T*)Mc, n7, (int64_t)b7_off,              \
                             (int64_t)x7_off, tile, k, halo_down, halo_up,   \
                             reach, stream);                                 \
  }

AMG_DEFINE_SUBCYCLE(f32, float)
AMG_DEFINE_SUBCYCLE(f64, double)
