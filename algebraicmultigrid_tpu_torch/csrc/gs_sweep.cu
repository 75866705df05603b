// K5: one multicolor GS/SOR smoother application on a Lat2D level, as one
// launch (Hopper, sm_90a).
//
// Replaces the Pallas TPU kernel _sweep_kernel of the JAX package's
// ops/pallas/gs_kernel.py (pallas_call in smooth_pallas_gs).  The TPU
// version pre-tiles A with duplicated halos at cache build and re-tiles x
// and b on every call, a layout for its VMEM blocks; here the Lat2D planes,
// x, b and dinv are read in place.  The level is the grid (Wx, 1, Wy) of
// the march (csrc/sweep_march.cuh, planned by ops/kernels/tiled_sweep.py
// plan_march): a block walks a strip of the level's rows, 1 x E2 cells
// (the tile plus a halo of n_steps * reach_y on the contiguous axis), over
// a segment of rows, each row's x landing once in a ring in shared memory
// by cp.async and the color steps running as a wavefront a reach behind
// each other.  A thread owns a pair of neighbours along a row, one cell of
// each color on the red-black L0.
//
// What bounds it: bytes (n_off planes, b, dinv and x read once, x written
// once: 9 words a cell on a 5-point level, 13 on a 9-point one), plus x's
// strip halo and the segments' end rows.
//
// The halo-tile kernel (csrc/sweep_tile.cuh on the grid (1, Wx, Wy), a
// 32 x 64 box a block), K5's first design, stays as amg_gs_sweep_<T>: the
// march takes every level it takes, and it is only the comparison that
// chip_smoke.py and the card tests hold the march against.
//
// The entry points launch on the caller's stream, allocate nothing and
// return a CUDA error code for the wrapper to check.

#include "sweep_march.cuh"
#include "sweep_tile.cuh"

// The march's instances on a Lat2D level, chosen by the offset count:
// blocks of at most 512 threads (a strip of at most 1024 cells, a pair a
// thread), which leaves a thread 128 registers, and the rows a time step
// loads, steps and stores: 2 on the 5-point level (L0), 4 on the 9-point
// ones (kernel_variants.py sweeps march2d on an H100: L0 0.304 ms at 2
// rows against 0.355 at 4; L1 0.079 at 4 against 0.083 at 2 and 0.100 at
// 8; the 1024-thread bound 0.305 and 0.091).  Other counts take the
// generic instance, and past kMaxOff offsets (the structured Ruge-Stueben
// hierarchy's coarse levels) the wide one.
constexpr int kGsMarchThreads = 512;
constexpr int kGsBatch5 = 2;
constexpr int kGsBatch9 = 4;

template <typename T>
amg::MarchInstance<T> gs_march(int n_off) {
  if (n_off == 5) return {amg::march_sweep_kernel<T, 5, kGsMarchThreads, kGsBatch5>, kGsBatch5, kGsMarchThreads, 5};
  if (n_off == 9) return {amg::march_sweep_kernel<T, 9, kGsMarchThreads, kGsBatch9>, kGsBatch9, kGsMarchThreads, 9};
  if (n_off > amg::kMaxOff) {
    return {amg::march_sweep_kernel<T, -1, kGsMarchThreads, amg::kMarchBatch>, amg::kMarchBatch, kGsMarchThreads,
            amg::kMarchMaxOff};
  }
  return {amg::march_sweep_kernel<T, 0, kGsMarchThreads, amg::kMarchBatch>, amg::kMarchBatch, kGsMarchThreads,
          amg::kMaxOff};
}

// x_out = the smoother applied to x_in with rhs b on a Wx x Wy Lat2D level
// by the halo-tile kernel: A [n_off, Wx, Wy], dinv [Wx * Wy], dims (1, Wx,
// Wy), offs n_off triples (0, dx, dy), color table per = (1, a, b), ext =
// (1, Ex, Ey) the loaded box; pad counts x's rows past the level.
#define AMG_GS_SWEEP_ENTRY(T, SUFFIX)                                          \
  extern "C" int amg_gs_sweep_##SUFFIX(                                        \
      void* x_out, const void* x_in, const void* b, const void* A,             \
      const void* dinv, const int* dims, const int* offs, int n_off,           \
      const int* per, const int* tab, const int* steps, int n_steps,           \
      const int* ext, int pad, double omega, void* stream) {                   \
    return amg::launch_tiled_sweep<T, 2>(x_out, x_in, b, A, dinv, dims, offs,  \
                                         n_off, per, tab, steps, n_steps, ext, \
                                         pad, omega, stream);                  \
  }

// the same on the march: dims (Wx, 1, Wy), offs (dx, 0, dy), per (a, 1,
// b), plan = (1, E2, seg): the strip and the rows a segment owns
#define AMG_GS_SWEEP_MARCH_ENTRY(T, SUFFIX)                                    \
  extern "C" int amg_gs_sweep_march_##SUFFIX(                                  \
      void* x_out, const void* x_in, const void* b, const void* A,             \
      const void* dinv, const int* dims, const int* offs, int n_off,           \
      const int* per, const int* tab, const int* steps, int n_steps,           \
      const int* plan, int pad, double omega, void* stream) {                  \
    if (dims[1] != 1 || per[1] != 1 || plan[0] != 1)                           \
      return (int)cudaErrorInvalidValue;                                       \
    return amg::launch_march_sweep<T>(gs_march<T>(n_off), x_out, x_in, b, A,   \
                                      dinv, dims, offs, n_off, per, tab,       \
                                      steps, n_steps, plan, pad, omega,        \
                                      stream);                                 \
  }

// the rows a time step of the march takes on a level of n_off offsets
extern "C" int amg_gs_sweep_march_batch(int n_off) {
  return gs_march<float>(n_off).batch;
}

// the shared memory of a march block over a 1 x E2 strip (the wrapper's
// plan checks it)
extern "C" int amg_gs_sweep_march_smem_bytes(int E1, int E2, int n_steps, int r0, int itemsize, int n_off) {
  return (int)amg::march_smem_bytes(E1, E2, amg::march_ring(n_steps, r0, gs_march<float>(n_off).batch), itemsize);
}

// the march blocks an SM holds on a level of n_off offsets over a 1 x E2
// strip with `smem` bytes a block (the planner fills waves with it)
extern "C" int amg_gs_sweep_march_blocks_per_sm(int n_off, int itemsize, int E2, int smem) {
  const int threads = amg::march_threads(1, E2);
  return itemsize == 8 ? amg::march_blocks_per_sm(gs_march<double>(n_off), threads, (size_t)smem)
                       : amg::march_blocks_per_sm(gs_march<float>(n_off), threads, (size_t)smem);
}

AMG_GS_SWEEP_ENTRY(float, f32)
AMG_GS_SWEEP_ENTRY(double, f64)
AMG_GS_SWEEP_MARCH_ENTRY(float, f32)
AMG_GS_SWEEP_MARCH_ENTRY(double, f64)
