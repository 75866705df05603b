// K5: one multicolor GS/SOR smoother application on a Lat2D level, as one
// launch (Hopper, sm_90a).
//
// Replaces the Pallas TPU kernel _sweep_kernel of the JAX package's
// ops/pallas/gs_kernel.py (pallas_call in smooth_pallas_gs).  The TPU
// version pre-tiles A with duplicated halos at cache build and re-tiles x
// and b on every call, a layout for its VMEM blocks; here the Lat2D planes,
// x, b and dinv are read in place and only x's tile plus halo is staged in
// shared memory (csrc/sweep_tile.cuh has the design, the halo argument and
// what bounds it).  The level is the grid (1, Wx, Wy) of the shared kernel.
//
// The entry points launch on the caller's stream, allocate nothing and
// return a CUDA error code for the wrapper to check.

#include "sweep_tile.cuh"

// x_out = the smoother applied to x_in with rhs b on a Wx x Wy Lat2D level:
// A [n_off, Wx, Wy], dinv [Wx * Wy], offs n_off triples (0, dx, dy), color
// table per = (1, a, b), ext = (1, Ex, Ey) the loaded box.
#define AMG_GS_SWEEP_ENTRY(T, SUFFIX)                                          \
  extern "C" int amg_gs_sweep_##SUFFIX(                                        \
      void* x_out, const void* x_in, const void* b, const void* A,             \
      const void* dinv, const int* dims, const int* offs, int n_off,           \
      const int* per, const int* tab, const int* steps, int n_steps,           \
      const int* ext, double omega, void* stream) {                            \
    return amg::launch_tiled_sweep<T, 2>(x_out, x_in, b, A, dinv, dims, offs,  \
                                         n_off, per, tab, steps, n_steps, ext, \
                                         omega, stream);                       \
  }

AMG_GS_SWEEP_ENTRY(float, f32)
AMG_GS_SWEEP_ENTRY(double, f64)
