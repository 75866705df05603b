// K7: one multicolor GS/SOR smoother application on a 3-D LatND level, as
// one launch (Hopper, sm_90a).
//
// Replaces the Pallas TPU kernel _sweep3d_kernel of the JAX package's
// ops/pallas/sweep3d_kernel.py (pallas_call in _sweep3d_call, via
// smooth_sweep3d).  The TPU version keeps x-slabs of full y-z planes in
// VMEM, from a second, halo-padded copy of every plane and an int32 color
// field; at 256^3 one y-z plane of float32 is 256 KB, over an SM's shared
// memory, and the copy would be 470 MB.  Here all three axes are tiled, the
// LatND planes, b and dinv are read in place, the color comes from the
// coordinates and the periodic table, and only x's tile plus halo is staged
// in shared memory (csrc/sweep_tile.cuh has the design, the halo argument
// and what bounds it).
//
// The entry points launch on the caller's stream, allocate nothing and
// return a CUDA error code for the wrapper to check.

#include "sweep_tile.cuh"

// x_out = the smoother applied to x_in with rhs b on an n0 x n1 x n2 LatND
// level: A [n_off, n0, n1, n2], dinv [n0 * n1 * n2], offs n_off triples,
// color table of periods per, ext the loaded box.
#define AMG_SWEEP3D_ENTRY(T, SUFFIX)                                           \
  extern "C" int amg_sweep3d_##SUFFIX(                                         \
      void* x_out, const void* x_in, const void* b, const void* A,             \
      const void* dinv, const int* dims, const int* offs, int n_off,           \
      const int* per, const int* tab, const int* steps, int n_steps,           \
      const int* ext, double omega, void* stream) {                            \
    return amg::launch_tiled_sweep<T, 3>(x_out, x_in, b, A, dinv, dims, offs,  \
                                         n_off, per, tab, steps, n_steps, ext, \
                                         omega, stream);                       \
  }

AMG_SWEEP3D_ENTRY(float, f32)
AMG_SWEEP3D_ENTRY(double, f64)
