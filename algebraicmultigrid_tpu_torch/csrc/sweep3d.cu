// K7: one multicolor GS/SOR smoother application on a 3-D LatND level, as
// one launch (Hopper, sm_90a).
//
// Replaces the Pallas TPU kernel _sweep3d_kernel of the JAX package's
// ops/pallas/sweep3d_kernel.py (pallas_call in _sweep3d_call, via
// smooth_sweep3d).  The TPU version marches over x-slabs of full y-z planes
// in VMEM; at 256^3 one y-z plane of float32 is 256 KB, over an SM's shared
// memory.  So a block marches along axis 0 over a y-z column (tile plus
// halo on axes 1 and 2) and a segment of planes, each plane's x landing
// once in a ring in shared memory by cp.async and the color steps running
// as a wavefront a reach behind each other (csrc/sweep_march.cuh, planned
// by ops/kernels/tiled_sweep.py plan_march).
//
// The halo-tile kernel (csrc/sweep_tile.cuh's 3-D instantiation, all three
// axes tiled), K7's first design, stays as amg_sweep3d_<T>: the march takes
// every level it takes, and it is only the comparison that chip_smoke.py
// and the card tests hold the march against.
//
// bf16 coefficient planes under float32 vectors (amg_sweep3d_march_f32_bf16,
// the reference's AMG_COEF_DTYPE=bfloat16 on a 3-D level): the same march
// with the plane type C = __nv_bfloat16, each coefficient converted to float
// where it is loaded; D^-1, b, x and the ring stay float32 (the reference's
// K7 keeps D^-1 at the working dtype).  The halo-tile kernel takes no bf16
// planes.
//
// The entry points launch on the caller's stream, allocate nothing and
// return a CUDA error code for the wrapper to check.

#include "sweep_march.cuh"
#include "sweep_tile.cuh"

// the march's instances on a 3-D level: blocks of up to 1024 threads, 4
// planes a time step, the 7-point stencil's offsets as a constant; planes
// of type C
template <typename T, typename C = T>
amg::MarchInstance<T, C> sweep3d_march(int n_off) {
  if (n_off == 7) return {amg::march_sweep_kernel<T, 7, 1024, amg::kMarchBatch, C>, amg::kMarchBatch, 1024, 7};
  return {amg::march_sweep_kernel<T, 0, 1024, amg::kMarchBatch, C>, amg::kMarchBatch, 1024, amg::kMaxOff};
}

// x_out = the smoother applied to x_in with rhs b on an n0 x n1 x n2 LatND
// level: A [n_off, n0, n1, n2], dinv [n0 * n1 * n2], offs n_off triples,
// color table of periods per; the halo-tile kernel with ext the loaded box;
// pad counts x's rows past the level.
#define AMG_SWEEP3D_ENTRY(T, SUFFIX)                                           \
  extern "C" int amg_sweep3d_##SUFFIX(                                         \
      void* x_out, const void* x_in, const void* b, const void* A,             \
      const void* dinv, const int* dims, const int* offs, int n_off,           \
      const int* per, const int* tab, const int* steps, int n_steps,           \
      const int* ext, int pad, double omega, void* stream) {                   \
    return amg::launch_tiled_sweep<T, 3>(x_out, x_in, b, A, dinv, dims, offs,  \
                                         n_off, per, tab, steps, n_steps, ext, \
                                         pad, omega, stream);                  \
  }

// the same on the march: plan = (E1, E2, seg), the y-z box and the planes
// a segment owns; T vectors, C planes
#define AMG_SWEEP3D_MARCH_ENTRY(T, C, SUFFIX)                                  \
  extern "C" int amg_sweep3d_march_##SUFFIX(                                   \
      void* x_out, const void* x_in, const void* b, const void* A,             \
      const void* dinv, const int* dims, const int* offs, int n_off,           \
      const int* per, const int* tab, const int* steps, int n_steps,           \
      const int* plan, int pad, double omega, void* stream) {                  \
    return amg::launch_march_sweep(sweep3d_march<T, C>(n_off), x_out, x_in, b, \
                                   A, dinv, dims, offs, n_off, per, tab,       \
                                   steps, n_steps, plan, pad, omega, stream);  \
  }

// the shared memory of a march block over an E1 x E2 box (the wrapper's
// plan checks it): x's ring alone, at the vectors' itemsize (the planes are
// read in place, whatever their type)
extern "C" int amg_sweep3d_march_smem_bytes(int E1, int E2, int n_steps, int r0, int itemsize) {
  return (int)amg::march_smem_bytes(E1, E2, amg::march_ring(n_steps, r0, amg::kMarchBatch), itemsize);
}

// the march blocks an SM holds on a level of n_off offsets over an E1 x E2
// box with `smem` bytes a block (the planner fills waves with it), for the
// instance of the vectors' and the planes' itemsizes (8/8, 4/4 or 4/2)
extern "C" int amg_sweep3d_march_blocks_per_sm(int n_off, int itemsize, int coef_itemsize, int E1, int E2,
                                               int smem) {
  const int threads = amg::march_threads(E1, E2);
  if (itemsize == 8) return amg::march_blocks_per_sm(sweep3d_march<double>(n_off), threads, (size_t)smem);
  if (coef_itemsize == 2) {
    return amg::march_blocks_per_sm(sweep3d_march<float, __nv_bfloat16>(n_off), threads, (size_t)smem);
  }
  return amg::march_blocks_per_sm(sweep3d_march<float>(n_off), threads, (size_t)smem);
}

AMG_SWEEP3D_ENTRY(float, f32)
AMG_SWEEP3D_ENTRY(double, f64)
AMG_SWEEP3D_MARCH_ENTRY(float, float, f32)
AMG_SWEEP3D_MARCH_ENTRY(double, double, f64)
AMG_SWEEP3D_MARCH_ENTRY(float, __nv_bfloat16, f32_bf16)
