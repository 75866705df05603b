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
//   A  level t's down leg from zero: every presmooth color step, r = b - A x,
//      g = S r and the box-k sums of T (r - A g); x to x_mid, b_c;
//   B  the tail recursion from the zero guess on b_c, writing x_c;
//   C  level t's up leg: x_mid + Tup - S (A Tup), Tup = T upsample_k(x_c)
//      formed on the fly, then the postsmooth steps; x to x_out.
//
// What bounds it on the card: at 4096^2 level t is L1 (1366^2, 9 planes,
// ~0.1 GB in f32, a ~0.035 ms byte bound with the tail's planes) and the
// tail is K4's; neither bound is near.  Its first version (its own tile
// code, K4's one-barrier-a-pass tail) took ~1.03 ms on an H100
// (profile_torch.py, kernel_variants.py): phase B was K4's ~0.43 ms of
// grid barriers, and phases A and C, latency-bound, about what the
// per-pass L1 legs take (~0.6 ms).
//
// Design.  The TPU kernel walks full-width slabs of level t in order on one
// core and keeps x_mid and the coarse vectors in VMEM.  Here the three
// phases are K4's recursion (tail_levels.cuh tail_cycle) over level t and
// its tail, from the zero guess: level t is the table's first level, so
// phase A is its down leg from zero, phase B the tail, phase C its up leg.
// Level t takes the tail's plan like any grid level: a 5- or 9-point level
// whose box fits the register map runs each leg as one tiled phase
// (leg_tile.cuh, K3's code: the tile plus a halo of (n_steps + 2) * reach
// (A) or n_steps * reach (C) in shared memory, every color step there, the
// owned coarse cells summed in the order of stencil.cuh::restrict_cell),
// any other level pass by pass, and a level of at most kBlockCells cells
// in block 0.  At 4096^2 (L1, L2, L3 tiled) that is 3 + 1 + 2 = 6 grid
// barriers.  Level t is read in place (unpadded planes, b and D^-1); x_mid,
// b_c and x_c live in the tail's work buffer.  The wrapper passes that
// buffer and the dynamic shared memory size (the descriptors, then the
// largest tile's buffers); the kernel allocates nothing.  The grid is as
// many blocks as fit on the card at once (launch_cooperative).
//
// bf16 coefficient planes (the entries amg_fused_subcycle_f32_bf16 and
// amg_fused_subcycle_f64_bf16): the A, T and S planes of level t and of its
// tail in bf16, D^-1, the coarse operator and the vectors in float32 or
// float64, as the reference's subcycle cache stores them under
// AMG_COEF_DTYPE=bfloat16 (level t rounded from the working dtype, like a
// tail level).  The recursion is tail_levels.cuh's with the plane type C =
// __nv_bfloat16 and D = T, K4's bf16 instance: each coefficient is
// converted to the vectors' type where it is loaded, and a tiled level keeps
// its converted coefficients in registers, so the arithmetic is the same
// code a type apart.

#include <cuda_runtime.h>

#include <cstdint>

#include "tail_levels.cuh"

namespace {

using amg::kMaxTableLevels;
using amg::LevelDesc;

// one block an SM with the tiled legs' thread map, as K4 (leg_tile.cuh
// kLegWarps)
constexpr int kSubThreads = amg::kLegWarps * 32;
constexpr int kSubMinBlocks = 1;

// the descriptor table's bytes at the head of dynamic shared memory,
// rounded up so the tile buffers after it stay 16-byte aligned
__host__ __device__ inline unsigned table_bytes(int n_lvl) {
  return (unsigned)((sizeof(LevelDesc) * n_lvl + 15) / 16 * 16);
}

// lv[0] is level t, lv[1 .. n_lvl - 1] its tail.  Dynamic shared memory
// holds the n_lvl descriptors, then the tile buffers.
template <typename T, typename C, typename D>
__global__ void __launch_bounds__(kSubThreads, kSubMinBlocks)
    subcycle_kernel(const LevelDesc* lv, int n_lvl, int n_grid, T* work,
                    T* x_out, const T* b, const T* __restrict__ Mc, int n7,
                    int64_t b7_off, int64_t x7_off) {
  extern __shared__ __align__(16) unsigned char sub_smem[];
  LevelDesc* sh = reinterpret_cast<LevelDesc*>(sub_smem);
  amg::load_table(sh, lv, n_lvl);
  amg::tail_cycle<T, C, D>(sh, n_lvl, n_grid, work, x_out, nullptr, b, Mc,
                           n7, b7_off, x7_off, sub_smem, table_bytes(n_lvl),
                           false);
}

template <typename T, typename C, typename D>
int fused_subcycle(const void* desc, int n_lvl, int n_grid, T* work,
                   T* x_out, const T* b, const T* Mc, int n7, int64_t b7_off,
                   int64_t x7_off, int smem, void* stream_ptr) {
  if (n_lvl < 2 || n_lvl > kMaxTableLevels || n_grid < 0 || n_grid > n_lvl ||
      n7 < 1 || smem < (int)table_bytes(n_lvl)) {
    return (int)cudaErrorInvalidValue;
  }
  const LevelDesc* lv = (const LevelDesc*)desc;
  void* args[] = {&lv, &n_lvl, &n_grid, &work,   &x_out,
                  &b,  &Mc,    &n7,     &b7_off, &x7_off};
  return amg::launch_cooperative((const void*)subcycle_kernel<T, C, D>,
                                 kSubThreads, args, (cudaStream_t)stream_ptr,
                                 (size_t)smem);
}

}  // namespace

// one entry per (vector, plane) type: T vectors, C planes A/T/S, D dinv
#define AMG_DEFINE_SUBCYCLE(SUFFIX, T, C, D)                                 \
  extern "C" int amg_fused_subcycle_##SUFFIX(                                \
      const void* desc, int n_lvl, int n_grid, void* work, void* x_out,      \
      const void* b, const void* Mc, int n7, long long b7_off,               \
      long long x7_off, int smem, void* stream) {                            \
    return fused_subcycle<T, C, D>(desc, n_lvl, n_grid, (T*)work, (T*)x_out, \
                                   (const T*)b, (const T*)Mc, n7,            \
                                   (int64_t)b7_off, (int64_t)x7_off, smem,   \
                                   stream);                                  \
  }

AMG_DEFINE_SUBCYCLE(f32, float, float, float)
AMG_DEFINE_SUBCYCLE(f64, double, double, double)
AMG_DEFINE_SUBCYCLE(f32_bf16, float, __nv_bfloat16, float)
AMG_DEFINE_SUBCYCLE(f64_bf16, double, __nv_bfloat16, double)
