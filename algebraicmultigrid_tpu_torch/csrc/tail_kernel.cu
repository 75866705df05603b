// Whole-tail V-cycle on the trailing run of small Lat2D levels (Hopper,
// sm_90a), as ONE cooperative launch.
//
// Replaces the Pallas TPU kernel _tail_kernel / _tail_go of the JAX
// package's ops/pallas/tail_kernel.py (via fused_tail), factored branch:
// for every tail level, fine to coarse, the presmooth color steps, the
// residual and the factored restriction b_c = box_k-sum(T * (r - A (S r)));
// at the bottom the dense coarse solve x_c = Mc b_c (Mc = R^-1 Q^T or the
// pseudo-inverse); then, coarse to fine, the correction
// x += Tup - S (A Tup), Tup = T * upsample_k(x_c), and the postsmooth.
// Every level below the entry starts from the zero guess.
//
// What bounds it on the card: neither bytes nor operations.  At 4096^2
// the tail is 456^2 ... 6^2 plus a 2x2 coarse grid: ~11 MB of planes, which
// sit in the 50 MB L2, and a few MFLOP.  What costs is the chain of
// dependent phases and the grid barriers between them.
//
// Design.  The TPU kernel holds every level in VMEM and runs the recursion
// as one program on one core.  Here one cooperative launch walks the same
// recursion (tail_levels.cuh, shared with the phased whole-subcycle kernel
// K9).  The grid levels (456^2 and 153^2 at 4096^2) run each leg as one
// tiled phase, the tile plus a halo in shared memory with every color step
// there (leg_tile.cuh, K3's device code), so each leg costs one grid
// barrier; levels of at most kBlockCells cells (51^2 and below at 4096^2)
// and the coarse solve run inside block 0 alone, with __syncthreads()
// between passes, while the other blocks wait at the next grid barrier.
// A tiled level keeps its coefficients in registers (tile_leg_reg), so
// its color steps read only shared memory.  Grid barriers a cycle at
// 4096^2, counted from tail_cycle: 2 down + 1 after block 0 + 1 between
// the two up legs = 4 (the first version, one grid-stride pass a color
// step, residual, restriction and correction: 2 x 9 + 1 + 2 x 8 = 35,
// 0.395 ms on an H100).  A grid level with no tile (not 5- or 9-point, or
// its box past the register map; decided by the wrapper's plan from the
// shapes) keeps those passes.  One 512-thread block per SM.  Planes stay
// unpadded and stencil reads outside the grid are guarded to zero (the
// TPU's halo and one-hot selector matmuls do not carry over).  The wrapper passes one work buffer for every level's x, b, r, g,
// x_mid and the coarse vectors, and the tiles' dynamic shared memory size;
// the kernel allocates nothing.
//
// bf16 coefficient planes (the entries amg_fused_tail_f32_bf16 and
// amg_fused_tail_f64_bf16): the A, T and S planes of every level in bf16,
// D^-1 and the vectors in float32 or float64, as the reference's whole-tail
// cache stores them under AMG_COEF_DTYPE=bfloat16 with either working
// dtype; each coefficient is converted to the vectors' type where it is
// loaded (bf16 to float to double, exactly) and all the arithmetic stays in
// that type.  The same code, a type apart.

#include <cuda_runtime.h>

#include <cstdint>

#include "tail_levels.cuh"

namespace {

using amg::kMaxTailLevels;
using amg::LevelDesc;

// one block an SM with the tiled legs' thread map (leg_tile.cuh kLegWarps):
// the block-0 levels run with 512 threads too
constexpr int kTailThreads = amg::kLegWarps * 32;

template <typename T, typename C, typename D>
__global__ void __launch_bounds__(kTailThreads)
    tail_kernel(const LevelDesc* lv, int n_lvl, int n_grid, T* work,
                T* x_out, const T* x_in, const T* b_in,
                const T* __restrict__ Mc, int n7, int64_t b7_off,
                int64_t x7_off) {
  extern __shared__ __align__(16) unsigned char tail_smem[];
  __shared__ LevelDesc sh[kMaxTailLevels];
  amg::load_table(sh, lv, n_lvl);
  amg::tail_cycle<T, C, D>(sh, n_lvl, n_grid, work, x_out, x_in, b_in, Mc,
                           n7, b7_off, x7_off, tail_smem, 0, false);
}

template <typename T, typename C, typename D>
int fused_tail(const void* desc, int n_lvl, int n_grid, T* work, T* x_out,
               const T* x_in, const T* b_in, const T* Mc, int n7,
               int64_t b7_off, int64_t x7_off, int smem, void* stream_ptr) {
  if (n_lvl < 1 || n_lvl > kMaxTailLevels || n_grid < 0 || n_grid > n_lvl ||
      n7 < 1 || smem < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const LevelDesc* lv = (const LevelDesc*)desc;
  void* args[] = {&lv, &n_lvl, &n_grid, &work, &x_out, &x_in,
                  &b_in, &Mc, &n7, &b7_off, &x7_off};
  return amg::launch_cooperative((const void*)tail_kernel<T, C, D>,
                                 kTailThreads, args, (cudaStream_t)stream_ptr,
                                 (size_t)smem);
}

}  // namespace

extern "C" int amg_tail_level_bytes() { return (int)sizeof(LevelDesc); }

extern "C" int amg_tail_block_cells() { return amg::kBlockCells; }

// Fill descriptor `l` of a host-side LevelDesc array (the wrapper copies the
// array to the card once per cache): a tail's levels, or a subcycle's top
// level followed by its tail's.
extern "C" int amg_tail_fill_level(void* table, int l, const void* A,
                                   const void* dinv, const void* Tp,
                                   const void* S, long long x_off,
                                   long long b_off, long long r_off,
                                   long long g_off, long long m_off, int Wx,
                                   int Wy, int Wxc, int Wyc, int k,
                                   int tile_x, int tile_y, const int* offs,
                                   int n_off, const int* ctab, int ca, int cb,
                                   const int* steps, int n_steps,
                                   double omega) {
  if (l < 0 || l >= amg::kMaxTableLevels) return (int)cudaErrorInvalidValue;
  return amg::fill_level((LevelDesc*)table + l, A, dinv, Tp, S, x_off, b_off,
                         r_off, g_off, m_off, Wx, Wy, Wxc, Wyc, k, tile_x,
                         tile_y, offs, n_off, ctab, ca, cb, steps, n_steps,
                         omega);
}

// Bytes of shared memory a tile of tx x ty cells with this halo and reach
// takes (leg_tile.cuh), for the wrapper's plan.
extern "C" int amg_tile_smem_bytes(int tx, int ty, int halo, int reach,
                                   int itemsize) {
  return (int)amg::tile_smem_bytes(tx, ty, halo, reach, itemsize);
}

// one entry per (vector, plane) type: T vectors, C planes A/T/S, D dinv
#define AMG_DEFINE_TAIL(SUFFIX, T, C, D)                                     \
  extern "C" int amg_fused_tail_##SUFFIX(                                    \
      const void* desc, int n_lvl, int n_grid, void* work, void* x_out,      \
      const void* x_in, const void* b_in, const void* Mc, int n7,            \
      long long b7_off, long long x7_off, int smem, void* stream) {          \
    return fused_tail<T, C, D>(desc, n_lvl, n_grid, (T*)work, (T*)x_out,     \
                               (const T*)x_in, (const T*)b_in, (const T*)Mc, \
                               n7, (int64_t)b7_off, (int64_t)x7_off, smem,   \
                               stream);                                      \
  }

AMG_DEFINE_TAIL(f32, float, float, float)
AMG_DEFINE_TAIL(f64, double, double, double)
AMG_DEFINE_TAIL(f32_bf16, float, __nv_bfloat16, float)
AMG_DEFINE_TAIL(f64_bf16, double, __nv_bfloat16, double)
