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
// sit in the 50 MB L2, and a few MFLOP.  What costs is the chain of ~90
// dependent passes.  Launched one kernel per pass, each costs a launch on
// the host; here each costs one barrier.
//
// Design.  The TPU kernel holds every level in VMEM and runs the recursion
// as one program on one core.  Here one cooperative launch walks the same
// recursion: every pass is a grid-stride loop and dependent passes are
// separated by grid.sync().  Levels of at most kBlockCells cells (51^2 and
// below at 4096^2) and the coarse solve run inside block 0 alone, with
// __syncthreads() between passes, while the other blocks wait at the next
// grid barrier: a block barrier is far cheaper than a grid barrier, and
// these levels have fewer cells than a block has threads times four.  One
// 1024-thread block per SM keeps the grid barrier's arrivals few (on an
// H100, kernel_variants.py: 0.39 ms; 0.43 ms with every level on the
// grid; 0.55 ms with 512-thread blocks).  The recursion itself lives in
// tail_levels.cuh, shared with the phased whole-subcycle kernel K9.
// Planes stay unpadded and stencil reads outside the grid are guarded to
// zero (the TPU's halo and one-hot selector matmuls do not carry over).
// The wrapper passes one work buffer for every level's x, b, r, g and the
// coarse vectors; the kernel allocates nothing.

#include <cuda_runtime.h>

#include <cstdint>

#include "tail_levels.cuh"

namespace {

using amg::kMaxTailLevels;
using amg::TailLevel;

constexpr int kTailThreads = 1024;

template <typename T>
__global__ void __launch_bounds__(kTailThreads)
    tail_kernel(const TailLevel* lv, int n_lvl, int n_grid, T* work,
                T* x_out, const T* x_in, const T* b_in,
                const T* __restrict__ Mc, int n7, int64_t b7_off,
                int64_t x7_off) {
  __shared__ TailLevel sh[kMaxTailLevels];
  amg::load_levels(sh, lv, n_lvl);
  amg::tail_cycle<T>(sh, n_lvl, n_grid, work, x_out, x_in, b_in, Mc, n7,
                     b7_off, x7_off);
}

template <typename T>
int fused_tail(const void* desc, int n_lvl, int n_grid, T* work, T* x_out,
               const T* x_in, const T* b_in, const T* Mc, int n7,
               int64_t b7_off, int64_t x7_off, void* stream_ptr) {
  if (n_lvl < 1 || n_lvl > kMaxTailLevels || n_grid < 0 || n_grid > n_lvl ||
      n7 < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const TailLevel* lv = (const TailLevel*)desc;
  void* args[] = {&lv, &n_lvl, &n_grid, &work, &x_out, &x_in,
                  &b_in, &Mc, &n7, &b7_off, &x7_off};
  return amg::launch_cooperative((const void*)tail_kernel<T>, kTailThreads,
                                 args, (cudaStream_t)stream_ptr);
}

}  // namespace

extern "C" int amg_tail_level_bytes() { return (int)sizeof(TailLevel); }

extern "C" int amg_tail_block_cells() { return amg::kBlockCells; }

// Fill descriptor `l` of a host-side TailLevel array (the wrapper copies the
// array to the card once per cache): a tail's levels, or a subcycle's top
// level followed by its tail's.
extern "C" int amg_tail_fill_level(void* table, int l, const void* A,
                                   const void* dinv, const void* Tp,
                                   const void* S, long long x_off,
                                   long long b_off, long long r_off,
                                   long long g_off, int Wx, int Wy, int Wxc,
                                   int Wyc, int k, const int* offs, int n_off,
                                   const int* ctab, int ca, int cb,
                                   const int* steps, int n_steps,
                                   double omega) {
  if (l < 0 || l >= amg::kMaxTableLevels || n_steps < 1 ||
      n_steps > amg::kMaxSteps || (k != 2 && k != 3)) {
    return (int)cudaErrorInvalidValue;
  }
  TailLevel* L = (TailLevel*)table + l;
  if (amg::make_stencil(&L->st, offs, n_off) ||
      amg::make_colors(&L->cg, ctab, ca, cb)) {
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
  L->Wx = Wx;
  L->Wy = Wy;
  L->Wxc = Wxc;
  L->Wyc = Wyc;
  L->k = k;
  L->n_steps = n_steps;
  for (int s = 0; s < n_steps; ++s) L->steps[s] = steps[s];
  L->omega = omega;
  return 0;
}

#define AMG_DEFINE_TAIL(SUFFIX, T)                                           \
  extern "C" int amg_fused_tail_##SUFFIX(                                    \
      const void* desc, int n_lvl, int n_grid, void* work, void* x_out,      \
      const void* x_in, const void* b_in, const void* Mc, int n7,            \
      long long b7_off, long long x7_off, void* stream) {                    \
    return fused_tail<T>(desc, n_lvl, n_grid, (T*)work, (T*)x_out,           \
                         (const T*)x_in, (const T*)b_in, (const T*)Mc, n7,   \
                         (int64_t)b7_off, (int64_t)x7_off, stream);          \
  }

AMG_DEFINE_TAIL(f32, float)
AMG_DEFINE_TAIL(f64, double)
