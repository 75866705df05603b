// The whole-tail V-cycle (K4) on a tail with non-factored levels (Hopper,
// sm_90a), as ONE cooperative launch: the entries amg_fused_tail_nf_*.
//
// Replaces the non-factored (else) branches of the Pallas TPU kernel
// _tail_go in the JAX package's ops/pallas/tail_kernel.py (via
// fused_tail): a tail level without the factored stash restricts with
// b_c[c] = sum_q R_q[c] r[k c + d_q] and corrects with
// x += sum_q P_q[i] x_c[i / k + d_q] through its R planes (over the coarse
// grid, at the vectors' type, as the reference's tail cache keeps them) and
// P planes (of the planes' type).  The recursion, the barriers and the
// coarse solve are tail_kernel.cu's (tail_levels.cuh, instance NF = true);
// a level whose entry in the Transfer table has no R planes runs the
// factored code.  A separate source, so tail_kernel.cu's factored entries
// and K9 compile as before and the two build in parallel.
//
// What bounds it: as tail_kernel.cu, the chain of dependent phases and the
// grid barriers between them, not bytes (about 11 MB of planes at 4096^2,
// L2-resident).  Design: the factored K4's.  A non-factored grid level
// (456^2 and 153^2 at 4096^2) runs each leg as one phase of independent
// tiles, K1's and K2's non-factored tiles (leg_tile.cuh tile_down_nf,
// tile_up_nf) with the tail's thread map: A, D^-1 and b in registers,
// every color step in shared memory, each R and P coefficient read once
// where it is used; the down leg hands x to the up leg through the level's
// x_mid, so a leg costs one grid barrier (4 a cycle at 4096^2).  The
// levels' planned tiles come from the wrapper (LevelDesc::tile_x the down
// leg's, Transfer::up_x the up leg's).  The first design ran every pass as
// a grid-stride loop with a grid barrier each, 2 x (7 color steps + 2) a
// grid level: 0.425-0.429 ms with bf16 planes on an H100 (PERF.md).  A
// grid level with no tile (other than 5 or 9 points, a box past the
// register map; decided by the plan from the shapes) keeps those passes,
// and the levels of at most kBlockCells cells run them in block 0 with
// __syncthreads().
//
// Every entry point launches on the caller's stream, allocates nothing,
// and returns a CUDA error code for the wrapper to check.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tail_levels.cuh"

namespace {

using amg::kMaxTailLevels;
using amg::LevelDesc;
using amg::Transfer;

// tail_kernel.cu's block: one an SM with the tiled legs' thread map
constexpr int kTailThreads = amg::kLegWarps * 32;

template <typename T, typename C, typename D>
__global__ void __launch_bounds__(kTailThreads)
    tail_nf_kernel(const LevelDesc* lv, const Transfer* tf, int n_lvl,
                   int n_grid, T* work, T* x_out, const T* x_in,
                   const T* b_in, const T* __restrict__ Mc, int n7,
                   int64_t b7_off, int64_t x7_off) {
  extern __shared__ __align__(16) unsigned char tail_smem[];
  __shared__ LevelDesc sh[kMaxTailLevels];
  __shared__ Transfer shtf[kMaxTailLevels];
  amg::load_table(sh, lv, n_lvl);
  amg::load_table(shtf, tf, n_lvl);
  amg::tail_cycle<T, C, D, true>(sh, n_lvl, n_grid, work, x_out, x_in, b_in,
                                 Mc, n7, b7_off, x7_off, tail_smem, 0, false,
                                 shtf);
}

template <typename T, typename C, typename D>
int fused_tail_nf(const void* desc, const void* transfers, int n_lvl,
                  int n_grid, T* work, T* x_out, const T* x_in,
                  const T* b_in, const T* Mc, int n7, int64_t b7_off,
                  int64_t x7_off, int smem, void* stream_ptr) {
  if (transfers == nullptr || n_lvl < 1 || n_lvl > kMaxTailLevels ||
      n_grid < 0 || n_grid > n_lvl || n7 < 1 || smem < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const LevelDesc* lv = (const LevelDesc*)desc;
  const Transfer* tf = (const Transfer*)transfers;
  void* args[] = {&lv, &tf, &n_lvl, &n_grid, &work, &x_out, &x_in,
                  &b_in, &Mc, &n7, &b7_off, &x7_off};
  return amg::launch_cooperative((const void*)tail_nf_kernel<T, C, D>,
                                 kTailThreads, args, (cudaStream_t)stream_ptr,
                                 (size_t)smem);
}

}  // namespace

extern "C" int amg_tail_transfer_bytes() { return (int)sizeof(Transfer); }

// Fill entry `l` of a host-side Transfer array with a non-factored level's
// R and P planes, their offsets and its up leg's tile ((0, 0) where the
// level runs pass by pass; the wrapper copies the array to the card once
// per cache; a factored level's entry stays zero).
extern "C" int amg_tail_fill_transfer(void* table, int l, const void* R,
                                      const void* P, const int* offs_r,
                                      int n_r, const int* offs_p, int n_p,
                                      int up_x, int up_y) {
  if (l < 0 || l >= kMaxTailLevels ||
      amg::fill_transfer((Transfer*)table + l, R, P, offs_r, n_r, offs_p,
                         n_p, up_x, up_y)) {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

// one entry per (vector, plane) type: T vectors, C planes A/P, D dinv (and
// R, at T)
#define AMG_DEFINE_TAIL_NF(SUFFIX, T, C, D)                                  \
  extern "C" int amg_fused_tail_nf_##SUFFIX(                                 \
      const void* desc, const void* transfers, int n_lvl, int n_grid,        \
      void* work, void* x_out, const void* x_in, const void* b_in,           \
      const void* Mc, int n7, long long b7_off, long long x7_off, int smem,  \
      void* stream) {                                                        \
    return fused_tail_nf<T, C, D>(desc, transfers, n_lvl, n_grid, (T*)work,  \
                                  (T*)x_out, (const T*)x_in, (const T*)b_in, \
                                  (const T*)Mc, n7, (int64_t)b7_off,         \
                                  (int64_t)x7_off, smem, stream);            \
  }

AMG_DEFINE_TAIL_NF(f32, float, float, float)
AMG_DEFINE_TAIL_NF(f64, double, double, double)
AMG_DEFINE_TAIL_NF(f32_bf16, float, __nv_bfloat16, float)
AMG_DEFINE_TAIL_NF(f64_bf16, double, __nv_bfloat16, double)
