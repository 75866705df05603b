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
// grid; 0.55 ms with 512-thread blocks).
// Planes stay unpadded and stencil reads outside the grid are guarded to
// zero (the TPU's halo and one-hot selector matmuls do not carry over).
// The restriction sums each coarse cell's k x k box of T (r - A g) in the
// same pass, one thread per coarse cell.  Color steps run in place, race
// free within a step because no two coupled cells share a color.
//
// The per-level descriptors (plane pointers, shapes, stencil, coloring,
// steps) exceed the kernel-parameter space, so they live in a device array
// of TailLevel (at most kMaxTailLevels levels), filled once per cache by
// amg_tail_fill_level and copied into shared memory at kernel start.  The
// wrapper passes one work buffer for every level's x, b, r, g and the
// coarse vectors; the kernel allocates nothing.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "stencil.cuh"

namespace {

namespace coop = cooperative_groups;
using amg::ColorGrid;
using amg::Stencil;

constexpr int kMaxTailLevels = 16;
constexpr int kTailThreads = 1024;
constexpr int kBlockCells = 4096;

struct TailLevel {
  const void* A;  // [nA, Wx, Wy] stencil planes
  const void* dinv;
  const void* Tp;
  const void* S;
  int64_t x_off;  // element offsets into the work buffer (level 0 uses the
  int64_t b_off;  // call's x_out and b_in instead of x_off and b_off)
  int64_t r_off;
  int64_t g_off;
  int Wx, Wy, Wxc, Wyc, k;
  int n_steps;
  int steps[amg::kMaxSteps];
  double omega;
  Stencil st;
  ColorGrid cg;
};

struct Span {  // the blocks first, first + stride, ... share a level's cells
  int first;
  int stride;
};

struct GridBarrier {
  coop::grid_group g;
  __device__ void operator()() { g.sync(); }
};

struct BlockBarrier {
  __device__ void operator()() { __syncthreads(); }
};

// presmooth, residual and restriction of one level; x_in == nullptr is the
// zero start
template <typename T, typename Barrier>
__device__ void level_down(const TailLevel& L, T* x, const T* x_in,
                           const T* b, T* r, T* g, T* bc, Span sp,
                           Barrier bar) {
  const T* A = (const T*)L.A;
  const T* dinv = (const T*)L.dinv;
  const T* Tp = (const T*)L.Tp;
  const T* S = (const T*)L.S;
  const int Wx = L.Wx, Wy = L.Wy;
  const T omega = (T)L.omega;
  for (int s = 0; s < L.n_steps; ++s) {
    const T* src = s == 0 ? x_in : (const T*)x;
    const int color = L.steps[s];
    amg::for_cells(Wx, Wy, sp.first, sp.stride, [&](int i, int j) {
      amg::step_cell(x, src, b, A, dinv, L.st, L.cg, color, omega, i, j, Wx,
                     Wy, s == 0);
    });
    bar();
  }
  amg::for_cells(Wx, Wy, sp.first, sp.stride, [&](int i, int j) {
    amg::residual_cell(r, g, (const T*)x, b, A, S, L.st, i, j, Wx, Wy);
  });
  bar();
  amg::for_cells(L.Wxc, L.Wyc, sp.first, sp.stride, [&](int I, int J) {
    amg::restrict_cell(bc, (const T*)r, (const T*)g, A, Tp, L.st, I, J, Wx, Wy,
                       L.Wyc, L.k);
  });
  bar();
}

// correction from the coarse x, then postsmooth
template <typename T, typename Barrier>
__device__ void level_up(const TailLevel& L, T* x, const T* b, const T* xc,
                         Span sp, Barrier bar) {
  const T* A = (const T*)L.A;
  const T* dinv = (const T*)L.dinv;
  const T* Tp = (const T*)L.Tp;
  const T* S = (const T*)L.S;
  const int Wx = L.Wx, Wy = L.Wy;
  const T omega = (T)L.omega;
  amg::for_cells(Wx, Wy, sp.first, sp.stride, [&](int i, int j) {
    amg::correct_cell(x, (const T*)x, xc, A, Tp, S, L.st, i, j, Wx, Wy, L.Wyc,
                      L.k);
  });
  bar();
  for (int s = 0; s < L.n_steps; ++s) {
    const int color = L.steps[s];
    amg::for_cells(Wx, Wy, sp.first, sp.stride, [&](int i, int j) {
      amg::step_cell(x, (const T*)x, b, A, dinv, L.st, L.cg, color, omega, i,
                     j, Wx, Wy, false);
    });
    bar();
  }
}

// Levels [0, n_grid) run on the whole grid, levels [n_grid, n_lvl) and the
// coarse solve on block 0.  Every thread of the grid reaches every
// grid.sync() (no early return).
template <typename T>
__global__ void __launch_bounds__(kTailThreads)
    tail_kernel(const TailLevel* lv, int n_lvl, int n_grid, T* work,
                T* x_out, const T* x_in, const T* b_in,
                const T* __restrict__ Mc, int n7, int64_t b7_off,
                int64_t x7_off) {
  __shared__ TailLevel sh[kMaxTailLevels];
  {
    const int words = n_lvl * (int)(sizeof(TailLevel) / sizeof(int));
    const int* src = (const int*)lv;
    int* dst = (int*)sh;
    for (int w = threadIdx.x; w < words; w += blockDim.x) dst[w] = src[w];
  }
  __syncthreads();

  GridBarrier gbar{coop::this_grid()};
  BlockBarrier bbar;
  const Span gspan{(int)blockIdx.x, (int)gridDim.x};
  const Span bspan{0, 1};

  auto X = [&](int l) -> T* { return l == 0 ? x_out : work + sh[l].x_off; };
  auto B = [&](int l) -> const T* {
    return l == 0 ? b_in : (const T*)(work + sh[l].b_off);
  };
  auto BC = [&](int l) -> T* {
    return work + (l + 1 < n_lvl ? sh[l + 1].b_off : b7_off);
  };
  auto XC = [&](int l) -> const T* {
    return l + 1 < n_lvl ? (const T*)X(l + 1) : (const T*)(work + x7_off);
  };
  auto down = [&](int l, Span sp, auto bar) {
    level_down<T>(sh[l], X(l), l == 0 ? x_in : (const T*)nullptr, B(l),
                  work + sh[l].r_off, work + sh[l].g_off, BC(l), sp, bar);
  };

  for (int l = 0; l < n_grid; ++l) down(l, gspan, gbar);
  if (blockIdx.x == 0) {
    for (int l = n_grid; l < n_lvl; ++l) down(l, bspan, bbar);
    const T* b7 = work + b7_off;
    T* x7 = work + x7_off;
    for (int i = threadIdx.x; i < n7; i += blockDim.x) {
      T acc = T(0);
      for (int t = 0; t < n7; ++t) acc += Mc[(int64_t)i * n7 + t] * b7[t];
      x7[i] = acc;
    }
    __syncthreads();
    for (int l = n_lvl - 1; l >= n_grid; --l) {
      level_up<T>(sh[l], X(l), B(l), XC(l), bspan, bbar);
    }
  }
  gbar();
  for (int l = n_grid - 1; l >= 0; --l) {
    level_up<T>(sh[l], X(l), B(l), XC(l), gspan, gbar);
  }
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

extern "C" int amg_tail_block_cells() { return kBlockCells; }

// Fill descriptor `l` of a host-side TailLevel array (the wrapper copies the
// array to the card once per cache).
extern "C" int amg_tail_fill_level(void* table, int l, const void* A,
                                   const void* dinv, const void* Tp,
                                   const void* S, long long x_off,
                                   long long b_off, long long r_off,
                                   long long g_off, int Wx, int Wy, int Wxc,
                                   int Wyc, int k, const int* offs, int n_off,
                                   const int* ctab, int ca, int cb,
                                   const int* steps, int n_steps,
                                   double omega) {
  if (l < 0 || l >= kMaxTailLevels || n_steps < 1 ||
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
