// The whole-tail V-cycle recursion over a table of Lat2D level
// descriptors, shared by the whole-tail kernel K4 (tail_kernel.cu, and
// tail_nf_kernel.cu for its non-factored levels) and the phased
// whole-subcycle kernel K9 (subcycle_kernel.cu, its phase B).
//
// For every tail level, fine to coarse: the presmooth color steps, the
// residual and the factored restriction b_c = box_k-sum(T * (r - A (S r)));
// at the bottom the dense coarse solve x_c = Mc b_c; then, coarse to fine,
// the correction x += Tup - S (A Tup), Tup = T * upsample_k(x_c), and the
// postsmooth.  Every level below the entry starts from the zero guess.
//
// Barriers.  A grid level with a tile (LevelDesc::tile_x > 0: a 5- or
// 9-point level whose box fits leg_tile.cuh's register map) runs each leg
// as one tiled phase (the tile plus a halo in shared memory, every color
// step there, halo erosion in place of barriers), so a leg costs one grid
// barrier; its down leg writes x to the level's x_mid and its up leg reads
// x_mid and writes x, so no tile reads cells that another tile of the same
// phase writes.  A grid level without a tile runs every pass as a
// grid-stride loop followed by grid.sync().  Levels of at most kBlockCells
// cells and the coarse solve run inside block 0 alone, pass by pass with
// __syncthreads(), while the other blocks wait at the next grid barrier.
// On an H100 (kernel_variants.py, its diagnostics) these block-0 passes
// take most of K4's 0.36 ms and the tiled grid levels the rest; walking
// the block-0 levels' tiles one after the other in block 0 took K4 to
// 0.53 ms (each tile's loads wait in turn).  At 4096^2 (grid levels 456^2
// and 153^2, 7 color steps a leg) K4 has 2 + 1 + 1 = 4 grid barriers a
// cycle (none after its last write), where one barrier a pass took 35.
// Color steps of the passes run in place, race free within a step because
// no two coupled cells share a color.  The restriction sums each coarse
// cell's k x k box of T (r - A g) in the same pass, one thread per coarse
// cell.
//
// Non-factored levels (the reference's _tail_go else branches; the
// instance with NF = true, K4's amg_fused_tail_nf_* entries in
// tail_nf_kernel.cu): a level whose
// Transfer holds R and P planes restricts with b_c[c] = sum_q R_q[c]
// r[k c + d_q] (R at the vectors' type, as the reference's tail keeps it)
// and corrects with x += sum_q P_q[i] x_c[i / k + d_q] (P of type C).  A
// tiled one (tile_x > 0: the down leg's tile; the up leg's, Transfer::up_x,
// may differ) runs each leg as one phase of tiles too, leg_tile.cuh's
// tile_down_nf and tile_up_nf with the same x_mid hand-over, so one grid
// barrier a leg; an untiled one runs pass by pass on the grid or in block
// 0.  A level with no R in the table is factored; the NF = false instance
// (K4's factored entries and K9) compiles none of it.
//
// The vectors and the arithmetic are of type T, the planes A, T and S of
// type C and dinv of type D (stencil.cuh): T itself, or with bf16 planes
// (K4 and K9, under float32 or float64 vectors) C = __nv_bfloat16 and
// D = T, the reference's whole-tail and subcycle caches keeping D^-1 at the
// working dtype.
//
// The per-level descriptors (plane pointers, shapes, stencil, coloring,
// steps, tiles) exceed the kernel-parameter space, so they live in a
// device array of LevelDesc, filled once per cache by amg_tail_fill_level
// and copied into shared memory at kernel start (load_table).  One work
// buffer holds every level's x, b, r, g, x_mid and the coarse vectors.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "leg_tile.cuh"

namespace amg {

namespace coop = cooperative_groups;

constexpr int kMaxTailLevels = 16;
// a descriptor table holds a tail, or a subcycle's top level and its tail
constexpr int kMaxTableLevels = kMaxTailLevels + 1;
constexpr int kBlockCells = 4096;

// A level's non-factored R/P planes, in a device table beside the LevelDesc
// table (amg_tail_fill_transfer); R == nullptr: a factored level.
struct Transfer {
  const void* R;  // [nR, Wxc, Wyc] restriction planes, the vectors' type
  const void* P;  // [nP, Wx, Wy] prolongation planes, the planes' type
  Stencil sr;     // coarse (I, J) reads fine (k I + dx, k J + dy)
  Stencil sp;     // fine (i, j) reads coarse (i / k + dx, j / k + dy)
  int up_x, up_y;  // the up leg's tile, multiples of k (0: untiled)
};

inline int fill_transfer(Transfer* t, const void* R, const void* P,
                         const int* offs_r, int n_r, const int* offs_p,
                         int n_p, int up_x, int up_y) {
  if (R == nullptr || P == nullptr || make_stencil(&t->sr, offs_r, n_r) ||
      make_stencil(&t->sp, offs_p, n_p) || up_x < 0 || up_y < 0 ||
      (up_x == 0) != (up_y == 0)) {
    return 1;
  }
  t->R = R;
  t->P = P;
  t->up_x = up_x;
  t->up_y = up_y;
  return 0;
}

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

// copy n entries of a device table (LevelDesc, Transfer) into shared memory
template <typename E>
__device__ __forceinline__ void load_table(E* sh, const E* table, int n) {
  const int words = n * (int)(sizeof(E) / sizeof(int));
  const int* src = (const int*)table;
  int* dst = (int*)sh;
  for (int w = threadIdx.x; w < words; w += blockDim.x) dst[w] = src[w];
  __syncthreads();
}

// the tiles (tx x ty cells) of a grid level, spread over the blocks
template <typename F>
__device__ __forceinline__ void for_level_tiles(const LevelDesc& L, int tx,
                                                int ty, F&& f) {
  if (tx <= 0 || ty <= 0) __trap();  // the plan tiles both legs or neither
  const int nty = tiles_of(L.Wy, ty);
  const int n = tiles_of(L.Wx, tx) * nty;
  for (int t = blockIdx.x; t < n; t += gridDim.x) f(t / nty, t % nty);
}

template <int K_, int NOFF_>
struct TileShape {
  static constexpr int K = K_, NOFF = NOFF_;
};

// f(TileShape<k, stencil points>{}) for a 5- or 9-point level (the plans
// tile no other)
template <typename F>
__device__ __forceinline__ void at_tile_shape(const LevelDesc& L, F&& f) {
  if (L.st.n != 5 && L.st.n != 9) __trap();
  if (L.k == 2) {
    if (L.st.n == 9) {
      f(TileShape<2, 9>{});
    } else {
      f(TileShape<2, 5>{});
    }
  } else if (L.st.n == 9) {
    f(TileShape<3, 9>{});
  } else {
    f(TileShape<3, 5>{});
  }
}

// The down leg of a tiled non-factored grid level, tile by tile with the
// tail's thread map: the steps from x_in (nullptr: zero), x over each
// tile to x_mid, the tiles' coarse cells of b_c from the R planes (at T).
template <typename T, typename C, typename D>
__device__ void level_down_nf_tiles(const LevelDesc& L, const Transfer& tf,
                                    unsigned char* smem, unsigned smem_off,
                                    const T* x_in, const T* b, T* x_mid,
                                    T* bc) {
  at_tile_shape(L, [&](auto s) {
    using S = decltype(s);
    for_level_tiles(L, L.tile_x, L.tile_y, [&](int ti, int tj) {
      tile_down_nf<T, S::K, S::NOFF, kLegWarps, kLegRows, kLegCols, C, D, T>(
          L, (const T*)tf.R, tf.sr, smem, smem_off, ti, tj, x_in, b, x_mid,
          bc);
    });
  });
}

// The up leg of a tiled non-factored grid level, tile by tile (its own
// tile, tf.up_x x tf.up_y): x = x_mid + the P-plane sum, the steps, x over
// each tile to x_out.
template <typename T, typename C, typename D>
__device__ void level_up_nf_tiles(const LevelDesc& L, const Transfer& tf,
                                  unsigned char* smem, unsigned smem_off,
                                  const T* x_mid, const T* xc, const T* b,
                                  T* x_out) {
  at_tile_shape(L, [&](auto s) {
    using S = decltype(s);
    for_level_tiles(L, tf.up_x, tf.up_y, [&](int ti, int tj) {
      tile_up_nf<T, S::K, S::NOFF, kLegWarps, kLegRows, kLegCols, C, D>(
          L, (const C*)tf.P, tf.sp, smem, smem_off, ti, tj, tf.up_x, tf.up_y,
          x_mid, xc, b, x_out);
    });
  });
}

// presmooth, residual and restriction of one level; x_in == nullptr is the
// zero start
template <typename T, typename C, typename D, typename Barrier>
__device__ void level_down(const LevelDesc& L, T* x, const T* x_in,
                           const T* b, T* r, T* g, T* bc, Span sp,
                           Barrier bar) {
  const C* A = (const C*)L.A;
  const D* dinv = (const D*)L.dinv;
  const C* Tp = (const C*)L.Tp;
  const C* S = (const C*)L.S;
  const int Wx = L.Wx, Wy = L.Wy;
  const T omega = (T)L.omega;
  for (int s = 0; s < L.n_steps; ++s) {
    const T* src = s == 0 ? x_in : (const T*)x;
    const int color = L.steps[s];
    for_cells(Wx, Wy, sp.first, sp.stride, [&](int i, int j) {
      step_cell(x, src, b, A, dinv, L.st, L.cg, color, omega, i, j, Wx, Wy,
                s == 0);
    });
    bar();
  }
  for_cells(Wx, Wy, sp.first, sp.stride, [&](int i, int j) {
    residual_cell(r, g, (const T*)x, b, A, S, L.st, i, j, Wx, Wy);
  });
  bar();
  for_cells(L.Wxc, L.Wyc, sp.first, sp.stride, [&](int I, int J) {
    restrict_cell(bc, (const T*)r, (const T*)g, A, Tp, L.st, I, J, Wx, Wy,
                  L.Wyc, L.k);
  });
  bar();
}

// correction from the coarse x, then postsmooth
template <typename T, typename C, typename D, typename Barrier>
__device__ void level_up(const LevelDesc& L, T* x, const T* b, const T* xc,
                         Span sp, Barrier bar) {
  const C* A = (const C*)L.A;
  const D* dinv = (const D*)L.dinv;
  const C* Tp = (const C*)L.Tp;
  const C* S = (const C*)L.S;
  const int Wx = L.Wx, Wy = L.Wy;
  const T omega = (T)L.omega;
  for_cells(Wx, Wy, sp.first, sp.stride, [&](int i, int j) {
    correct_cell(x, (const T*)x, xc, A, Tp, S, L.st, i, j, Wx, Wy, L.Wyc,
                 L.k);
  });
  bar();
  for (int s = 0; s < L.n_steps; ++s) {
    const int color = L.steps[s];
    for_cells(Wx, Wy, sp.first, sp.stride, [&](int i, int j) {
      step_cell(x, (const T*)x, b, A, dinv, L.st, L.cg, color, omega, i, j,
                Wx, Wy, false);
    });
    bar();
  }
}

// the color steps of one leg of a level; the first reads x_in (nullptr:
// the zero start) when first_in, else every step runs in place
template <typename T, typename C, typename D, typename Barrier>
__device__ void level_steps(const LevelDesc& L, T* x, const T* x_in,
                            const T* b, bool first_in, Span sp, Barrier bar) {
  const C* A = (const C*)L.A;
  const D* dinv = (const D*)L.dinv;
  const T omega = (T)L.omega;
  for (int s = 0; s < L.n_steps; ++s) {
    const bool first = first_in && s == 0;
    const T* src = first ? x_in : (const T*)x;
    const int color = L.steps[s];
    for_cells(L.Wx, L.Wy, sp.first, sp.stride, [&](int i, int j) {
      step_cell(x, src, b, A, dinv, L.st, L.cg, color, omega, i, j, L.Wx,
                L.Wy, first);
    });
    bar();
  }
}

// level_down on a non-factored level: presmooth, r = b - A x, then
// b_c = sum_q R_q r[k c + d_q] through the R planes (at T)
template <typename T, typename C, typename D, typename Barrier>
__device__ void level_down_nf(const LevelDesc& L, const Transfer& tf, T* x,
                              const T* x_in, const T* b, T* r, T* bc,
                              Span sp, Barrier bar) {
  const C* A = (const C*)L.A;
  const int Wx = L.Wx, Wy = L.Wy;
  level_steps<T, C, D>(L, x, x_in, b, true, sp, bar);
  for_cells(Wx, Wy, sp.first, sp.stride, [&](int i, int j) {
    r[(int64_t)i * Wy + j] =
        b[(int64_t)i * Wy + j] - stencil_at(A, (const T*)x, L.st, i, j, Wx, Wy);
  });
  bar();
  for_cells(L.Wxc, L.Wyc, sp.first, sp.stride, [&](int I, int J) {
    restrict_planes_cell(bc, (const T*)r, (const T*)tf.R, tf.sr, I, J, Wx, Wy,
                         L.Wxc, L.Wyc, L.k);
  });
  bar();
}

// level_up on a non-factored level: x += sum_q P_q x_c[i / k + d_q], then
// postsmooth
template <typename T, typename C, typename D, typename Barrier>
__device__ void level_up_nf(const LevelDesc& L, const Transfer& tf, T* x,
                            const T* b, const T* xc, Span sp, Barrier bar) {
  for_cells(L.Wx, L.Wy, sp.first, sp.stride, [&](int i, int j) {
    correct_planes_cell(x, (const T*)x, xc, (const C*)tf.P, tf.sp, i, j, L.Wx,
                        L.Wy, L.Wxc, L.Wyc, L.k);
  });
  bar();
  level_steps<T, C, D>(L, x, (const T*)x, b, false, sp, bar);
}

// One V-cycle over the n_lvl levels of sh (in shared memory): levels
// [0, n_grid) on the whole grid, levels [n_grid, n_lvl) and the coarse solve
// on block 0.  Level 0 reads x_in (nullptr: the zero start) and b_in and
// writes x_out.  A tiled level's tile buffers are at smem + smem_off.  Every
// thread of the grid reaches every grid.sync() (no early return); with
// final_barrier the call ends on a grid barrier after its last write.  NF:
// tf holds n_lvl Transfers (in shared memory), a level's non-factored
// planes and up tile where its R is set (the factored code unchanged where
// not).
template <typename T, typename C = T, typename D = C, bool NF = false>
__device__ void tail_cycle(const LevelDesc* sh, int n_lvl, int n_grid,
                           T* work, T* x_out, const T* x_in, const T* b_in,
                           const T* __restrict__ Mc, int n7, int64_t b7_off,
                           int64_t x7_off, unsigned char* smem,
                           unsigned smem_off, bool final_barrier,
                           const Transfer* tf = nullptr) {
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
    if constexpr (NF) {
      if (tf[l].R != nullptr) {
        level_down_nf<T, C, D>(sh[l], tf[l], X(l),
                               l == 0 ? x_in : (const T*)nullptr, B(l),
                               work + sh[l].r_off, BC(l), sp, bar);
        return;
      }
    }
    level_down<T, C, D>(sh[l], X(l), l == 0 ? x_in : (const T*)nullptr, B(l),
                  work + sh[l].r_off, work + sh[l].g_off, BC(l), sp, bar);
  };
  // the tiles of a grid level, spread over the blocks
  auto for_tiles = [&](const LevelDesc& L, auto f) {
    const int ty = tiles_of(L.Wy, L.tile_y);
    const int n = tiles_of(L.Wx, L.tile_x) * ty;
    for (int t = blockIdx.x; t < n; t += gridDim.x) f(t / ty, t % ty);
  };

  for (int l = 0; l < n_grid; ++l) {
    const LevelDesc& L = sh[l];
    if constexpr (NF) {
      if (tf[l].R != nullptr) {
        if (L.tile_x > 0) {
          level_down_nf_tiles<T, C, D>(L, tf[l], smem, smem_off,
                                       l == 0 ? x_in : (const T*)nullptr,
                                       B(l), work + L.m_off, BC(l));
          gbar();
        } else {
          down(l, gspan, gbar);
        }
        continue;
      }
    }
    if (L.tile_x > 0) {
      const T* xin = l == 0 ? x_in : (const T*)nullptr;
      for_tiles(L, [&](int ti, int tj) {
        tile_leg<T, C, D>(L, smem, smem_off, ti, tj, xin, (const T*)nullptr,
                          B(l), work + L.m_off, BC(l));
      });
      gbar();
    } else {
      down(l, gspan, gbar);
    }
  }
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
      if constexpr (NF) {
        if (tf[l].R != nullptr) {
          level_up_nf<T, C, D>(sh[l], tf[l], X(l), B(l), XC(l), bspan, bbar);
          continue;
        }
      }
      level_up<T, C, D>(sh[l], X(l), B(l), XC(l), bspan, bbar);
    }
  }
  gbar();
  for (int l = n_grid - 1; l >= 0; --l) {
    const LevelDesc& L = sh[l];
    if constexpr (NF) {
      if (tf[l].R != nullptr) {
        if (L.tile_x > 0) {
          level_up_nf_tiles<T, C, D>(L, tf[l], smem, smem_off,
                                     (const T*)(work + L.m_off), XC(l), B(l),
                                     X(l));
          if (l > 0 || final_barrier) gbar();
        } else {
          level_up_nf<T, C, D>(L, tf[l], X(l), B(l), XC(l), gspan, gbar);
        }
        continue;
      }
    }
    if (L.tile_x > 0) {
      for_tiles(L, [&](int ti, int tj) {
        tile_leg<T, C, D>(L, smem, smem_off, ti, tj, (const T*)(work + L.m_off),
                    XC(l), B(l), X(l), (T*)nullptr);
      });
      if (l > 0 || final_barrier) gbar();
    } else {
      level_up<T, C, D>(L, X(l), B(l), XC(l), gspan, gbar);
    }
  }
}

}  // namespace amg
