// K3 (the updown leg, vcycle_legs.cu) on a 5-point level with float32
// vectors, staged: one persistent block an SM walks the level's tiles, and
// the next tile's box lands in shared memory by TMA while the current tile
// runs.
//
// Why.  The tiled K3 (leg_reg_kernel, one 1024-thread block a tile) needs
// the whole register file of an SM for one block (64 registers a thread),
// so an SM runs one tile at a time and nothing of the next tile is in
// flight while it computes: at 4096^2 with bf16 planes it moved its bytes
// at under a third of the card's bandwidth (0.887 ms against a 0.145 ms
// bound).  Staging the next box with per-thread copies (the pipelined K2's
// cp.async) spends the registers and instructions the tile already has
// full.  The Tensor Memory Accelerator copies a whole box on one thread's
// request, computes the addresses, fills zeros outside the grid and counts
// the bytes on an mbarrier, so the 1024 threads spend nothing on it.
//
// Design.  The grid is min(tiles, SMs) blocks of the tiled K3's thread map
// (32 warps, 2 x 2 cells a thread, CellRegs).  Block b walks tiles b,
// b + grid, ...  A stage in shared memory holds a tile's box: the 5 A
// planes, dinv, S, b and x over the box and T over the box plus one reach
// (rows of kStageRow cells, each array one tensor copy; zero outside the
// grid), and x_c over the coarse cells under T's area (cp.async, an element
// a thread: a coarse row of Wyc float32 words need not be a multiple of 16
// bytes, which a tensor map's stride must be).  S and T, which the
// restriction reads again, take two slots, a tile's by its parity.  For
// each tile:
//   1. wait for its stage (the mbarrier's phase, then the block's cp.async);
//   2. tile_load from the stage: the coefficients into registers, Tup;
//   3. the correction, its x and S from the stage;
//   4. the stage is free but for the tile's S and T: thread 0 issues the
//      next tile's tensor copies (its S and T into the other slot), every
//      thread its x_c copies;
//   5. the color steps, the restriction (S and T from the tile's slot) and
//      the store (tile_run).
// The copies of tile t+1 fly under the steps and the restriction of tile
// t, most of K3's work, and no phase of a tile waits on device memory but
// the store.  The arithmetic, the summation order and every value read are
// the tiled K3's: the output is the same.  The planes are bf16: with
// float32 planes the two slots do not fit a block's shared memory beside
// the rest, and one slot measured slower than the tiles (1.05 against 0.90
// ms at 4096^2), so the wrapper's plan keeps such levels on the tiled K3.
// The block barrier at a tile's
// start stays: without it the compiler keeps more values live across
// tiles (on an H100 at 4096^2, x_c tracked by the mbarrier through
// cp.async.mbarrier.arrive.noinc took 0.97 ms with 136 bytes of spills, x_c
// by one tensor copy a coarse row 1.16 with 152, against 0.74 with 60).
//
// Maps.  The planes' maps (A as a [5, Wx, Wy] tensor, dinv, S, T) are
// encoded once for a leg cache (updown_plane_maps); b's and x's at each
// call; all are kernel parameters (__grid_constant__).  A map's global rows
// must be multiples of 16 bytes and its base 16-byte aligned: Wy * 2 and
// Wy * 4 for the bf16 planes and the float32 vectors; the wrapper's plan
// (plan_updown_staged) takes only such levels, whose box plus one reach
// fits the thread map and whose stage and tile buffers fit a block.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <cstring>
#include <mutex>

#include "leg_tile.cuh"

namespace amg {

// A tensor copy starts a row at a multiple of 16 bytes of the grid (an H100
// refuses other first coordinates with an illegal instruction), so a stage
// row starts at the box's first column rounded down to kStageSkew cells
// (16 bytes of bf16, 32 of float32) and holds kStageRow cells: the box's (at
// most kStageCells, the thread map's) and up to kStageSkew - 1 before them.
// A copy's destination is aligned to kStageAlign bytes.  The thread map is
// the tiled K3's.
constexpr int kStageCells = 64, kStageSkew = 8;
constexpr int kStageRow = kStageCells + kStageSkew;
constexpr unsigned kStageAlign = 128;
constexpr int kStageWarps = 32, kStageRows = 2, kStageCols = 2;

// byte offsets of a stage's arrays (each to 128 bytes, as a tensor copy's
// destination must be; S and T in two slots, a tile's by its parity), the
// bytes a tile's tensor copies deliver, and x_c's window (rows, row length)
struct UpdownStage {
  unsigned a, dinv, b, x, xc;
  unsigned s[2], t[2];
  unsigned tx;
  unsigned bytes;
  int xr, xw;  // x_c's window: rows, row length
};

__host__ __device__ inline unsigned align128(unsigned v) {
  return (v + 127u) & ~127u;
}

// The stage of an E0 x E1 box: planes of coef_size bytes, vectors of
// vec_size bytes.
__host__ __device__ inline UpdownStage updown_stage(int E0, int E1, int reach,
                                                    int k, int coef_size,
                                                    int vec_size) {
  const int U0 = E0 + 2 * reach, U1 = E1 + 2 * reach;
  const unsigned plane = (unsigned)(E0 * kStageRow * coef_size);
  const unsigned tarea = (unsigned)(U0 * kStageRow * coef_size);
  const unsigned vec = (unsigned)(E0 * kStageRow * vec_size);
  UpdownStage sg;
  sg.xr = (U0 - 1) / k + 2;
  sg.xw = (U1 - 1) / k + 2;
  sg.a = 0;
  sg.dinv = align128(sg.a + 5 * plane);
  sg.b = align128(sg.dinv + plane);
  sg.x = align128(sg.b + vec);
  sg.xc = align128(sg.x + vec);
  sg.s[0] = align128(sg.xc + (unsigned)(sg.xr * sg.xw * vec_size));
  sg.t[0] = align128(sg.s[0] + plane);
  sg.s[1] = align128(sg.t[0] + tarea);
  sg.t[1] = align128(sg.s[1] + plane);
  sg.bytes = align128(sg.t[1] + tarea);
  sg.tx = 7 * plane + tarea + 2 * vec;
  return sg;
}

// The maps of one launch: the planes' (encoded once) and the vectors'.
struct alignas(64) UpdownMaps {
  CUtensorMap a, dinv, s, t;  // the order of updown_plane_maps
  CUtensorMap b, x;
};

// ---- the device side ------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// a box of a rank-2 (c0 along a row, c1 the row) or rank-3 map
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

template <typename T>
__device__ __forceinline__ void cp_async_word(T* dst, const T* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "n"((int)sizeof(T)));
}

// A tile's inputs from its stage (the interface of DeviceIn): every box
// array in rows of kStageRow cells from the box's skew sb (T's area from
// st), zero outside the grid (the copies' fill)
template <typename T, typename C, int K>
struct StagedUpdown {
  using Coef = C;
  const C* ap;    // A, 5 planes of n cells
  const C* dp;    // dinv
  const C* sp;    // S
  const C* tp;    // T over the box plus one reach
  const T* bp;
  const T* xp;
  const T* xcs;   // x_c over its window
  const T* xc;    // x_c in device memory (box_tup's; the plan never takes it)
  int n, sb, st, Wx, Wy, r, ox, oy, cr0, cc0, xw;

  __device__ int index(int e0, int e1, int) const {
    return e0 * kStageRow + sb + e1;
  }
  __device__ T a(int q, int e, bool, int64_t) const {
    return coef<T>(ap, q * n + e);
  }
  __device__ T d(int e, bool, int64_t) const { return coef<T>(dp, e); }
  __device__ T rhs(int e, bool, int64_t) const { return bp[e]; }
  __device__ T xv(int e, bool, int64_t) const { return xp[e]; }
  __device__ T s(int e, bool, int64_t) const { return coef<T>(sp, e); }
  __device__ T t(int, bool, int64_t) const { return T(0); }
  __device__ T tup(int u0, int u1) const {
    const int i = ox - r + u0, j = oy - r + u1;
    return inside(i, j, Wx, Wy)
               ? coef<T>(tp, u0 * kStageRow + st + u1) *
                     xcs[(i / K - cr0) * xw + (j / K - cc0)]
               : T(0);
  }
};

template <typename T, typename C, int K>
__device__ __forceinline__ StagedUpdown<T, C, K> staged_updown(
    const LevelDesc& L, const Box& bx, const UpdownStage& sg,
    unsigned char* base, int slot, const T* xc) {
  return StagedUpdown<T, C, K>{
      reinterpret_cast<const C*>(base + sg.a),
      reinterpret_cast<const C*>(base + sg.dinv),
      reinterpret_cast<const C*>(base + sg.s[slot]),
      reinterpret_cast<const C*>(base + sg.t[slot]),
      reinterpret_cast<const T*>(base + sg.b),
      reinterpret_cast<const T*>(base + sg.x),
      reinterpret_cast<const T*>(base + sg.xc),
      xc,
      bx.E0 * kStageRow,
      bx.oy & (kStageSkew - 1),
      (bx.oy - L.reach) & (kStageSkew - 1),
      L.Wx,
      L.Wy,
      L.reach,
      bx.ox,
      bx.oy,
      floor_div<K>(bx.ox - L.reach),
      floor_div<K>(bx.oy - L.reach),
      sg.xw};
}

// The restriction's S and T from the tile's slot (the interface tile_run
// reads without EARLY: a box cell by its flat index e = e0 E1 + e1; e0 by a
// float product, exact for e < 2^12 and E1 <= 64, where no division is
// cheap; x is not read there): s and t point at the slot's first cells, the
// skew and, for T, the reach folded in.
template <typename T, typename C>
struct SlotIn {
  const C* s_;
  const C* t_;
  int E1;
  float inv;  // 1 / E1

  __device__ int row(int e) const {
    return __float2int_rz(((float)e + 0.5f) * inv);
  }
  __device__ T xv(int, bool, int64_t) const { return T(0); }
  __device__ T s(int e, bool, int64_t) const {
    const int e0 = row(e);
    return coef<T>(s_, e0 * kStageRow + (e - e0 * E1));
  }
  __device__ T t(int e, bool, int64_t) const {
    const int e0 = row(e);
    return coef<T>(t_, e0 * kStageRow + (e - e0 * E1));
  }
};

// The restriction's source of a tile: its slot's S and T from their first
// cells, the skew and, for T, the reach folded in
template <typename T, typename C>
__device__ __forceinline__ SlotIn<T, C> slot_in(const Box& bx,
                                                const UpdownStage& sg,
                                                unsigned char* base, int slot,
                                                int r) {
  const C* s = reinterpret_cast<const C*>(base + sg.s[slot]);
  const C* t = reinterpret_cast<const C*>(base + sg.t[slot]);
  return SlotIn<T, C>{s + (bx.oy & (kStageSkew - 1)),
                      t + (r * kStageRow + ((bx.oy - r) & (kStageSkew - 1)) +
                           r),
                      bx.E1, 1.0f / (float)bx.E1};
}

// Issue a tile's stage (its S and T into `slot`): thread 0 its tensor
// copies (after the block's reads of the stage, which the caller's barrier
// ends), every thread the cp.async of x_c's cells in the coarse grid (the
// caller commits the group).
template <typename T, int K>
__device__ __forceinline__ void issue_stage(const LevelDesc& L, const Box& bx,
                                            const UpdownStage& sg,
                                            const UpdownMaps& M,
                                            unsigned char* base, int slot,
                                            unsigned bar, const T* xc) {
  const int r = L.reach;
  if (threadIdx.x == 0) {
    // the rows from the box's (T's area's) first column, skewed
    const int j0 = bx.oy & ~(kStageSkew - 1);
    const int jt = (bx.oy - r) & ~(kStageSkew - 1);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect_tx(bar, sg.tx);
    tma_load_3d(base + sg.a, &M.a, j0, bx.ox, 0, bar);
    tma_load_2d(base + sg.dinv, &M.dinv, j0, bx.ox, bar);
    tma_load_2d(base + sg.s[slot], &M.s, j0, bx.ox, bar);
    tma_load_2d(base + sg.t[slot], &M.t, jt, bx.ox - r, bar);
    tma_load_2d(base + sg.b, &M.b, j0, bx.ox, bar);
    tma_load_2d(base + sg.x, &M.x, j0, bx.ox, bar);
  }
  T* xcs = reinterpret_cast<T*>(base + sg.xc);
  const int cr0 = floor_div<K>(bx.ox - r), cc0 = floor_div<K>(bx.oy - r);
  for (int v = threadIdx.x; v < sg.xr * sg.xw; v += blockDim.x) {
    const int v0 = v / sg.xw, v1 = v - v0 * sg.xw;
    const int I = cr0 + v0, J = cc0 + v1;
    if (I >= 0 && I < L.Wxc && J >= 0 && J < L.Wyc) {
      cp_async_word(xcs + v, xc + (int64_t)I * L.Wyc + J);
    }
  }
}

// The correction x = x_in + (Tup - S (A Tup)) over the box, x and S from
// the stage: tile_run's correction (the same terms in the same order).
// Ends on a block barrier.
template <typename T, int NOFF, int WARPS, int CI, int CJ, class Src>
__device__ __forceinline__ void staged_correct(
    const LevelDesc& L, const TileSmem<T>& sm, const Box& bx, const Src& src,
    const CellRegs<T, NOFF, CI, CJ>& R) {
  const int r = L.reach, E0 = bx.E0, E1 = bx.E1, U1 = E1 + 2 * r;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int su[NOFF];
#pragma unroll
  for (int q = 0; q < NOFF; ++q) su[q] = L.st.dx[q] * U1 + L.st.dy[q];
#pragma unroll
  for (int a = 0; a < CI; ++a) {
#pragma unroll
    for (int c = 0; c < CJ; ++c) {
      const int e0 = w + WARPS * a, e1 = lane + 32 * c;
      if (e0 >= E0 || e1 >= E1) continue;
      const int e = e0 * E1 + e1;
      T v = T(0);
      if (sm.cs[e] != kOutside) {
        const int u = (e0 + r) * U1 + (e1 + r);
        const int es = src.index(e0, e1, e);
        T acc = T(0);
#pragma unroll
        for (int q = 0; q < NOFF; ++q) acc += R.a[a][c][q] * sm.sc[u + su[q]];
        v = src.xv(es, true, 0) + (sm.sc[u] - src.s(es, true, 0) * acc);
      }
      sm.xs[e] = v;
    }
  }
  __syncthreads();
}

// The maps are the first parameter, at the parameters' aligned start (a
// tensor map must lie 64-byte aligned).
template <typename T, typename C, int K>
__global__ void __launch_bounds__(kStageWarps * 32, 1)
    updown_stage_kernel(const __grid_constant__ UpdownMaps M,
                        const __grid_constant__ LevelDesc L, T* x_out,
                        const T* x_in, const T* b, const T* xc, T* bc) {
  // the stage and the tile buffers, from the first 128-byte boundary of
  // the dynamic shared memory (which follows the static, at 16 bytes)
  extern __shared__ __align__(16) unsigned char stage_raw[];
  unsigned char* stage_smem =
      stage_raw + ((kStageAlign - smem_addr(stage_raw)) & (kStageAlign - 1));
  // the descriptor and the stage's layout in shared memory, read where
  // used: the tile's registers are full
  __shared__ LevelDesc sh;
  __shared__ UpdownStage sg;
  __shared__ struct { int nt, ntj, h; } wk;  // tiles, tiles a row, halo
  __shared__ __align__(8) uint64_t full;
  {
    const int* src = reinterpret_cast<const int*>(&L);
    int* dst = reinterpret_cast<int*>(&sh);
    for (int w = threadIdx.x; w < (int)(sizeof(LevelDesc) / sizeof(int));
         w += blockDim.x) {
      dst[w] = src[w];
    }
  }
  __syncthreads();
  const unsigned bar = smem_addr(&full);
  if (threadIdx.x == 0) {
    const int r = sh.reach, h = leg_halo(sh.n_steps, r, true);
    const int E0 = sh.tile_x + 2 * h, E1 = sh.tile_y + 2 * h;
    if (E0 + 2 * r > kStageCells || E1 + 2 * r > kStageCells || sh.st.n != 5 ||
        blockDim.x != kStageWarps * 32) {
      __trap();
    }
    sg = updown_stage(E0, E1, r, K, (int)sizeof(C), (int)sizeof(T));
    wk.ntj = tiles_of(sh.Wy, sh.tile_y);
    wk.nt = tiles_of(sh.Wx, sh.tile_x) * wk.ntj;
    wk.h = h;
    mbar_init(bar, 1);
  }
  __syncthreads();
  // the walk's state from shared memory where used: the steps need every
  // register
  auto box_of = [&](int t) {
    return make_box(t / wk.ntj, t % wk.ntj, sh.tile_x, sh.tile_y, wk.h);
  };
  if ((int)blockIdx.x < wk.nt) {
    issue_stage<T, K>(sh, box_of(blockIdx.x), sg, M, stage_smem, 0, bar, xc);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  unsigned parity = 0;  // the mbarrier's phase and the tile's slot
  for (int t = blockIdx.x; t < wk.nt; t += gridDim.x, parity ^= 1u) {
    mbar_wait(bar, parity);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    const Box bx = box_of(t);
    const int r = sh.reach;
    const TileSmem<T> sm = tile_buffers<T>(stage_smem, sg.bytes, bx, r);
    const StagedUpdown<T, C, K> src =
        staged_updown<T, C, K>(sh, bx, sg, stage_smem, parity, xc);
    CellRegs<T, 5, kStageRows, kStageCols> R;
    tile_load<T, K, 5, kStageWarps, kStageRows, kStageCols, false>(
        sh, sm, bx, src, true, true, R);
    staged_correct<T, 5, kStageWarps, kStageRows, kStageCols>(sh, sm, bx, src,
                                                              R);
    // the stage is free but for this tile's S and T: the next tile's box
    // lands (its S and T in the other slot) while this one works
    if (t + (int)gridDim.x < wk.nt) {
      issue_stage<T, K>(sh, box_of(t + gridDim.x), sg, M, stage_smem,
                        parity ^ 1u, bar, xc);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    tile_run<T, 5, kStageWarps, kStageRows, kStageCols, false>(
        sh, sm, bx, slot_in<T, C>(bx, sg, stage_smem, parity, r), R, false,
        x_out, bc);
  }
}

// ---- the host side ----------------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, looked up through the runtime (no link
// flag)
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// The map of `planes` row-major [Wx, Wy] planes of itemsize bytes (2: bf16,
// 4: float32) at base, one box kStageRow cells x rows (x planes), its first
// column a multiple of kStageSkew; zero outside.  Returns a CUDA error code.
inline int encode_box_map(CUtensorMap* m, const void* base, int itemsize,
                          int Wx, int Wy, int planes, int rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0 ||
      ((int64_t)Wy * itemsize) % 16 != 0 || (itemsize != 2 && itemsize != 4) ||
      rows < 1 || rows > 256 || planes < 1 || planes > 256) {
    return (int)cudaErrorInvalidValue;
  }
  const cuuint64_t dims[3] = {(cuuint64_t)Wy, (cuuint64_t)Wx,
                              (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)Wy * itemsize,
                                 (cuuint64_t)Wx * Wy * itemsize};
  const cuuint32_t box[3] = {(cuuint32_t)kStageRow, (cuuint32_t)rows,
                             (cuuint32_t)planes};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult rc =
      fn(m,
         itemsize == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
         planes > 1 ? 3 : 2, const_cast<void*>(base), dims, strides, box,
         step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The bf16 planes' maps of a staged level, in UpdownMaps's order (A, dinv,
// S over E0 rows; T over E0 + 2 reach), into out (4 CUtensorMaps).
inline int updown_plane_maps(void* out, const void* A, const void* dinv,
                             const void* Tp, const void* S, int Wx, int Wy,
                             int E0, int reach) {
  CUtensorMap m[4];
  int err = encode_box_map(&m[0], A, 2, Wx, Wy, 5, E0);
  if (!err) err = encode_box_map(&m[1], dinv, 2, Wx, Wy, 1, E0);
  if (!err) err = encode_box_map(&m[2], S, 2, Wx, Wy, 1, E0);
  if (!err) err = encode_box_map(&m[3], Tp, 2, Wx, Wy, 1, E0 + 2 * reach);
  if (!err) std::memcpy(out, m, sizeof(m));
  return err;
}

constexpr int kMaxDevices = 64;

// The SM count of the current device, looked up once a device.  Returns a
// CUDA error code.
inline int stage_sms(int* sms) {
  static std::atomic<int> known[kMaxDevices];  // 0: not looked up yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  int n = known[dev].load(std::memory_order_relaxed);
  if (n == 0) {
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    known[dev].store(n, std::memory_order_relaxed);
  }
  *sms = n;
  return 0;
}

// updown_stage_kernel<T, C, K>'s dynamic shared memory opened to at least
// smem bytes on the current device, set on the first launch that needs more
// than the last.  Returns a CUDA error code.
template <typename T, typename C, int K>
int open_stage_smem(size_t smem) {
  static std::mutex mu;
  static size_t opened[kMaxDevices];  // this kernel's, by device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (opened[dev] >= smem) return 0;
  err = cudaFuncSetAttribute(updown_stage_kernel<T, C, K>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  opened[dev] = smem;
  return 0;
}

// K3 staged on a tiled 5-point level (L.tile_x > 0): the planes' maps from
// updown_plane_maps, b's and x_in's encoded here.  Returns a CUDA error
// code.
template <typename T, typename C>
int run_updown_staged(const LevelDesc& L, const void* plane_maps,
                      cudaStream_t stream, T* x_out, const T* x_in,
                      const T* b, const T* xc, T* bc) {
  const int h = leg_halo(L.n_steps, L.reach, true);
  const int E0 = L.tile_x + 2 * h, E1 = L.tile_y + 2 * h;
  if (L.st.n != 5 || L.tile_x < 1 || E0 + 2 * L.reach > kStageCells ||
      E1 + 2 * L.reach > kStageCells || plane_maps == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  UpdownMaps M;
  std::memcpy(&M, plane_maps, 4 * sizeof(CUtensorMap));
  int err = encode_box_map(&M.b, b, (int)sizeof(T), L.Wx, L.Wy, 1, E0);
  if (!err) {
    err = encode_box_map(&M.x, x_in, (int)sizeof(T), L.Wx, L.Wy, 1, E0);
  }
  if (err) return err;
  int sms = 0;
  err = stage_sms(&sms);
  if (err) return err;
  const int nt = tiles_of(L.Wx, L.tile_x) * tiles_of(L.Wy, L.tile_y);
  const size_t smem =
      kStageAlign +
      updown_stage(E0, E1, L.reach, L.k, (int)sizeof(C), (int)sizeof(T))
          .bytes +
      tile_smem_bytes(L.tile_x, L.tile_y, h, L.reach, (int)sizeof(T));
  err = L.k == 2 ? open_stage_smem<T, C, 2>(smem)
                 : open_stage_smem<T, C, 3>(smem);
  if (err) return err;
  auto fn = L.k == 2 ? updown_stage_kernel<T, C, 2>
                     : updown_stage_kernel<T, C, 3>;
  fn<<<nt < sms ? nt : sms, kStageWarps * 32, smem, stream>>>(
      M, L, x_out, x_in, b, xc, bc);
  return (int)cudaGetLastError();
}

}  // namespace amg
