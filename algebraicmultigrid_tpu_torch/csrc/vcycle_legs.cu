// Fused V-cycle legs on a Lat2D level (Hopper, sm_90a).
//
// Replaces the Pallas TPU kernels of the JAX package's
// ops/pallas/vcycle_kernels.py, factored-prolongator branch:
//   K1  _down_kernel via fused_down: multicolor GS/SOR presmooth over the
//       color-step list, r = b - A x, and the factored restriction
//       b_c = box_k-sum( T * (r - A (S * r)) ),   S = omega * Dtilde^-1;
//   K2  _up_kernel via fused_up: Tup = T * upsample_k(x_c),
//       x += Tup - S * (A Tup), then the postsmooth color steps.
//
// What bounds it on the card: bytes.  A leg streams the nA stencil planes
// plus dinv/T/S/b/x (about 11 planes of Wx*Wy words at a 9-point level) and
// does ~2 flops per byte read, far below the H100's ~20 flops/byte f32
// balance point, so every pass is memory-bound.
//
// Design.  The TPU kernel keeps a tile plus a halo in VMEM and runs every
// color step on it with halo over-compute; that shape exists because the TPU
// runs the grid in order on one core.  Here blocks run in parallel with no
// order, so each color step is one launch over the whole level: the
// periodic lattice coloring guarantees no two coupled cells share a color,
// so every cell of color c updates in place without races, and the launch
// boundary is the grid-wide barrier between steps.  Reads outside
// [0,Wx)x[0,Wy) are guarded to zero (the TPU relied on zero halos).  The
// first step of a leg reads x from the input and writes every cell of the
// output, so a leg never copies x separately and a zero start reads no x.
// The restriction writes T*(r - A g) per fine cell (coalesced, one thread
// a cell), then sums each (clipped) k x k box with one thread per coarse
// cell.  (Summing the boxes straight from the stencil, one thread per
// coarse cell, read every plane at stride k: 18% of a V-cycle's device time
// on an H100.)  Fusing the steps with shared-memory tiles and halos, and TMA, is
// later work: this version re-reads the stencil planes once per step.
//
// Every entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() for the wrapper to check.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kMaxOff = 32;
constexpr int kMaxColorCells = 64;
constexpr int kThreads = 256;

struct Stencil {
  int n;
  int dx[kMaxOff];
  int dy[kMaxOff];
};

struct ColorGrid {
  int a;
  int b;
  int tab[kMaxColorCells];
};

// sum_k A[k, i, j] * x[i + dx_k, j + dy_k], zero outside the grid
template <typename T>
__device__ __forceinline__ T stencil_at(const T* __restrict__ A, const T* x,
                                        const Stencil& st, int i, int j,
                                        int Wx, int Wy) {
  const int64_t plane = (int64_t)Wx * Wy;
  const int64_t c = (int64_t)i * Wy + j;
  T acc = T(0);
  for (int k = 0; k < st.n; ++k) {
    const int ii = i + st.dx[k];
    const int jj = j + st.dy[k];
    if (ii >= 0 && ii < Wx && jj >= 0 && jj < Wy) {
      acc += A[k * plane + c] * x[(int64_t)ii * Wy + jj];
    }
  }
  return acc;
}

// One color step: cells of color c take x + omega*dinv*(b - A x).
// full_write: read x from x_in (nullptr = the zero vector) and write every
// cell of x_out; otherwise x_in == x_out and only color-c cells are written
// (so the two x pointers may alias and carry no __restrict__).
template <typename T>
__global__ void color_step_kernel(T* x_out, const T* x_in,
                                  const T* __restrict__ b,
                                  const T* __restrict__ A,
                                  const T* __restrict__ dinv, Stencil st,
                                  ColorGrid cg, int color, T omega, int Wx,
                                  int Wy, int full_write) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= Wy) return;
  for (int i = blockIdx.y; i < Wx; i += gridDim.y) {
    const int64_t c = (int64_t)i * Wy + j;
    const bool mine = cg.tab[(i % cg.a) * cg.b + (j % cg.b)] == color;
    if (x_in == nullptr) {
      // zero start: b - A*0 = b
      x_out[c] = mine ? omega * dinv[c] * b[c] : T(0);
      continue;
    }
    if (mine) {
      const T r = b[c] - stencil_at(A, x_in, st, i, j, Wx, Wy);
      x_out[c] = x_in[c] + omega * dinv[c] * r;
    } else if (full_write) {
      x_out[c] = x_in[c];
    }
  }
}

// r = b - A x;  g = S * r
template <typename T>
__global__ void residual_scale_kernel(T* __restrict__ r, T* __restrict__ g,
                                      const T* __restrict__ x,
                                      const T* __restrict__ b,
                                      const T* __restrict__ A,
                                      const T* __restrict__ S, Stencil st,
                                      int Wx, int Wy) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= Wy) return;
  for (int i = blockIdx.y; i < Wx; i += gridDim.y) {
    const int64_t c = (int64_t)i * Wy + j;
    const T rc = b[c] - stencil_at(A, x, st, i, j, Wx, Wy);
    r[c] = rc;
    g[c] = S[c] * rc;
  }
}

// ts = T * (r - A g), written over r: a cell reads only its own r, and the
// stencil reads g, so the update is race-free
template <typename T>
__global__ void restrict_terms_kernel(T* __restrict__ r,
                                      const T* __restrict__ g,
                                      const T* __restrict__ A,
                                      const T* __restrict__ Tp, Stencil st,
                                      int Wx, int Wy) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= Wy) return;
  for (int i = blockIdx.y; i < Wx; i += gridDim.y) {
    const int64_t c = (int64_t)i * Wy + j;
    r[c] = Tp[c] * (r[c] - stencil_at(A, g, st, i, j, Wx, Wy));
  }
}

// b_c[I, J] = sum of ts over the fine k x k box, clipped at the edge
template <typename T>
__global__ void box_sum_kernel(T* __restrict__ bc, const T* __restrict__ ts,
                               int Wx, int Wy, int Wxc, int Wyc, int k) {
  const int J = blockIdx.x * blockDim.x + threadIdx.x;
  if (J >= Wyc) return;
  for (int I = blockIdx.y; I < Wxc; I += gridDim.y) {
    T acc = T(0);
    for (int dj = 0; dj < k && k * J + dj < Wy; ++dj) {
      T col = T(0);
      for (int di = 0; di < k && k * I + di < Wx; ++di) {
        col += ts[(int64_t)(k * I + di) * Wy + (k * J + dj)];
      }
      acc += col;
    }
    bc[(int64_t)I * Wyc + J] = acc;
  }
}

// Tup = T * x_c[i / k, j / k]
template <typename T>
__global__ void upsample_kernel(T* __restrict__ tup, const T* __restrict__ xc,
                                const T* __restrict__ Tp, int Wx, int Wy,
                                int Wyc, int k) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= Wy) return;
  for (int i = blockIdx.y; i < Wx; i += gridDim.y) {
    const int64_t c = (int64_t)i * Wy + j;
    tup[c] = Tp[c] * xc[(int64_t)(i / k) * Wyc + (j / k)];
  }
}

// x_out = x_in + (Tup - S * (A Tup))
template <typename T>
__global__ void correct_kernel(T* __restrict__ x_out,
                               const T* __restrict__ x_in,
                               const T* __restrict__ tup,
                               const T* __restrict__ A,
                               const T* __restrict__ S, Stencil st, int Wx,
                               int Wy) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= Wy) return;
  for (int i = blockIdx.y; i < Wx; i += gridDim.y) {
    const int64_t c = (int64_t)i * Wy + j;
    x_out[c] = x_in[c] + (tup[c] - S[c] * stencil_at(A, tup, st, i, j, Wx, Wy));
  }
}

dim3 grid_for(int rows, int cols) {
  const int gx = (cols + kThreads - 1) / kThreads;
  const int gy = rows < 65535 ? (rows > 0 ? rows : 1) : 65535;
  return dim3(gx, gy);
}

int make_stencil(Stencil* st, const int* offs, int n_off) {
  if (n_off < 0 || n_off > kMaxOff) return 1;
  st->n = n_off;
  for (int k = 0; k < n_off; ++k) {
    st->dx[k] = offs[2 * k];
    st->dy[k] = offs[2 * k + 1];
  }
  return 0;
}

int make_colors(ColorGrid* cg, const int* tab, int a, int b) {
  if (a < 1 || b < 1 || a * b > kMaxColorCells) return 1;
  cg->a = a;
  cg->b = b;
  for (int t = 0; t < a * b; ++t) cg->tab[t] = tab[t];
  return 0;
}

// the steps of one leg; the first reads x_in and writes all of x_out
template <typename T>
void run_steps(T* x_out, const T* x_in, const T* b, const T* A,
               const T* dinv, const Stencil& st, const ColorGrid& cg,
               const int* steps, int n_steps, T omega, int Wx, int Wy,
               cudaStream_t stream) {
  const dim3 grid = grid_for(Wx, Wy);
  for (int s = 0; s < n_steps; ++s) {
    const bool first = s == 0;
    color_step_kernel<T><<<grid, kThreads, 0, stream>>>(
        x_out, first ? x_in : x_out, b, A, dinv, st, cg, steps[s], omega, Wx,
        Wy, first ? 1 : 0);
  }
}

template <typename T>
int fused_down(T* x_out, const T* x_in, const T* b, const T* A,
               const T* dinv, const T* Tp, const T* S, T* r, T* g, T* bc,
               const int* offs, int n_off, const int* ctab, int ca, int cb,
               const int* steps, int n_steps, double omega, int Wx, int Wy,
               int Wxc, int Wyc, int k, void* stream_ptr) {
  Stencil st;
  ColorGrid cg;
  if (make_stencil(&st, offs, n_off) || make_colors(&cg, ctab, ca, cb) ||
      n_steps < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  run_steps<T>(x_out, x_in, b, A, dinv, st, cg, steps, n_steps, (T)omega, Wx,
               Wy, stream);
  residual_scale_kernel<T><<<grid_for(Wx, Wy), kThreads, 0, stream>>>(
      r, g, x_out, b, A, S, st, Wx, Wy);
  restrict_terms_kernel<T><<<grid_for(Wx, Wy), kThreads, 0, stream>>>(
      r, g, A, Tp, st, Wx, Wy);
  box_sum_kernel<T><<<grid_for(Wxc, Wyc), kThreads, 0, stream>>>(
      bc, r, Wx, Wy, Wxc, Wyc, k);
  return (int)cudaGetLastError();
}

template <typename T>
int fused_up(T* x_out, const T* x_in, const T* b, const T* A, const T* dinv,
             const T* Tp, const T* S, const T* xc, T* tup, const int* offs,
             int n_off, const int* ctab, int ca, int cb, const int* steps,
             int n_steps, double omega, int Wx, int Wy, int Wyc, int k,
             void* stream_ptr) {
  Stencil st;
  ColorGrid cg;
  if (make_stencil(&st, offs, n_off) || make_colors(&cg, ctab, ca, cb)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const dim3 grid = grid_for(Wx, Wy);
  upsample_kernel<T><<<grid, kThreads, 0, stream>>>(tup, xc, Tp, Wx, Wy, Wyc,
                                                    k);
  correct_kernel<T><<<grid, kThreads, 0, stream>>>(x_out, x_in, tup, A, S, st,
                                                   Wx, Wy);
  for (int s = 0; s < n_steps; ++s) {
    color_step_kernel<T><<<grid, kThreads, 0, stream>>>(
        x_out, x_out, b, A, dinv, st, cg, steps[s], (T)omega, Wx, Wy, 0);
  }
  return (int)cudaGetLastError();
}

}  // namespace

#define AMG_DEFINE_LEGS(SUFFIX, T)                                            \
  extern "C" int amg_fused_down_##SUFFIX(                                     \
      void* x_out, const void* x_in, const void* b, const void* A,            \
      const void* dinv, const void* Tp, const void* S, void* r, void* g,      \
      void* bc, const int* offs, int n_off, const int* ctab, int ca, int cb,  \
      const int* steps, int n_steps, double omega, int Wx, int Wy, int Wxc,   \
      int Wyc, int k, void* stream) {                                         \
    return fused_down<T>((T*)x_out, (const T*)x_in, (const T*)b,              \
                         (const T*)A, (const T*)dinv, (const T*)Tp,           \
                         (const T*)S, (T*)r, (T*)g, (T*)bc, offs, n_off,      \
                         ctab, ca, cb, steps, n_steps, omega, Wx, Wy, Wxc,    \
                         Wyc, k, stream);                                     \
  }                                                                           \
  extern "C" int amg_fused_up_##SUFFIX(                                       \
      void* x_out, const void* x_in, const void* b, const void* A,            \
      const void* dinv, const void* Tp, const void* S, const void* xc,        \
      void* tup, const int* offs, int n_off, const int* ctab, int ca, int cb, \
      const int* steps, int n_steps, double omega, int Wx, int Wy, int Wyc,   \
      int k, void* stream) {                                                  \
    return fused_up<T>((T*)x_out, (const T*)x_in, (const T*)b, (const T*)A,   \
                       (const T*)dinv, (const T*)Tp, (const T*)S,             \
                       (const T*)xc, (T*)tup, offs, n_off, ctab, ca, cb,      \
                       steps, n_steps, omega, Wx, Wy, Wyc, k, stream);        \
  }

AMG_DEFINE_LEGS(f32, float)
AMG_DEFINE_LEGS(f64, double)
