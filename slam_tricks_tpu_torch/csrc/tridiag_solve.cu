// SPD block-tridiagonal solve, for Hopper (sm_90a).
//
// Replaces: slam_tricks_tpu/ops/pallas_tridiag.py::_kernel (called by
// tridiag_solve). Same recursion, same numerics (unpivoted Gauss-Jordan
// inverses of the Schur complements):
//   forward   M_g = (D_g - E_{g-1} M_{g-1} E_{g-1}^T)^{-1}
//             u_g = M_g (r_g - E_{g-1} u_{g-1})
//   backward  x_{G-1} = u_{G-1};  x_g = u_g - M_g E_g^T x_{g+1}
// D (G, m, m) diagonal blocks, E (G-1, m, m) sub-diagonal blocks
// (E_g = S[g+1, g]), r (G, m), all row-major; x (G, m) out. M (G, m, m) is a
// scratch in device memory that the wrapper allocates (1.2 MB at G = 128,
// m = 48 in f32: it stays in the 50 MB L2).
//
// What bounds it on the H100: the dependency chain. Block g needs M_{g-1},
// so the forward sweep is G dependent steps, each an m x m inverse that is
// itself m dependent rank-1 steps, and the backward sweep is G - 1 more
// dependent steps. The bytes the function must move (D, E, r, x: 2.4 MB at
// (128, 48) f32, 0.71 us at 3.35 TB/s) and the operations an SPD solve needs
// (block Cholesky, ~7/3 m^3 a block: 35 MFLOP, 0.53 us at 67 TFLOP/s) are
// far below what the chain costs.
// What the design does about it: one block of 512 threads runs the whole
// solve, so each dependency is a barrier, not a kernel launch. The three
// m x m working tiles, rows padded to an odd stride so that a warp reading a
// column hits 32 banks:
//   X  E_{g-1}, then a Gauss-Jordan buffer;
//   Y  A_g = D_g - (E_{g-1} M_{g-1}) E_{g-1}^T, then M_g;
//   Z  E_{g-1} M_{g-1}, then the other Gauss-Jordan buffer;
// the inverse ping-pongs between two tiles, one barrier a pivot; thread
// (row0, col) owns column col of rows row0, row0 + 512/m, ..., so loads of D
// and E and stores of M are coalesced. The matrix-vector products run one
// warp a row with shuffle sums.
// Size limit: m <= 512 (a thread a column). The tiles, 3 m (m | 1) values,
// sit in shared memory up to m = 138 in f32 and m = 97 in f64; beyond, in a
// global scratch `work` that the wrapper allocates (0.9 MB at m = 192 in
// f64, L2-resident), with the same barriers, so m = 6 K for every band
// K <= 32 that the banded layout accepts goes through. The three vectors
// always sit in shared memory.
// Known costs, left for later: one SM works and 131 idle; each pivot step is
// a barrier; the next block's E and D are not prefetched.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 512;   // also the largest m
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullWarp = 0xffffffffu;

// row stride of a shared tile: odd, so the rows of a column fall in
// different banks
__host__ __device__ constexpr int tile_ld(int m) { return m | 1; }

template <typename T>
__device__ __forceinline__ T warp_sum(T s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(kFullWarp, s, off);
  return s;   // in lane 0
}

// sum_k A[i * lda + k] v[k], one warp; the total in lane 0
template <typename T>
__device__ __forceinline__ T row_dot(const T* A, int lda, int i, const T* v,
                                     int m, int lane) {
  T s = T(0);
  for (int k = lane; k < m; k += 32) s += A[i * lda + k] * v[k];
  return warp_sum(s);
}

// kSmemTiles: the tiles in shared memory, else in `work` (global)
template <typename T, bool kSmemTiles>
__global__ void __launch_bounds__(kThreads)
tridiag_solve_kernel(const T* __restrict__ D, const T* __restrict__ E,
                     const T* __restrict__ r, T* M, T* work, T* x, int G,
                     int m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = tile_ld(m);
  T* vec = reinterpret_cast<T*>(smem_raw);
  T* X = kSmemTiles ? vec : work;
  T* Y = X + m * ld;
  T* Z = Y + m * ld;
  if (kSmemTiles) vec = Z + m * ld;
  T* rhs = vec;          // (m) r_g - E_{g-1} u_{g-1}
  T* u = rhs + m;        // (m) u_{g-1}, then u_g; in the backward x_{g+1}
  T* t = u + m;          // (m) E_g^T x_{g+1}

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // this thread's elements of an m x m tile: (row0 + q * rstep, col)
  const int rstep = kThreads / m;
  const int col = tid % m;
  const int row0 = tid < rstep * m ? tid / m : m;
  const size_t mm = static_cast<size_t>(m) * m;

  // ---- forward sweep ----
  for (int g = 0; g < G; ++g) {
    const T* Dg = D + g * mm;
    const T* rg = r + static_cast<size_t>(g) * m;
    if (g == 0) {
      for (int i = row0; i < m; i += rstep) Y[i * ld + col] = Dg[i * m + col];
      for (int i = tid; i < m; i += kThreads) rhs[i] = rg[i];
      __syncthreads();
    } else {
      const T* Eg = E + (g - 1) * mm;
      for (int i = row0; i < m; i += rstep) X[i * ld + col] = Eg[i * m + col];
      __syncthreads();
      // Z = E_{g-1} M_{g-1};  rhs = r_g - E_{g-1} u_{g-1}
      for (int i = row0; i < m; i += rstep) {
        T s = T(0);
        for (int k = 0; k < m; ++k) s += X[i * ld + k] * Y[k * ld + col];
        Z[i * ld + col] = s;
      }
      for (int i = warp; i < m; i += kWarps) {
        const T s = row_dot(X, ld, i, u, m, lane);
        if (lane == 0) rhs[i] = rg[i] - s;
      }
      __syncthreads();
      // Y = D_g - Z E_{g-1}^T
      for (int i = row0; i < m; i += rstep) {
        T s = T(0);
        for (int k = 0; k < m; ++k) s += Z[i * ld + k] * X[col * ld + k];
        Y[i * ld + col] = Dg[i * m + col] - s;
      }
      __syncthreads();
    }

    // M_g = Y^{-1}: unpivoted Gauss-Jordan, in place up to the ping-pong
    T* src = Y;
    T* dst = Z;
    for (int k = 0; k < m; ++k) {
      const T inv_p = T(1) / src[k * ld + k];
      const T pk = src[k * ld + col] * inv_p;   // pivot row, scaled
      for (int i = row0; i < m; i += rstep) {
        const T aik = src[i * ld + k];
        T v;
        if (i == k) {
          v = col == k ? inv_p : pk;
        } else if (col == k) {
          v = -aik * inv_p;
        } else {
          v = src[i * ld + col] - aik * pk;
        }
        dst[i * ld + col] = v;
      }
      __syncthreads();
      T* tmp = src;
      src = dst;
      dst = tmp;
    }
    if (src != Y) {
      for (int i = row0; i < m; i += rstep) Y[i * ld + col] = src[i * ld + col];
      __syncthreads();
    }

    // u_g = M_g rhs; keep M_g for the backward sweep
    for (int i = warp; i < m; i += kWarps) {
      const T s = row_dot(Y, ld, i, rhs, m, lane);
      if (lane == 0) {
        u[i] = s;
        x[static_cast<size_t>(g) * m + i] = s;
      }
    }
    T* Mg = M + g * mm;
    for (int i = row0; i < m; i += rstep) Mg[i * m + col] = Y[i * ld + col];
    __syncthreads();
  }

  // ---- backward sweep: u holds x_{G-1} = u_{G-1} ----
  for (int g = G - 2; g >= 0; --g) {
    const T* Eg = E + g * mm;
    const T* Mg = M + g * mm;
    for (int i = row0; i < m; i += rstep) {
      X[i * ld + col] = Eg[i * m + col];
      Y[i * ld + col] = Mg[i * m + col];
    }
    __syncthreads();
    for (int j = tid; j < m; j += kThreads) {   // t = E_g^T x_{g+1}
      T s = T(0);
      for (int i = 0; i < m; ++i) s += X[i * ld + j] * u[i];
      t[j] = s;
    }
    __syncthreads();
    T* xg = x + static_cast<size_t>(g) * m;     // holds u_g
    for (int i = warp; i < m; i += kWarps) {
      const T s = row_dot(Y, ld, i, t, m, lane);
      if (lane == 0) {
        const T xi = xg[i] - s;
        xg[i] = xi;
        u[i] = xi;
      }
    }
    __syncthreads();
  }
}

template <typename T, bool kSmemTiles>
int launch_as(const void* D, const void* E, const void* r, void* M,
              void* work, void* x, int G, int m, void* stream) {
  const size_t tiles =
      kSmemTiles ? 3 * static_cast<size_t>(m) * tile_ld(m) : 0;
  const size_t smem = (tiles + 3 * static_cast<size_t>(m)) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      tridiag_solve_kernel<T, kSmemTiles>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  tridiag_solve_kernel<T, kSmemTiles><<<1, kThreads, smem,
                                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(D), static_cast<const T*>(E),
      static_cast<const T*>(r), static_cast<T*>(M), static_cast<T*>(work),
      static_cast<T*>(x), G, m);
  return static_cast<int>(cudaGetLastError());
}

// work == nullptr: the tiles in shared memory
template <typename T>
int launch(const void* D, const void* E, const void* r, void* M, void* work,
           void* x, int G, int m, void* stream) {
  if (m < 1 || m > kThreads) return static_cast<int>(cudaErrorInvalidValue);
  return work == nullptr
             ? launch_as<T, true>(D, E, r, M, work, x, G, m, stream)
             : launch_as<T, false>(D, E, r, M, work, x, G, m, stream);
}

}  // namespace

extern "C" int tridiag_solve_f32(const void* D, const void* E, const void* r,
                                 void* M, void* work, void* x, int G, int m,
                                 void* stream) {
  return launch<float>(D, E, r, M, work, x, G, m, stream);
}

extern "C" int tridiag_solve_f64(const void* D, const void* E, const void* r,
                                 void* M, void* work, void* x, int G, int m,
                                 void* stream) {
  return launch<double>(D, E, r, M, work, x, G, m, stream);
}
