// Dense SPD solve S x = b (the reduced camera system), for Hopper (sm_90a),
// at n < BLOCKED_MIN_N = 1536 (ops/spd_solve.py); spd_solve_blocked.cu
// takes larger n, where this design starves the trailing updates.
//
// Replaces: slam_tricks_tpu/ops/pallas_chol.py::_kernel (called by
// chol_solve_padded / chol_solve): upper Cholesky S = U^T U, read from the
// upper triangle of S, each pivot row scaled by 1 / sqrt(d); then
// U^T z = b and U x = z. Unlike the Pallas kernel, which clamps pivots at
// 1e-30, a pivot d <= 0 or not finite gives NaN (dense_tile.cuh's
// nan_pivot_scale), as the plain version, the JAX package's default XLA
// Cholesky and tridiag_solve.cu do: the NaN reaches every later pivot and
// so all of x, and the solver's bad-step branch takes a zero step. The
// NaN changes no control flow, so every block still reaches every grid
// barrier. n needs no padding.
//
// What bounds it on the H100: the dependency chain, not the 64 MFLOP of
// n = 576 (0.96 us at 67 TFLOP/s) nor the 1.3 MB of S (0.4 us at
// 3.35 TB/s). Tile row k of U needs every earlier tile row.
// What the design does about it: one cooperative launch of a persistent
// grid, at most one block an SM (co-residency checked before the launch),
// so each dependency is a grid barrier (cooperative_groups grid sync), not
// a kernel launch, and the independent work of a step spreads over the SMs.
// S is cut into 32 x 32 tiles (a lane a column; the last tile may be
// ragged, padded with the identity in shared memory); the factor works in
// place on A, a device-memory copy of S that stays in the 50 MB L2,
// followed by Ud, the nt transposed inverses U_kk^-T. Right-looking with a
// lookahead, one grid barrier a step s of nt = ceil(n / 32):
//   - one block per tile (s, j), j >= s (the panel): it loads A_ss, A_sj
//     and y_s, applies the update of tile row s-1 to its tiles itself
//     (A_ss -= U^T U of row s-1's (s-1, s) tile, A_sj likewise), and
//     factors in shared memory: warp 0 factors the diagonal tile in
//     registers, lane c holding column c, with shuffles and no block
//     barrier; then a lane a column solves U_ss^T [A_sj | y_s] in
//     registers. Each panel block re-factors A_ss itself, which saves a
//     barrier. The block of j = s writes z_s = U_ss^-T y_s and U_ss^-1
//     (one warp, a lane a column); the block of j > s writes
//     U_sj = U_ss^-T A_sj and updates y_j -= U_sj^T z_s (j has one owner);
//   - the other blocks, at the same time, apply row s-1's update to the
//     upper tiles (i, j), s < i <= j: A_ij -= U_{s-1,i}^T U_{s-1,j}, one
//     tile a block a round, both factor tiles staged in shared memory, a
//     16 x 16 thread grid with 2 x 2 sums a thread in registers;
//   - grid barrier.
// Backward substitution U x = z by tiles from the last, with no grid
// barrier: each tile row's block applies z_i -= U_ik x_k as each x_k is
// flagged (U_ik fetched before the wait), then x_i = U_ii^-1 z_i (a 32 x 32
// product, no serial chain), and flags x_i: a chain of nt flag hand-offs.
// At n = 576: 18 steps, a grid of min(#SMs, 17 + 16 * 17 / 2) = 132
// blocks of 256 threads, 19 grid barriers.
// Size limit: element offsets are 32-bit ints, so n * n < 2^31: n <= 46340.
// Shared memory does not bound n.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "dense_tile.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kTile = 32;               // a lane a column
constexpr int kTT = kTile * kTile;
constexpr int kThreads = 256;           // a 16 x 16 grid in the products
constexpr int kLd = 2 * kTile + 1;      // [A_ss | A_sj | y_s], odd stride

// shared memory, in values: the panel, two factor tiles, two vectors
constexpr size_t kSmemValues = static_cast<size_t>(kTile) * kLd + 2 * kTT + 2 * kTile;

// (i, j) of the t-th upper tile of an m x m tile triangle, row by row
__device__ __forceinline__ void upper_tile(int t, int m, int* i, int* j) {
  int row = 0;
  while (t >= m - row) {
    t -= m - row;
    ++row;
  }
  *i = row;
  *j = row + t;
}

// the largest number of tasks (panel + trailing) of any step
__host__ int max_tasks(int nt) {
  int most = 1;
  for (int s = 0; s < nt; ++s) {
    const int m = nt - s - 1;
    const int tasks = (nt - s) + (s > 0 ? m * (m + 1) / 2 : 0);
    most = tasks > most ? tasks : most;
  }
  return most;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
spd_solve_kernel(const T* __restrict__ S, const T* __restrict__ b, T* A,
                 T* yz, T* x, int* flags, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* P = reinterpret_cast<T*>(smem_raw);   // (kTile, kLd) [A_ss | A_sj | y]
  T* Ua = P + kTile * kLd;                  // (kTile, kTile) factor tiles
  T* Ub = Ua + kTT;
  T* sc = Ub + kTT;                         // (kTile) pivot scales 1 / U_pp
  T* vec = sc + kTile;                      // (kTile) a vector
  T* Ud = A + static_cast<size_t>(n) * n;   // (nt, kTile, kTile) U_kk^-T
  T* y = yz;        // (n) right-hand side, updated tile row by tile row
  T* z = yz + n;    // (n) U^-T b
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;
  const int nb_grid = gridDim.x;
  const int nt = (n + kTile - 1) / kTile;
  auto rows = [&](int k) { return min(kTile, n - k * kTile); };
  // U_{k, c0 + c} for p < 32, c < cols into a tile of shared memory, 0 past
  auto load_u = [&](T* dst, int k, int c0, int cols) {
    for (int idx = tid; idx < kTT; idx += kThreads) {
      const int p = idx / kTile, c = idx - p * kTile;
      dst[idx] = c < cols ? A[(k * kTile + p) * n + c0 + c] : T(0);
    }
  };

  {
    const size_t nn = static_cast<size_t>(n) * n;
    const size_t stride = static_cast<size_t>(nb_grid) * kThreads;
    for (size_t i = blockIdx.x * kThreads + tid; i < nn; i += stride) A[i] = S[i];
    for (int i = blockIdx.x * kThreads + tid; i < n; i += nb_grid * kThreads) {
      y[i] = b[i];
    }
    for (int i = blockIdx.x * kThreads + tid; i < nt; i += nb_grid * kThreads) {
      flags[i] = 0;
    }
  }
  grid.sync();

  for (int s = 0; s < nt; ++s) {
    const int o = s * kTile;
    const int tb = rows(s);
    const int npanel = nt - s;
    // ---- the panel (s, j), j >= s ----
    for (int j = s + blockIdx.x; j < nt; j += nb_grid) {
      const int oj = j * kTile;
      const int tc = j > s ? rows(j) : 0;   // panel columns
      for (int idx = tid; idx < kTT; idx += kThreads) {
        const int r = idx / kTile, c = idx - r * kTile;
        const bool live = r < tb;
        P[r * kLd + c] = live && c < tb ? A[(o + r) * n + o + c]
                                        : T(r == c ? 1 : 0);
        P[r * kLd + kTile + c] = live && c < tc ? A[(o + r) * n + oj + c] : T(0);
      }
      for (int r = tid; r < kTile; r += kThreads) {
        P[r * kLd + 2 * kTile] = r < tb ? y[o + r] : T(0);
      }
      if (s > 0) {   // row s-1's update of this block's tiles
        load_u(Ua, s - 1, o, tb);
        load_u(Ub, s - 1, oj, tc);
        __syncthreads();
        T acc[2][4];
#pragma unroll
        for (int a = 0; a < 2; ++a) {
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[a][q] = T(0);
        }
#pragma unroll 8
        for (int p = 0; p < kTile; ++p) {
          const T u0 = Ua[p * kTile + ty], u1 = Ua[p * kTile + ty + 16];
          T v[4];
          v[0] = Ua[p * kTile + tx];
          v[1] = Ua[p * kTile + tx + 16];
          v[2] = Ub[p * kTile + tx];
          v[3] = Ub[p * kTile + tx + 16];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            acc[0][q] += u0 * v[q];
            acc[1][q] += u1 * v[q];
          }
        }
#pragma unroll
        for (int a = 0; a < 2; ++a) {
#pragma unroll
          for (int q = 0; q < 4; ++q) P[(ty + 16 * a) * kLd + tx + 16 * q] -= acc[a][q];
        }
      }
      __syncthreads();
      // the diagonal tile: warp 0, in registers, no block barrier
      if (warp == 0) {
        T a[kTile];
#pragma unroll
        for (int r = 0; r < kTile; ++r) a[r] = P[r * kLd + lane];
#pragma unroll
        for (int p = 0; p < kTile; ++p) {
          const T d = __shfl_sync(0xffffffffu, a[p], p);
          const T sp = dense_tile::nan_pivot_scale(d);
          const T u = a[p] * sp;   // U[p, lane]; U_pp = d s_p
          a[p] = u;
          if (lane == p) sc[p] = sp;
#pragma unroll
          for (int r = p + 1; r < kTile; ++r) a[r] -= __shfl_sync(0xffffffffu, u, r) * u;
        }
#pragma unroll
        for (int r = 0; r < kTile; ++r) P[r * kLd + lane] = a[r];
      }
      __syncthreads();
      // U_ss^-T [A_sj | y_s]: warps 0 and 1, a lane a column
      if (warp < 2) {
        const int col = kTile + 32 * warp + lane;
        const bool live = col < kLd && (warp == 1 || j > s);
        T v[kTile];
#pragma unroll
        for (int r = 0; r < kTile; ++r) v[r] = live ? P[r * kLd + col] : T(0);
#pragma unroll
        for (int p = 0; p < kTile; ++p) {
          const T u = v[p] * sc[p];
          v[p] = u;
#pragma unroll
          for (int r = p + 1; r < kTile; ++r) v[r] -= P[p * kLd + r] * u;
        }
        if (live) {
#pragma unroll
          for (int r = 0; r < kTile; ++r) P[r * kLd + col] = v[r];
        }
      } else if (warp == 2 && j == s) {
        // column lane of U_ss^-1 by backward substitution, stored as row
        // lane of Ud's tile (U_ss^-T)
        T e[kTile];
#pragma unroll
        for (int r = 0; r < kTile; ++r) e[r] = T(r == lane ? 1 : 0);
#pragma unroll
        for (int p = kTile - 1; p >= 0; --p) {
          const T xp = e[p] * sc[p];   // 1 / U_pp = 1 / sqrt(d_p) = s_p
          e[p] = xp;
#pragma unroll
          for (int r = 0; r < p; ++r) e[r] -= P[r * kLd + p] * xp;
        }
        T* ud = Ud + s * kTT + lane * kTile;
#pragma unroll
        for (int r = 0; r < kTile; ++r) ud[r] = e[r];
      }
      __syncthreads();
      if (j == s) {
        for (int r = tid; r < tb; r += kThreads) z[o + r] = P[r * kLd + 2 * kTile];
      } else {
        for (int idx = tid; idx < tb * kTile; idx += kThreads) {
          const int r = idx / kTile, c = idx - r * kTile;
          if (c < tc) A[(o + r) * n + oj + c] = P[r * kLd + kTile + c];
        }
        if (tid < tc) {   // y_j -= U_sj^T z_s
          T acc = T(0);
#pragma unroll 8
          for (int r = 0; r < kTile; ++r) {
            acc += P[r * kLd + kTile + tid] * P[r * kLd + 2 * kTile];
          }
          y[oj + tid] -= acc;
        }
      }
      __syncthreads();
    }

    // ---- meanwhile: row s-1's update of the tiles (i, j), s < i <= j ----
    const int m = nt - s - 1;
    const int ntrail = s > 0 ? m * (m + 1) / 2 : 0;
    const bool spare = nb_grid > npanel;   // blocks left over by the panel
    const int first = spare ? npanel : 0;
    const int step = spare ? nb_grid - npanel : nb_grid;
    for (int t = blockIdx.x - first; blockIdx.x >= first && t < ntrail;
         t += step) {
      int i, j;
      upper_tile(t, m, &i, &j);
      i += s + 1;
      j += s + 1;
      const int oi = i * kTile, oj = j * kTile;
      const int ri = rows(i), rj = rows(j);
      load_u(Ua, s - 1, oi, ri);
      load_u(Ub, s - 1, oj, rj);
      __syncthreads();
      T acc[2][2] = {{T(0), T(0)}, {T(0), T(0)}};
#pragma unroll 8
      for (int p = 0; p < kTile; ++p) {
        const T u0 = Ua[p * kTile + ty], u1 = Ua[p * kTile + ty + 16];
        const T v0 = Ub[p * kTile + tx], v1 = Ub[p * kTile + tx + 16];
        acc[0][0] += u0 * v0;
        acc[0][1] += u0 * v1;
        acc[1][0] += u1 * v0;
        acc[1][1] += u1 * v1;
      }
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int r = ty + 16 * a;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int c = tx + 16 * q;
          if (r < ri && c < rj && (i != j || c >= r)) {
            A[(oi + r) * n + oj + c] -= acc[a][q];
          }
        }
      }
      __syncthreads();
    }
    grid.sync();
  }

  // ---- U x = z by tiles from the last, by dataflow ----
  // Tile i belongs to block (nt - 1 - i) mod grid, which takes its tiles
  // from the last: it applies z_i -= U_ik x_k as each x_k (k > i) is
  // flagged, then x_i = U_ii^-1 z_i, writes it and raises flags[i]. A
  // block only waits for flags of later tiles, all blocks are co-resident,
  // so every wait ends.
  for (int i = nt - 1 - static_cast<int>(blockIdx.x); i >= 0; i -= nb_grid) {
    const int oi = i * kTile, ti = rows(i);
    for (int idx = tid; idx < kTT; idx += kThreads) Ua[idx] = Ud[i * kTT + idx];
    for (int r = tid; r < kTile; r += kThreads) vec[r] = r < ti ? z[oi + r] : T(0);
    for (int k = nt - 1; k > i; --k) {
      const int o = k * kTile, tb = rows(k);
      // the tile U_ik, fetched before x_k is known: warp w rows w + 8 q
      T u[kTile / 8];
#pragma unroll
      for (int q = 0; q < kTile / 8; ++q) {
        u[q] = lane < tb ? A[(oi + warp + 8 * q) * n + o + lane] : T(0);
      }
      if (tid == 0) {
        while (*reinterpret_cast<volatile int*>(flags + k) == 0) {
        }
        __threadfence();
      }
      __syncthreads();
      const T xl = lane < tb ? __ldcg(x + o + lane) : T(0);
#pragma unroll
      for (int q = 0; q < kTile / 8; ++q) {
        const T sum = dense_tile::warp_sum(u[q] * xl);
        if (lane == 0) vec[warp + 8 * q] -= sum;
      }
    }
    __syncthreads();
    if (warp == 0) {   // x_i = U_ii^-1 z_i; Ua holds U_ii^-T
      T acc = T(0);
#pragma unroll 8
      for (int c = 0; c < kTile; ++c) acc += Ua[c * kTile + lane] * vec[c];
      if (lane < ti) x[oi + lane] = acc;
      __threadfence();
      __syncwarp();
      if (lane == 0) atomicExch(flags + i, 1);
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const void* S, const void* b, void* A, void* yz, void* x,
           void* flags, int n, void* stream) {
  if (n < 1 || n > 46340) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = kSmemValues * sizeof(T);
  void* args[] = {&S, &b, &A, &yz, &x, &flags, &n};
  return dense_tile::launch_cooperative(spd_solve_kernel<T>,
                                        max_tasks((n + kTile - 1) / kTile),
                                        kThreads, smem, args, stream);
}

}  // namespace

extern "C" int spd_solve_f32(const void* S, const void* b, void* A, void* yz,
                             void* x, void* flags, int n, void* stream) {
  return launch<float>(S, b, A, yz, x, flags, n, stream);
}

extern "C" int spd_solve_f64(const void* S, const void* b, void* A, void* yz,
                             void* x, void* flags, int n, void* stream) {
  return launch<double>(S, b, A, yz, x, flags, n, stream);
}
