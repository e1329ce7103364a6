// SPD block-tridiagonal solve by block cyclic reduction, for Hopper (sm_90a).
//
// Replaces: slam_tricks_tpu/ops/pallas_tridiag.py::_kernel (called by
// tridiag_solve), and computes the same function: the solution x (G, m, q)
// of T x = r for q right-hand sides r (G, m, q), T with diagonal blocks
// D (G, m, m) and sub-diagonal blocks E (G-1, m, m), E_g = T[g+1, g], all
// row-major (the Pallas kernel takes q = 1). The algorithm is the JAX
// package's own default, slam_tricks_tpu/solvers/banded_flat.py::
// _block_tridiag_cr_multi (reduced down to one block; its dense tail of 8
// blocks is the same solve), not the Pallas kernel's sequential sweep. At
// each level, on the current system of Gc blocks:
//   phase 1, a block per odd row i: Cholesky D_i = U^T U in shared memory
//     with [E_{i-1} | E_i^T | r_i] (2 m + q columns) carried along, then
//     U^-1, giving W_i = [M E_{i-1} | M E_i^T | M r_i], M = D_i^-1, into a
//     level store
//     (dense_tile.cuh: by panels of 32 rows, each factored by one warp in
//     registers, the solves a thread a column in registers);
//   grid barrier;
//   phase 2, a block per even row 2k: the half-size system
//     D'_k = D_2k - E_2k^T M_2k+1 E_2k - E_2k-1 M_2k-1 E_2k-1^T,
//     E'_k = -E_2k+1 M_2k+1 E_2k,
//     r'_k = r_2k - E_2k^T M_2k+1 r_2k+1 - E_2k-1 M_2k-1 r_2k-1,
//     into a ping-pong level buffer;
//   grid barrier.
// An odd Gc needs no padding: its last (even) row has no odd row below.
// At Gc = 1 one block solves D x = r by Cholesky. Back-substitution, one
// parallel phase a level from the coarsest: x_i = M r_i - M E_{i-1} x_{i-1}
// - M E_i^T x_{i+1} for the odd rows, a warp an entry of a row. Row j of
// level l is
// row j 2^l of the original system, so every level writes into x directly.
// That is 3 log2(G) grid barriers, 21 at G = 128, where the sequential
// sweep had ~6,100 block barriers.
// A Schur complement that is not positive definite gives NaN (a pivot
// d <= 0 scales by NaN), as the plain version and JAX's cyclic reduction
// do; the Pallas kernel's unpivoted Gauss-Jordan gave finite values there.
// The LM loop turns a non-finite step into a rejected zero step.
//
// What bounds it on the H100: the chain of log2(G) levels, each a Cholesky
// of m pivots and two triangular solves, then three m^3 products; the
// bytes (D, E, r, x: 2.4 MB at (128, 48) f32,
// 0.71 us at 3.35 TB/s) and the operations the solve needs (block Cholesky,
// 35 MFLOP, 0.53 us at 67 TFLOP/s) are far below what the chain costs.
// What the design does about it: one cooperative launch of a persistent
// grid of min(#SMs, ceil(G / 2)) blocks of 256 threads (64 at G = 128),
// co-residency checked before the launch, cooperative_groups grid syncs
// between phases; the level store (sum over levels of the odd rows,
// m (2m + q) values each: 1.2 MB at (128, 48, 1) f32) and the level buffers
// stay in the 50 MB L2; the products keep 4 x 4 sums a thread in registers.
// Size limit: m <= 512 and q <= 16 (the wrapper's MAX_M and MAX_Q). A
// block's working tile, mp (mp + 2m + q + 1) values with mp = m rounded up
// to 32, sits in shared memory while it fits (at q = 1 up to m = 128 in f32
// and m = 96 in f64); beyond, in a global scratch `work`, one slice a block
// (the K = 32 band, m = 192, in f64: 0.89 MB a block, L2-resident).
// The column count is a template argument: kQ = 1 is the single
// right-hand side of the banded BA (path B), compiled as before the
// multi-column form existed; kQ = 0 takes q at run time (the VI chain's
// [g | U], q = 7, and its covariances' U, q = 6).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "dense_tile.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// a block's working tile: the m x m block padded with the identity to
// mp = m rounded up to 32 (whole panels of dense_tile.cuh; padding is
// exact), then 2 m + q right-hand-side columns, then mp scales
__host__ __device__ constexpr int padded(int m) { return (m + 31) / 32 * 32; }
__host__ __device__ constexpr int tile_ld(int m, int q) {
  return padded(m) + 2 * m + q;
}
__host__ __device__ constexpr size_t tile_values(int m, int q) {
  return static_cast<size_t>(padded(m)) * (tile_ld(m, q) + 1);
}

// P[:, :mp] = the block at Dsrc padded with the identity; the na columns at
// mp zeroed in the padding rows
template <typename T>
__device__ void load_block(T* P, const T* Dsrc, int m, int ld, int na) {
  const int mp = padded(m);
  for (int idx = threadIdx.x; idx < mp * mp; idx += blockDim.x) {
    const int a = idx / mp, c = idx - a * mp;
    P[a * ld + c] = a < m && c < m ? Dsrc[a * m + c] : T(a == c ? 1 : 0);
  }
  for (int idx = threadIdx.x; idx < (mp - m) * na; idx += blockDim.x) {
    const int a = m + idx / na, c = idx - (a - m) * na;
    P[a * ld + mp + c] = T(0);
  }
}

template <typename T, bool kSmemTiles, int kQ>
__global__ void __launch_bounds__(kThreads)
tridiag_solve_kernel(const T* __restrict__ D, const T* __restrict__ E,
                     const T* __restrict__ r, T* store, T* lev, T* work, T* x,
                     int G, int m, int q_arg) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int q = kQ > 0 ? kQ : q_arg;             // right-hand sides
  T* P = kSmemTiles ? reinterpret_cast<T*>(smem_raw)
                    : work + blockIdx.x * tile_values(m, q);
  const int mp = padded(m);
  const int ld = tile_ld(m, q);
  T* sc = P + mp * ld;
  const int lw = 2 * m + q;                       // row stride of a W_i
  const size_t mm = static_cast<size_t>(m) * m;
  const size_t mq = static_cast<size_t>(m) * q;   // a row of r and x
  const size_t mw = static_cast<size_t>(m) * lw;
  const int hmax = (G + 1) / 2;
  const size_t lev_values = static_cast<size_t>(hmax) * (2 * mm + mq);
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nb_grid = gridDim.x;

  int levels = 0;
  const T* Dc = D;
  const T* Ec = E;
  const T* rc = r;
  int Gc = G;
  size_t soff = 0;

  // ---- forward: reduce to one block ----
  while (Gc > 1) {
    const int hodd = Gc / 2, hev = (Gc + 1) / 2;
    // phase 1: W_i = D_i^-1 [E_{i-1} | E_i^T | r_i], i = 2k + 1
    for (int k = blockIdx.x; k < hodd; k += nb_grid) {
      const int i = 2 * k + 1;
      const bool below = i + 1 < Gc;
      const T* Di = Dc + i * mm;
      const T* Ea = Ec + (i - 1) * mm;
      const T* Eb = Ec + i * mm;
      load_block(P, Di, m, ld, lw);
      for (int idx = tid; idx < m * m; idx += kThreads) {
        const int a = idx / m, c = idx - a * m;
        P[a * ld + mp + c] = Ea[idx];
        P[c * ld + mp + m + a] = below ? Eb[idx] : T(0);   // E_i^T
      }
      for (int idx = tid; idx < m * q; idx += kThreads) {
        const int a = idx / q, c = idx - a * q;
        P[a * ld + mp + 2 * m + c] = rc[i * mq + idx];
      }
      dense_tile::chol_solve_block(P, ld, mp, lw, sc);
      T* W = store + soff + k * mw;
      for (int idx = tid; idx < m * lw; idx += kThreads) {
        const int a = idx / lw, c = idx - a * lw;
        W[idx] = P[a * ld + mp + c];
      }
      __syncthreads();
    }
    grid.sync();

    // phase 2: the half-size system, row k = old row 2k
    T* Dn = lev + (levels & 1) * lev_values;
    T* En = Dn + hmax * mm;
    T* rn = En + hmax * mm;
    const int nbk = (m + 3) / 4;
    for (int k = blockIdx.x; k < hev; k += nb_grid) {
      const int e = 2 * k;
      const bool down = e + 1 < Gc, up = k > 0, next = e + 2 < Gc;
      const T* De = Dc + e * mm;
      const T* Ed = Ec + e * mm;         // E_2k = T[2k+1, 2k]
      const T* Eu = Ec + (up ? e - 1 : 0) * mm;   // E_2k-1 = T[2k, 2k-1]
      const T* Ex = Ec + (e + 1) * mm;   // E_2k+1 = T[2k+2, 2k+1]
      const T* Wd = store + soff + k * mw;
      const T* Wu = store + soff + (up ? k - 1 : 0) * mw;
      for (int blk = tid; blk < nbk * nbk; blk += kThreads) {
        const int i0 = 4 * (blk / nbk), j0 = 4 * (blk % nbk);
        int ii[4], jj[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          ii[q] = min(i0 + q, m - 1);
          jj[q] = min(j0 + q, m - 1);
        }
        T dacc[4][4], eacc[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            dacc[a][c] = De[ii[a] * m + jj[c]];
            eacc[a][c] = T(0);
          }
        }
        if (down) {   // D' -= E_2k^T (M E_2k);  E' -= E_2k+1 (M E_2k)
          for (int p = 0; p < m; ++p) {
            T u[4], v[4], w[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              u[q] = Ed[p * m + ii[q]];
              v[q] = Wd[p * lw + jj[q]];
              w[q] = next ? Ex[ii[q] * m + p] : T(0);
            }
#pragma unroll
            for (int a = 0; a < 4; ++a) {
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                dacc[a][c] -= u[a] * v[c];
                eacc[a][c] -= w[a] * v[c];
              }
            }
          }
        }
        if (up) {     // D' -= E_2k-1 (M E_2k-1^T)
          for (int p = 0; p < m; ++p) {
            T u[4], v[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              u[q] = Eu[ii[q] * m + p];
              v[q] = Wu[p * lw + m + jj[q]];
            }
#pragma unroll
            for (int a = 0; a < 4; ++a) {
#pragma unroll
              for (int c = 0; c < 4; ++c) dacc[a][c] -= u[a] * v[c];
            }
          }
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (i0 + a < m && j0 + c < m) {
              Dn[k * mm + (i0 + a) * m + j0 + c] = dacc[a][c];
              if (next) En[k * mm + (i0 + a) * m + j0 + c] = eacc[a][c];
            }
          }
        }
      }
      for (int idx = tid; idx < m * q; idx += kThreads) {
        const int a = idx / q, c = idx - a * q;
        T s = rc[e * mq + idx];
        for (int p = 0; p < m; ++p) {
          if (down) s -= Ed[p * m + a] * Wd[p * lw + 2 * m + c];
          if (up) s -= Eu[a * m + p] * Wu[p * lw + 2 * m + c];
        }
        rn[k * mq + idx] = s;
      }
    }
    grid.sync();
    Dc = Dn;
    Ec = En;
    rc = rn;
    soff += hodd * mw;
    Gc = hev;
    ++levels;
  }

  // ---- the last block: D x_0 = r ----
  if (blockIdx.x == 0) {
    load_block(P, Dc, m, ld, q);
    for (int idx = tid; idx < m * q; idx += kThreads) {
      const int a = idx / q, c = idx - a * q;
      P[a * ld + mp + c] = rc[idx];
    }
    dense_tile::chol_solve_block(P, ld, mp, q, sc);
    for (int idx = tid; idx < m * q; idx += kThreads) {
      const int a = idx / q, c = idx - a * q;
      x[idx] = P[a * ld + mp + c];
    }
  }

  // ---- back-substitution, from the coarsest level ----
  for (int l = levels - 1; l >= 0; --l) {
    grid.sync();
    int gc = G;   // size and store offset of level l
    size_t soffl = 0;
    for (int q = 0; q < l; ++q) {
      soffl += gc / 2 * mw;
      gc = (gc + 1) / 2;
    }
    const int hodd = gc / 2;
    const size_t stride = static_cast<size_t>(1) << l;
    for (int k = blockIdx.x; k < hodd; k += nb_grid) {
      const T* W = store + soffl + k * mw;
      const T* xl = x + 2 * k * stride * mq;
      const bool right = 2 * k + 2 < gc;
      const T* xr = x + (2 * k + 2) * stride * mq;
      T* xo = x + (2 * k + 1) * stride * mq;
      for (int idx = warp; idx < m * q; idx += kWarps) {
        const int a = idx / q, c = idx - a * q;
        const T* wa = W + a * lw;
        T s = T(0);
        for (int b = lane; b < m; b += 32) {
          s += wa[b] * xl[b * q + c];
          if (right) s += wa[m + b] * xr[b * q + c];
        }
        s = dense_tile::warp_sum(s);
        if (lane == 0) xo[idx] = wa[2 * m + c] - s;
      }
    }
  }
}

template <typename T, bool kSmemTiles, int kQ>
int launch_as(const void* D, const void* E, const void* r, void* store,
              void* lev, void* work, void* x, int G, int m, int q,
              void* stream) {
  const size_t smem = kSmemTiles ? tile_values(m, q) * sizeof(T) : 0;
  void* args[] = {&D, &E, &r, &store, &lev, &work, &x, &G, &m, &q};
  return dense_tile::launch_cooperative(
      tridiag_solve_kernel<T, kSmemTiles, kQ>, (G + 1) / 2, kThreads, smem,
      args, stream);
}

template <typename T, bool kSmemTiles>
int launch_q(const void* D, const void* E, const void* r, void* store,
             void* lev, void* work, void* x, int G, int m, int q,
             void* stream) {
  return q == 1 ? launch_as<T, kSmemTiles, 1>(D, E, r, store, lev, work, x, G,
                                              m, q, stream)
                : launch_as<T, kSmemTiles, 0>(D, E, r, store, lev, work, x, G,
                                              m, q, stream);
}

// work == nullptr: the tiles in shared memory
template <typename T>
int launch(const void* D, const void* E, const void* r, void* store,
           void* lev, void* work, void* x, int G, int m, int q, void* stream) {
  if (G < 1 || m < 1 || m > 512 || q < 1 || q > 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return work == nullptr
             ? launch_q<T, true>(D, E, r, store, lev, work, x, G, m, q, stream)
             : launch_q<T, false>(D, E, r, store, lev, work, x, G, m, q,
                                  stream);
}

}  // namespace

extern "C" int tridiag_solve_f32(const void* D, const void* E, const void* r,
                                 void* store, void* lev, void* work, void* x,
                                 int G, int m, int q, void* stream) {
  return launch<float>(D, E, r, store, lev, work, x, G, m, q, stream);
}

extern "C" int tridiag_solve_f64(const void* D, const void* E, const void* r,
                                 void* store, void* lev, void* work, void* x,
                                 int G, int m, int q, void* stream) {
  return launch<double>(D, E, r, store, lev, work, x, G, m, q, stream);
}
