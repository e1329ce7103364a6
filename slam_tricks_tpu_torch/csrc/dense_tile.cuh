// Dense building blocks of the SPD solves: a warp factors a 32 x 32 SPD
// block in registers, a thread a column runs the triangular solves in
// registers, and a block solves an SPD block held in shared (or
// block-private global) memory against many right-hand sides
// (tridiag_solve.cu), or factors it and runs the forward half
// (spd_solve_blocked.cu's panels); the pivot rule, the warp sum and the
// cooperative launch (spd_solve.cu too).
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace dense_tile {

__device__ __forceinline__ float rsqrt_t(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_t(double x) { return rsqrt(x); }

// 1 / sqrt(d), and NaN for a pivot d <= 0, as a library Cholesky reports
// a matrix that is not positive definite
template <typename T>
__device__ __forceinline__ T nan_pivot_scale(T d) {
  return d > T(0) ? rsqrt_t(d) : static_cast<T>(nan(""));
}

constexpr unsigned kFullWarp = 0xffffffffu;
constexpr int kPanel = 32;   // a lane a column

// One warp factors the 32 x 32 diagonal block at (k0, k0) of P (row stride
// ld) in registers, lane c holding column k0 + c, with shuffles and no
// block barrier. Its upper triangle becomes U (U_pp = d_p s_p = sqrt(d_p),
// s_p = nan_pivot_scale(d_p) of the p-th Schur-complement pivot d_p) and
// s_p goes to sc[k0 + p]. Entries below the diagonal are read but not used.
template <typename T>
__device__ __forceinline__ void warp_factor(T* P, int ld, int k0, T* sc) {
  const int lane = threadIdx.x & 31;
  T* col = P + k0 * ld + k0 + lane;
  T a[kPanel];
#pragma unroll
  for (int r = 0; r < kPanel; ++r) a[r] = col[r * ld];
#pragma unroll
  for (int p = 0; p < kPanel; ++p) {
    const T d = __shfl_sync(kFullWarp, a[p], p);
    const T sp = nan_pivot_scale(d);
    const T u = a[p] * sp;   // U[p, lane]
    a[p] = u;
    if (lane == p) sc[k0 + p] = sp;
#pragma unroll
    for (int r = p + 1; r < kPanel; ++r) a[r] -= __shfl_sync(kFullWarp, u, r) * u;
  }
#pragma unroll
  for (int r = 0; r < kPanel; ++r) col[r * ld] = a[r];
}

// One thread: rows k0 .. k0 + 31 of column c of P become U_kk^-T times
// themselves (U_kk from warp_factor, its scales in sc), in registers.
template <typename T>
__device__ __forceinline__ void col_forward(T* P, int ld, int k0, int c,
                                            const T* sc) {
  T* col = P + k0 * ld + c;
  T v[kPanel];
#pragma unroll
  for (int r = 0; r < kPanel; ++r) v[r] = col[r * ld];
#pragma unroll
  for (int p = 0; p < kPanel; ++p) {
    const T* up = P + (k0 + p) * ld + k0;
    const T u = v[p] * sc[k0 + p];
    v[p] = u;
#pragma unroll
    for (int r = p + 1; r < kPanel; ++r) v[r] -= up[r] * u;
  }
#pragma unroll
  for (int r = 0; r < kPanel; ++r) col[r * ld] = v[r];
}

// One thread: rows k0 .. k0 + 31 of column c of P become U_kk^-1 times
// themselves, dividing by U_pp as multiplying by rinv[k0 + p].
template <typename T>
__device__ __forceinline__ void col_backward(T* P, int ld, int k0, int c,
                                             const T* rinv) {
  T* col = P + k0 * ld + c;
  T v[kPanel];
#pragma unroll
  for (int r = 0; r < kPanel; ++r) v[r] = col[r * ld];
#pragma unroll
  for (int p = kPanel - 1; p >= 0; --p) {
    const T xp = v[p] * rinv[k0 + p];
    v[p] = xp;
#pragma unroll
    for (int r = 0; r < p; ++r) v[r] -= P[(k0 + r) * ld + k0 + p] * xp;
  }
#pragma unroll
  for (int r = 0; r < kPanel; ++r) col[r * ld] = v[r];
}

// P[i, c] -= sum_{p < K} A(i, p) P[pb + p, c] for i in [i0, i1) and c in
// [c0, c1) (only c >= i when kUpper), A(i, p) = P[pa + p, i] (kTransA) or
// P[i, pa + p]. A warp takes 4 rows by 128 columns at a time, 4 x 4 sums a
// lane in registers: the rows' operands are broadcast, the columns'
// coalesced. The rows written must not be rows or columns read.
template <typename T, bool kTransA, bool kUpper>
__device__ void sub_product(T* P, int ld, int i0, int i1, int c0, int c1,
                            int pa, int pb, int K) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int nrg = (i1 - i0 + 3) / 4, ncs = (c1 - c0 + 127) / 128;
  for (int t = warp; t < nrg * ncs; t += warps) {
    const int ib = i0 + 4 * (t / ncs), cb = c0 + 128 * (t % ncs);
    if (kUpper && cb + 127 < ib) continue;   // wholly below the diagonal
    int ii[4], cc[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      ii[q] = min(ib + q, i1 - 1);
      cc[q] = min(cb + lane + 32 * q, c1 - 1);
    }
    T acc[4][4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
#pragma unroll
      for (int y = 0; y < 4; ++y) acc[x][y] = T(0);
    }
#pragma unroll 4
    for (int p = 0; p < K; ++p) {
      T a[4], b[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        a[q] = kTransA ? P[(pa + p) * ld + ii[q]] : P[ii[q] * ld + pa + p];
        b[q] = P[(pb + p) * ld + cc[q]];
      }
#pragma unroll
      for (int x = 0; x < 4; ++x) {
#pragma unroll
        for (int y = 0; y < 4; ++y) acc[x][y] += a[x] * b[y];
      }
    }
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int i = ib + x;
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const int c = cb + lane + 32 * y;
        if (i < i1 && c < c1 && (!kUpper || c >= i)) P[i * ld + c] -= acc[x][y];
      }
    }
  }
}

// The whole block: P (m rows, m a multiple of 32, row stride ld) holds an
// SPD m x m block A (upper triangle read) in columns [0, m) and na
// right-hand sides in columns [m, m + na). Blocked right-looking Cholesky
// A = U^T U by panels of 32 rows (warp factor, then a thread a column for
// U^-T on everything to the right, then the trailing update by
// sub_product): the upper triangle of columns [0, m) becomes U, the
// right-hand sides U^-T times themselves, and sc[p] = 1 / U_pp. A pivot
// d <= 0 gives NaN. Starts with a barrier and ends without one.
template <typename T>
__device__ void chol_forward_block(T* P, int ld, int m, int na, T* sc) {
  const int warp = threadIdx.x >> 5;
  for (int k0 = 0; k0 < m; k0 += kPanel) {
    const int k1 = k0 + kPanel;
    __syncthreads();
    if (warp == 0) warp_factor(P, ld, k0, sc);
    __syncthreads();
    for (int c = k1 + threadIdx.x; c < m + na; c += blockDim.x) {
      col_forward(P, ld, k0, c, sc);
    }
    __syncthreads();
    // the trailing update: P[i, c] -= U[panel, i]^T U[panel, c], c >= i
    sub_product<T, true, true>(P, ld, k1, m, k1, m + na, k0, k0, kPanel);
  }
}

// The whole block: as chol_forward_block, then U^-1 by panels from the
// last, so the right-hand sides become A^-1 times themselves. sc: m values
// of scratch. Starts and ends with a barrier.
template <typename T>
__device__ void chol_solve_block(T* P, int ld, int m, int na, T* sc) {
  chol_forward_block(P, ld, m, na, sc);
  // 1 / U_pp = 1 / sqrt(d_p) = s_p under the NaN rule
  for (int k0 = m - kPanel; k0 >= 0; k0 -= kPanel) {
    const int k1 = k0 + kPanel;
    __syncthreads();
    if (k1 < m) {   // rows of the panel -= U[panel, k1:] X[k1:]
      sub_product<T, false, false>(P, ld, k0, k1, m, m + na, k1, k1, m - k1);
      __syncthreads();
    }
    for (int c = m + threadIdx.x; c < m + na; c += blockDim.x) {
      col_backward(P, ld, k0, c, sc);
    }
  }
  __syncthreads();
}

template <typename T>
__device__ __forceinline__ T warp_sum(T s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFullWarp, s, off);
  return s;   // in every lane
}

// Cooperative launch of kernel on a grid of at most one block an SM,
// checked first against what can be co-resident. Returns a cudaError_t.
template <typename Kernel>
int launch_cooperative(Kernel kernel, int blocks, int threads, size_t smem,
                       void** args, void* stream) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess && smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop || per_sm < 1) {
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  }
  if (blocks > sms) blocks = sms;
  if (blocks < 1) blocks = 1;
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(blocks), dim3(threads), args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dense_tile
