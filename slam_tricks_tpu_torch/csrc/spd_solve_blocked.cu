// Dense SPD solve S x = b at large n (the reduced camera system of a few
// hundred cameras and up), for Hopper (sm_90a). ops/spd_solve.py takes it
// for n >= BLOCKED_MIN_N = 1536 and spd_solve.cu below that.
//
// Replaces, as spd_solve.cu does at small n:
// slam_tricks_tpu/ops/pallas_chol.py::_kernel (called by chol_solve_padded /
// chol_solve): upper Cholesky S = U^T U read from the upper triangle of S,
// then U^T z = b and U x = z. A pivot d <= 0 or not finite gives NaN in
// every value of x (dense_tile.cuh's nan_pivot_scale), as spd_solve.cu; the
// NaN changes no control flow, so every block reaches every grid barrier.
//
// What bounds each path on the H100. spd_solve.cu (32-row tiles, a block a
// panel tile, one 32 x 32 x 32 update a block a round) is bound by its
// chain of 32-row tile rows, which suits n <= 672, and starves the trailing
// updates at large n: at n = 3,204 (BAL Dubrovnik's S) the updates are
// n^3 / 3 = 1.1e10 operations, 0.164 ms at 67 TFLOP/s, and it takes 9.32
// ms there, the library's Cholesky 1.73. This kernel is bound first by
// those updates, then, once the trailing triangle is small, by its chain
// of 64-row panels (~16 us a step at n = 3,204).
// What this design does about it: one cooperative launch of a persistent
// grid, a block on every SM, one grid barrier a step of nt = ceil(n / 64):
//   - A is an N x N device copy of S, N = 64 nt, padded with the identity
//     (a padded row and column of U are zero, a padded z and x zero), so no
//     tile is ragged; element offsets are 32-bit unsigned (N * N < 2^32 for
//     n <= 46,340). Only the upper tiles are copied, and only they are read.
//     Ud, after A, takes the nt factored diagonal tiles U_ii.
//   - Step s (s = -1 .. nt - 2) runs the panel of tile row r = s + 1 ahead
//     of the bulk of step s's update (a lookahead of one): the blocks of
//     the panel each take one 64-column chunk (r, J) of row r, stage
//     [A_rr | A_rJ | y_r] in shared memory, apply row s's update to it
//     themselves (one register-blocked 64 x 128 x 64 product), factor A_rr
//     and solve U_rr^T [U_rJ | z_r] = [A_rJ | y_r] (dense_tile.cuh's
//     chol_forward_block), write U_rJ and update y_J -= U_rJ^T z_r; the
//     first also writes z_r, and U_rr into Ud, a scratch beside A (the
//     other panel blocks still read A_rr). Every panel block factors A_rr
//     again, which saves a barrier.
//   - Meanwhile every other block, and the panel's blocks after it, apply
//     row s's update to the tiles of rows s + 2 .. nt - 1, taking tiles
//     from a counter of the step: A_ij -= U_si^T U_sj on 128 x 128 output
//     tiles of the upper triangle (64 x 64 when the triangle has fewer
//     128-tiles than the grid has blocks, and always in float64), the two
//     64-deep operand strips staged by cp.async and double-buffered, so a
//     tile's loads overlap the previous tile's products; 256 threads with
//     8 x 8 (4 x 4) sums each in registers. A diagonal tile keeps its
//     upper half.
//   - grid barrier.
// Backward substitution U x = z by tile rows from the last, with no grid
// barrier: the block of tile row i inverts U_ii in shared memory first
// (all rows at once, off the chain), then applies z_i -= U_ik x_k as each
// x_k is flagged (U_ik fetched before the wait), x_i = U_ii^-1 z_i, and
// flags x_i: a chain of nt flag hand-offs.
// At n = 3,204: N = 3,264, 51 steps and 52 grid barriers (spd_solve.cu:
// 101 steps of 32 rows), a grid of one block an SM.
// On the card (H100 80GB HBM3, 700 W; tools/spd_crossover.py, the card's
// time alone, ms, this kernel / spd_solve.cu, float32 then float64):
//   n =  576: 0.169 / 0.170,  0.310 / 0.239
//   n = 1024: 0.300 / 0.328,  0.553 / 0.434
//   n = 1280: 0.380 / 0.485,  0.699 / 0.604
//   n = 1536: 0.457 / 0.726,  0.844 / 0.874
//   n = 2048: 0.632 / 1.597,  1.224 / 1.851
//   n = 3204: 1.346 / 9.316,  2.729 / 11.739
// so the crossover is 1536, the first n at which this kernel is faster in
// both types (float32 alone from 768).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

#include "dense_tile.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kB = 64;                  // a tile row: the panel's rows
constexpr int kBB = kB * kB;
constexpr int kThreads = 256;           // a 16 x 16 grid in the products
constexpr int kLdP = 2 * kB + 4;        // [A_rr | A_rJ | y_r 0 0 0]
constexpr int kLdU = 2 * kB;            // [U_sr | U_sJ]
constexpr int kLdI = kB + 1;            // U_ii^-T, odd stride

// the bulk's widest thread tile: 8 x 8 sums (128 x 128 output tiles) in
// float32; float64's 4 x 4 keeps its two double buffers in 128 KB
template <typename T>
constexpr int kWideTM = sizeof(T) == 4 ? 8 : 4;

// shared memory, in values: the panel's, the bulk's or the back
// substitution's, which never live at once
template <typename T>
constexpr size_t smem_values() {
  const size_t panel = kB * kLdP + kB * kLdU + kB;
  const size_t bulk = 2 * 2 * kB * 16 * kWideTM<T>;
  const size_t back = kBB + kB * kLdI + 2 * kB;
  const size_t most = panel > bulk ? panel : bulk;
  return most > back ? most : back;
}

// (i, j) of the t-th tile of an m x m upper tile triangle, row by row;
// rows before i hold i m - i (i - 1) / 2 tiles
__device__ __forceinline__ void upper_tile(int t, int m, int* i, int* j) {
  const double c = 2.0 * m + 1.0;
  int r = static_cast<int>(0.5 * (c - sqrt(c * c - 8.0 * t)));
  r = max(0, min(r, m - 1));
  while (r > 0 && r * m - r * (r - 1) / 2 > t) --r;
  while (r + 1 < m && (r + 1) * m - (r + 1) * r / 2 <= t) ++r;
  *i = r;
  *j = r + t - (r * m - r * (r - 1) / 2);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// 64 rows of `cols` values into shared memory, asynchronously:
// dst[p * lds + c] = src[p * N + c] for c < live, 0 for live <= c < cols
template <typename T>
__device__ __forceinline__ void stage(T* dst, int lds, const T* src,
                                      unsigned N, int cols, int live) {
  constexpr int kV = 16 / sizeof(T);
  const int per_row = cols / kV;
  for (int idx = threadIdx.x; idx < kB * per_row; idx += kThreads) {
    const int p = idx / per_row, c = (idx - p * per_row) * kV;
    const bool ok = c < live;
    cp_async16(dst + p * lds + c, src + p * N + (ok ? c : 0), ok);
  }
}

// four consecutive values, 16-byte aligned, from shared memory (load4 /
// store4) or from L2 (load4_cg)
template <typename T>
__device__ __forceinline__ void load4(const T* p, T* v) {
  if constexpr (sizeof(T) == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    const double2 a = *reinterpret_cast<const double2*>(p);
    const double2 b = *reinterpret_cast<const double2*>(p + 2);
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  }
}
template <typename T>
__device__ __forceinline__ void load4_cg(const T* p, T* v) {
  if constexpr (sizeof(T) == 4) {
    const float4 q = __ldcg(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    const double2 a = __ldcg(reinterpret_cast<const double2*>(p));
    const double2 b = __ldcg(reinterpret_cast<const double2*>(p + 2));
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  }
}
template <typename T>
__device__ __forceinline__ void store4(T* p, const T* v) {
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
    *reinterpret_cast<double2*>(p + 2) = make_double2(v[2], v[3]);
  }
}

// The thread's element (i, j) of a (16 TR) x (16 TC) output tile is
// (row(i), col(j)), row(i) = 64 (i / 4) + 4 ty + i % 4, col(j) likewise with
// tx (tid = 16 ty + tx): acc[i][j] = sum_{p < 64} a[p lda + row(i)]
// b[p ldb + col(j)], a and b in shared memory. A k-step reads TR / 4 + TC
// / 4 vectors of four for TR TC products: at 4 x 4 the 64 x 64 tile is
// bound by shared memory's bandwidth, at 8 x 8 not.
template <typename T, int TR, int TC>
__device__ __forceinline__ void tile_product(const T* a, int lda, const T* b,
                                             int ldb, T (&acc)[TR][TC]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < TR; ++i) {
#pragma unroll
    for (int j = 0; j < TC; ++j) acc[i][j] = T(0);
  }
#pragma unroll 4
  for (int p = 0; p < kB; ++p) {
    T av[TR], bv[TC];
#pragma unroll
    for (int g = 0; g < TR / 4; ++g) load4(a + p * lda + 64 * g + 4 * ty, av + 4 * g);
#pragma unroll
    for (int g = 0; g < TC / 4; ++g) load4(b + p * ldb + 64 * g + 4 * tx, bv + 4 * g);
#pragma unroll
    for (int i = 0; i < TR; ++i) {
#pragma unroll
      for (int j = 0; j < TC; ++j) acc[i][j] += av[i] * bv[j];
    }
  }
}

// One bulk tile: A[R + row, C + col] -= (As^T Bs)[row, col] for the
// thread's elements; rows and columns from N on are skipped, and on a
// diagonal tile (R == C) the elements below the diagonal. The old values
// are read after the products (fetched before them, they held 64 registers
// through the products and cost more than their latency), all before the
// first store: a load after a store to A would wait for it.
template <typename T, int TM>
__device__ __forceinline__ void bulk_tile(const T* As, const T* Bs, T* A,
                                          unsigned N, unsigned R, unsigned C,
                                          bool diag) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  T acc[TM][TM];
  tile_product<T, TM, TM>(As, 16 * TM, Bs, 16 * TM, acc);
  auto live = [&](int i, int g, int f) {
    const unsigned r = R + 64 * (i / 4) + 4 * ty + i % 4;
    const unsigned c = C + 64 * g + 4 * tx + f;
    return r < N && c < N && (!diag || c >= r);
  };
  auto at = [&](int i, int g) {
    return A + (R + 64 * (i / 4) + 4 * ty + i % 4) * N + C + 64 * g + 4 * tx;
  };
  T old[TM][TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int g = 0; g < TM / 4; ++g) {
      if (!diag && live(i, g, 3)) {
        load4_cg(at(i, g), &old[i][4 * g]);
      } else {
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          old[i][4 * g + f] = live(i, g, f) ? __ldcg(at(i, g) + f) : T(0);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int g = 0; g < TM / 4; ++g) {
      T v[4];
#pragma unroll
      for (int f = 0; f < 4; ++f) v[f] = old[i][4 * g + f] - acc[i][4 * g + f];
      if (!diag && live(i, g, 3)) {
        store4(at(i, g), v);
      } else {
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          if (live(i, g, f)) at(i, g)[f] = v[f];
        }
      }
    }
  }
}

// Row s's update of the tile rows s + 2 .. nt - 1 on (16 TM)-square output
// tiles of the upper triangle of tiles; Us is tile row s of A (U_s.). The
// spare blocks (those with no panel task this step) start on tiles 0 ..
// spare - 1; after that a block takes its next tile from the step's
// counter *next (zero at the start), so the panel's blocks, which come
// late, take fewer. Each tile's two strips are staged into one buffer
// while the previous tile's products run on the other, and the tile after
// that is asked for then too, so the atomic's latency hides behind the
// products. Which block updates a tile changes nothing in its bits.
template <typename T, int TM>
__device__ void bulk_step(T* A, unsigned N, int nt, int s, int npanel,
                          int* next, T* smem) {
  constexpr int kBM = 16 * TM, kQ = TM / 4;   // kQ tile rows a side
  __shared__ int grab[2];
  const int r0 = s + 2;
  const int m = nt - r0;
  if (m <= 0) return;
  const int mq = (m + kQ - 1) / kQ;
  const int ntask = mq * (mq + 1) / 2;
  const int b = blockIdx.x;
  const int spare = max(static_cast<int>(gridDim.x) - npanel, 0);
  const T* Us = A + static_cast<unsigned>(s) * kB * N;
  T* const buf[2] = {smem, smem + 2 * kB * kBM};
  auto corner = [&](int t, unsigned* R, unsigned* C) {
    int i, j;
    upper_tile(t, mq, &i, &j);
    *R = static_cast<unsigned>(r0 + kQ * i) * kB;
    *C = static_cast<unsigned>(r0 + kQ * j) * kB;
  };
  auto issue = [&](int t, T* dst) {
    unsigned R, C;
    corner(t, &R, &C);
    stage(dst, kBM, Us + R, N, kBM, static_cast<int>(min(N - R, 1u * kBM)));
    if (R != C) {
      stage(dst + kB * kBM, kBM, Us + C, N, kBM,
            static_cast<int>(min(N - C, 1u * kBM)));
    }
  };
  // grab[k & 1] is written only after every thread passed the barrier
  // that follows its last read
  int t;
  if (b >= npanel) {
    t = b - npanel;
  } else {
    if (threadIdx.x == 0) grab[0] = spare + atomicAdd(next, 1);
    __syncthreads();
    t = grab[0];
  }
  if (t < ntask) issue(t, buf[0]);
  cp_async_commit();
  if (threadIdx.x == 0 && t < ntask) grab[1] = spare + atomicAdd(next, 1);
  __syncthreads();
  int tn = t < ntask ? grab[1] : ntask;
  for (int k = 0; t < ntask; ++k) {
    int after = ntask;   // the tile after tn, asked for now, read at the end
    if (threadIdx.x == 0 && tn < ntask) after = spare + atomicAdd(next, 1);
    if (tn < ntask) issue(tn, buf[(k + 1) & 1]);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    unsigned R, C;
    corner(t, &R, &C);
    const T* As = buf[k & 1];
    bulk_tile<T, TM>(As, R == C ? As : As + kB * kBM, A, N, R, C, R == C);
    if (threadIdx.x == 0) grab[k & 1] = after;
    __syncthreads();
    t = tn;
    tn = grab[k & 1];
  }
}

// The panel of tile row r = s + 1, chunk c: columns J = 64 (r + 1 + c) ..
// + 63 when c < nt - r - 1 (else no chunk: the last tile row). See the
// note at the top.
template <typename T>
__device__ void panel_task(T* A, T* Ud, T* y, T* z, unsigned N, int nt,
                           int s, int c, T* smem) {
  const int tid = threadIdx.x;
  const int r = s + 1;
  const unsigned o = static_cast<unsigned>(r) * kB;
  const bool chunk = c < nt - r - 1;
  const unsigned J = chunk ? o + kB * (1 + c) : o;
  T* P = smem;                 // (64, kLdP) [A_rr | A_rJ | y_r 0 0 0]
  T* Uc = P + kB * kLdP;       // (64, kLdU) [U_sr | U_sJ]
  T* sc = Uc + kB * kLdU;      // (64) 1 / U_pp
  stage(P, kLdP, A + o * N + o, N, kB, kB);
  stage(P + kB, kLdP, A + o * N + J, N, kB, chunk ? kB : 0);
  if (s >= 0) {
    const T* Us = A + static_cast<unsigned>(s) * kB * N;
    stage(Uc, kLdU, Us + o, N, kB, kB);
    stage(Uc + kB, kLdU, Us + J, N, kB, chunk ? kB : 0);
  }
  cp_async_commit();
  for (int p = tid; p < kB; p += kThreads) {
    T* tail = P + p * kLdP + 2 * kB;
    tail[0] = __ldcg(y + o + p);
    tail[1] = tail[2] = tail[3] = T(0);
  }
  cp_async_wait<0>();
  __syncthreads();
  if (s >= 0) {   // row s's update: [A_rr | A_rJ] -= U_sr^T [U_sr | U_sJ]
    const int tx = tid & 15, ty = tid >> 4;
    T acc[4][8];
    tile_product<T, 4, 8>(Uc, kLdU, Uc, kLdU, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        T* row = P + (4 * ty + i) * kLdP + 64 * g + 4 * tx;
        T v[4];
        load4(row, v);
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] -= acc[i][4 * g + j];
        store4(row, v);
      }
    }
  }
  // U_rr, U_rr^-T [A_rJ | y_r] = [U_rJ | z_r] (a barrier first)
  dense_tile::chol_forward_block(P, kLdP, kB, kB + 4, sc);
  __syncthreads();
  if (c == 0) {
    for (int idx = tid; idx < kBB; idx += kThreads) {
      const int p = idx / kB, q = idx - p * kB;
      Ud[r * kBB + idx] = P[p * kLdP + q];
    }
    for (int p = tid; p < kB; p += kThreads) z[o + p] = P[p * kLdP + 2 * kB];
  }
  if (chunk) {
    for (int idx = tid; idx < kBB; idx += kThreads) {
      const int p = idx / kB, q = idx - p * kB;
      A[(o + p) * N + J + q] = P[p * kLdP + kB + q];
    }
    if (tid < kB) {   // y_J -= U_rJ^T z_r; J has one owner a step
      T acc = T(0);
#pragma unroll 8
      for (int p = 0; p < kB; ++p) {
        acc += P[p * kLdP + kB + tid] * P[p * kLdP + 2 * kB];
      }
      y[J + tid] = __ldcg(y + J + tid) - acc;
    }
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
spd_solve_blocked_kernel(const T* __restrict__ S, const T* __restrict__ b,
                         T* A, T* yz, T* x, int* flags, int n) {
  // flags: nt flags of the back substitution, then nt tile counters
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int nb = gridDim.x;
  const int nt = (n + kB - 1) / kB;
  const unsigned N = static_cast<unsigned>(nt) * kB;
  T* Ud = A + N * N;   // (nt, 64, 64) the diagonal tiles U_ii
  T* y = yz;           // (N) right-hand side, updated tile row by tile row
  T* z = yz + N;       // (N) U^-T b

  // the upper tiles of A = [S 0; 0 I], y = [b; 0], no flag raised
  for (int t = blockIdx.x; t < nt * nt; t += nb) {
    const int ti = t / nt, tj = t - ti * nt;
    if (tj < ti) continue;
    for (int idx = tid; idx < kBB; idx += kThreads) {
      const unsigned r = ti * kB + idx / kB, c = tj * kB + idx % kB;
      A[r * N + c] = r < static_cast<unsigned>(n) && c < static_cast<unsigned>(n)
                         ? S[static_cast<size_t>(r) * n + c]
                         : T(r == c ? 1 : 0);
    }
  }
  for (int i = blockIdx.x * kThreads + tid; i < static_cast<int>(N);
       i += nb * kThreads) {
    y[i] = i < n ? b[i] : T(0);
  }
  for (int i = blockIdx.x * kThreads + tid; i < 2 * nt; i += nb * kThreads) {
    flags[i] = 0;
  }
  grid.sync();

  for (int s = -1; s < nt - 1; ++s) {
    // the panel of tile row s + 1: its chunks, or one task for the last
    const int npanel = max(nt - s - 2, 1);
    for (int c = blockIdx.x; c < npanel; c += nb) {
      panel_task(A, Ud, y, z, N, nt, s, c, smem);
    }
    // row s's update of the rows below
    if (s >= 0) {
      int* next = flags + nt + s;
      if constexpr (kWideTM<T> == 8) {
        const int mq = (nt - s - 1) / 2;   // 128-tiles a side
        if (mq * (mq + 1) / 2 >= nb) {
          bulk_step<T, 8>(A, N, nt, s, npanel, next, smem);
        } else {
          bulk_step<T, 4>(A, N, nt, s, npanel, next, smem);
        }
      } else {
        bulk_step<T, 4>(A, N, nt, s, npanel, next, smem);
      }
    }
    grid.sync();
  }

  // ---- U x = z by tile rows from the last, by dataflow ----
  // Tile row i belongs to block (nt - 1 - i) mod grid, which takes its rows
  // from the last; it waits only for flags of later rows and all blocks
  // are co-resident, so every wait ends.
  const int lane = tid & 31, warp = tid >> 5;
  T* Ua = smem;              // (64, 64) U_ii
  T* Ui = Ua + kBB;          // (64, kLdI) U_ii^-T
  T* vec = Ui + kB * kLdI;   // (64) z_i - sum_k U_ik x_k
  T* rinv = vec + kB;        // (64) 1 / U_pp
  for (int i = nt - 1 - static_cast<int>(blockIdx.x); i >= 0; i -= nb) {
    const unsigned oi = static_cast<unsigned>(i) * kB;
    for (int idx = tid; idx < kBB; idx += kThreads) {
      Ua[idx] = __ldcg(Ud + i * kBB + idx);
    }
    for (int p = tid; p < kB; p += kThreads) vec[p] = __ldcg(z + oi + p);
    __syncthreads();
    for (int p = tid; p < kB; p += kThreads) rinv[p] = T(1) / Ua[p * kB + p];
    __syncthreads();
    if (tid < kB) {   // column tid of U_ii^-1, stored as row tid of Ui
      T e[kB];
#pragma unroll
      for (int r = 0; r < kB; ++r) e[r] = T(r == tid ? 1 : 0);
#pragma unroll
      for (int p = kB - 1; p >= 0; --p) {
        const T xp = e[p] * rinv[p];
        e[p] = xp;
#pragma unroll
        for (int r = 0; r < p; ++r) e[r] -= Ua[r * kB + p] * xp;
      }
#pragma unroll
      for (int r = 0; r < kB; ++r) Ui[tid * kLdI + r] = e[r];
    }
    for (int k = nt - 1; k > i; --k) {
      const unsigned ok = static_cast<unsigned>(k) * kB;
      // the tile U_ik, fetched before x_k is known: warp w rows w + 8 q
      T u[kB / 8][2];
#pragma unroll
      for (int q = 0; q < kB / 8; ++q) {
        const T* row = A + (oi + warp + 8 * q) * N + ok + lane;
        u[q][0] = __ldcg(row);
        u[q][1] = __ldcg(row + 32);
      }
      if (tid == 0) {
        while (*reinterpret_cast<volatile int*>(flags + k) == 0) {
        }
        __threadfence();
      }
      __syncthreads();
      const int c0 = static_cast<int>(ok) + lane;
      const T x0 = c0 < n ? __ldcg(x + c0) : T(0);
      const T x1 = c0 + 32 < n ? __ldcg(x + c0 + 32) : T(0);
#pragma unroll
      for (int q = 0; q < kB / 8; ++q) {
        const T sum = dense_tile::warp_sum(u[q][0] * x0 + u[q][1] * x1);
        if (lane == 0) vec[warp + 8 * q] -= sum;
      }
    }
    __syncthreads();
    if (tid < kB) {   // x_i = U_ii^-1 vec
      T acc = T(0);
#pragma unroll 8
      for (int c = 0; c < kB; ++c) acc += Ui[c * kLdI + tid] * vec[c];
      if (static_cast<int>(oi) + tid < n) x[oi + tid] = acc;
      __threadfence();
    }
    __syncthreads();
    if (tid == 0) atomicExch(flags + i, 1);
    __syncthreads();
  }
}

template <typename T>
int launch(const void* S, const void* b, void* A, void* yz, void* x,
           void* flags, int n, void* stream) {
  if (n < 1 || n > 46340) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_values<T>() * sizeof(T);
  void* args[] = {&S, &b, &A, &yz, &x, &flags, &n};
  // a block on every SM: launch_cooperative caps the grid at the SM count
  return dense_tile::launch_cooperative(spd_solve_blocked_kernel<T>, INT_MAX,
                                        kThreads, smem, args, stream);
}

}  // namespace

extern "C" int spd_solve_blocked_f32(const void* S, const void* b, void* A,
                                     void* yz, void* x, void* flags, int n,
                                     void* stream) {
  return launch<float>(S, b, A, yz, x, flags, n, stream);
}

extern "C" int spd_solve_blocked_f64(const void* S, const void* b, void* A,
                                     void* yz, void* x, void* flags, int n,
                                     void* stream) {
  return launch<double>(S, b, A, yz, x, flags, n, stream);
}
