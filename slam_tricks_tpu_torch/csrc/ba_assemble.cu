// Linearize + assemble of slot-major bundle adjustment, for Hopper (sm_90a).
//
// Replaces: slam_tricks_tpu/ops/pallas_ba.py::_kernel (called by
// linearize_assemble). It computes, term for term, what
// slam_tricks_tpu/solvers/schur_flat_sm.py::_linearize_sm and
// ::_quantities_sm compute, in their output layout:
//   Hpp (C, 21): upper-triangle terms of Jp^T Jp | gp (C, 6): Jp^T r
//   Hll (6, L):  upper-triangle terms of Jl^T Jl | gl (3, L): Jl^T r
//   W   (18, K, L): Jp^T Jl per slot, row i*3 + j | cost: 0.5 sum w |d|^2
// The inputs are slot-major: element n = k*L + l is slot k of landmark l.
// Padding slots have weight 0: every column is zero there, which the kernel
// writes without computing it.
// A robust loss (residuals/robust.py, passed as its code, parameter p and
// p^2) takes the IRLS form of _linearize_sm: with s = |d|^2, each slot's
// rows are scaled by sqrt(w weight(s)) and its cost is 0.5 w rho(s). A live
// slot that the loss gives weight 0 (Tukey, the chi-square gate) stays in
// the camera index and adds exact zeros.
//
// What bounds it on the H100: the bytes of W (18 values a slot, written
// once: 124 MB at the 1024-camera trajectory scene) and the camera-side
// sums, 28 values a live slot into only C rows; at small problems, the
// host's time a call. Three launches, none with a float atomic, so every
// launch returns the same bits:
//   1. landmark pass: a block is 32 landmarks (the lanes, so the slot-major
//      loads and W's stores are coalesced) by up to 8 slot groups (the
//      warps, which split a landmark's K slots between them); the 9
//      landmark sums are added across the groups in shared memory in group
//      order. The camera rows (R, t) are read through the read-only cache;
//      nothing is staged, so C is not bounded by shared memory.
//   2. camera pass: the live slots sorted by camera, cut into segments of
//      kSeg = 64 that never hold two cameras (ops/ba_assemble.py::
//      camera_index, whose SEGMENT is this kSeg, and which also gives each
//      segment's camera, so that the camera row's load waits on no other
//      load); a warp a segment loads its camera row once, recomputes each
//      slot's residual and pose Jacobian, two slots a lane, sums its 28
//      columns in registers, then across the lanes by a transposing
//      butterfly (31 shuffles for 32 columns), and writes one (28,) partial
//      a segment;
//   3. camera sums: a thread a (camera, column) adds that camera's partials
//      in segment order; the last block to finish (an integer count) adds
//      the cameras' costs in a fixed tree.
// The outputs are contiguous parts of one allocation, and the wrapper
// passes the device to switch to, which C does for less host time than
// Python.
// The recomputation in pass 2 costs about 28 gathered bytes and 180
// operations a live slot, far less than writing the 28 columns to memory
// and reading them back.
//
// The camera block's width P is a template parameter of every pass. P = 6
// is the calibrated pose above, on the normalized plane. P = 9 is BAL's
// camera (residuals/bal.py): [omega, dt, df, dk1, dk2], a camera row of R,
// t and (f, k1, k2) read from `intr`, and the pixel residual
// f (1 + k1 r^2 + k2 r^4) x - uv with x = p.xy / p.z: Hpp (C, 45),
// gp (C, 9), W (27, K, L), 55 camera columns summed by two butterflies.
// Every entry also takes the landmark sums' row stride, so that several
// grids (track-length buckets) write their landmarks into one (6, L) and
// one (3, L), and an `accumulate` flag, which P = 9 reads: the camera sums
// and the cost are then added to those of the grids before (kept in double
// in the scratch), so that the grids of one problem, launched one after
// another on one stream, sum in launch order. P = 9 computes the projection and the
// residual, and adds the camera side's products, in double whatever T: a
// residual of a pixel is the difference of two numbers of some hundreds,
// and a camera's gradient the small sum of thousands of large terms.

#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

namespace {

constexpr int kLanes = 32;
constexpr int kSeg = 2 * kLanes;  // slots of a camera-pass segment: two a lane
constexpr int kMaxGroups = 8;     // slot groups (warps) of a landmark block
constexpr int kSegWarps = 4;      // segments (warps) of a camera-pass block
constexpr int kSumThreads = 256;  // threads of a camera-sums block
constexpr int kLmCols = 9;

// the camera block of width P: Hpp's upper-triangle terms, then the camera
// row's values (R, t, and for P = 9 f, k1, k2), the camera columns a slot
// adds (Hpp, gp, cost) and the registers that hold them (whole warps)
template <int P>
struct Width {
  static constexpr int kHpp = P * (P + 1) / 2;
  static constexpr int kRow = P == 6 ? 12 : 15;
  static constexpr int kCamCols = kHpp + P + 1;
  static constexpr int kRegs = (kCamCols + kLanes - 1) / kLanes * kLanes;
};

// the camera side's sums: P = 9 adds its products in double, whatever T, and
// rounds the camera sums to T once (a BAL camera's gradient is the small
// difference of large terms, and float sums of thousands of slots would
// lose it); P = 6 in T, as it always has
template <typename T, int P>
using AccT = std::conditional_t<P == 9, double, T>;

template <typename T>
__device__ __forceinline__ T dot2(T a0, T a1, T b0, T b1) {
  return a0 * b0 + a1 * b1;
}

// residuals/robust.py's KINDS
enum LossKind { kTrivial = 0, kHuber = 1, kCauchy = 2, kTukey = 3, kGate = 4 };

template <typename T>
struct Loss {
  int kind;
  T p;    // huber's delta, cauchy's and tukey's c, the gate's threshold
  T p2;   // p^2, rounded from double
};

// weight(s) = rho'(s) and rho(s) of robust.py, branch-free
template <typename T>
__device__ __forceinline__ void robust(const Loss<T>& loss, T s, T* weight,
                                       T* rho) {
  const bool in = s <= loss.p2;
  switch (loss.kind) {
    case kHuber: {
      const T r = sqrt(in ? loss.p2 : s);
      *weight = in ? T(1) : loss.p / r;
      *rho = in ? s : T(2) * loss.p * r - loss.p2;
      break;
    }
    case kCauchy: {
      const T q = s / loss.p2;
      *weight = T(1) / (T(1) + q);
      *rho = loss.p2 * log1p(q);
      break;
    }
    case kTukey: {
      const T q = T(1) - s / loss.p2;
      *weight = in ? q * q : T(0);
      *rho = loss.p2 / T(3) * (in ? T(1) - q * q * q : T(1));
      break;
    }
    case kGate: {
      const bool keep = s <= loss.p;
      *weight = keep ? T(1) : T(0);
      *rho = keep ? s : loss.p;
      break;
    }
    default:
      *weight = T(1);
      *rho = s;
  }
}

// R row-major (9) | t (3) | for P = 9 f, k1, k2 (3) of camera c, through
// the read-only cache
template <int P, typename T>
__device__ __forceinline__ void load_camera(const T* __restrict__ R_flat,
                                            const T* __restrict__ t,
                                            const T* __restrict__ intr, int c,
                                            T (&cam)[Width<P>::kRow]) {
  const size_t c9 = static_cast<size_t>(c) * 9, c3 = static_cast<size_t>(c) * 3;
#pragma unroll
  for (int q = 0; q < 9; ++q) cam[q] = __ldg(R_flat + c9 + q);
#pragma unroll
  for (int q = 0; q < 3; ++q) cam[9 + q] = __ldg(t + c3 + q);
  if constexpr (P == 9) {
#pragma unroll
    for (int q = 0; q < 3; ++q) cam[12 + q] = __ldg(intr + c3 + q);
  }
}

// One live slot, sqrt-weighted: residual rows, camera and point Jacobian rows
template <typename T, int P>
struct SlotLin {
  T jp0[P], jp1[P];
  T jl0[3], jl1[3];
  T r0, r1, cost;
};

// the slot's square root of its weight and its cost, from s = |d|^2
template <typename T>
__device__ __forceinline__ T weigh(T wk, T s, const Loss<T>& loss, T* cost) {
  if (loss.kind == kTrivial) {
    *cost = T(0.5) * wk * s;
    return sqrt(wk);
  }
  T weight, rho;
  robust(loss, s, &weight, &rho);
  *cost = T(0.5) * wk * rho;
  return sqrt(wk * weight);
}

// the rotation's columns of the pose Jacobian from the point's rows: the
// right perturbation R exp(omega) moves p by -R [X]x omega
template <typename T, int P>
__device__ __forceinline__ void rotation_columns(SlotLin<T, P>& o, T px, T py,
                                                 T pz) {
  o.jp0[0] = o.jl0[2] * py - o.jl0[1] * pz;
  o.jp0[1] = o.jl0[0] * pz - o.jl0[2] * px;
  o.jp0[2] = o.jl0[1] * px - o.jl0[0] * py;
  o.jp1[0] = o.jl1[2] * py - o.jl1[1] * pz;
  o.jp1[1] = o.jl1[0] * pz - o.jl1[2] * px;
  o.jp1[2] = o.jl1[1] * px - o.jl1[0] * py;
}

// the calibrated pose: the normalized-plane residual
template <typename T>
__device__ __forceinline__ SlotLin<T, 6> linearize6(const T (&r)[12], T px,
                                                    T py, T pz, T wk, T obs_u,
                                                    T obs_v,
                                                    const Loss<T>& loss) {
  SlotLin<T, 6> o;
  const T x = r[0] * px + r[1] * py + r[2] * pz + r[9];
  const T y = r[3] * px + r[4] * py + r[5] * pz + r[10];
  const T z = r[6] * px + r[7] * py + r[8] * pz + r[11];
  const T iz = T(1) / z;
  const T u = x * iz;
  const T v = y * iz;
  const T d0 = u - obs_u;
  const T d1 = v - obs_v;
  const T sw = weigh(wk, d0 * d0 + d1 * d1, loss, &o.cost);
  o.r0 = d0 * sw;
  o.r1 = d1 * sw;
  const T sziz = sw * iz;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    o.jl0[j] = (r[j] - u * r[6 + j]) * sziz;
    o.jl1[j] = (r[3 + j] - v * r[6 + j]) * sziz;
  }
  rotation_columns(o, px, py, pz);
  o.jp0[3] = sziz;
  o.jp0[4] = T(0);
  o.jp0[5] = -u * sziz;
  o.jp1[3] = T(0);
  o.jp1[4] = sziz;
  o.jp1[5] = -v * sziz;
  return o;
}

// BAL's camera: uv = f (1 + k1 r2 + k2 r2^2) x, x = p.xy / p.z, r2 = |x|^2;
// d(uv)/dx = s I + g x x^T with s = f a, g = 2 f (k1 + 2 k2 r2)
template <typename T>
__device__ __forceinline__ SlotLin<T, 9> linearize9(const T (&r)[15], T px,
                                                    T py, T pz, T wk, T obs_u,
                                                    T obs_v,
                                                    const Loss<T>& loss) {
  SlotLin<T, 9> o;
  // the projection and the residual in double, rounded to T after
  using D = double;
  const D x = D(r[0]) * px + D(r[1]) * py + D(r[2]) * pz + D(r[9]);
  const D y = D(r[3]) * px + D(r[4]) * py + D(r[5]) * pz + D(r[10]);
  const D z = D(r[6]) * px + D(r[7]) * py + D(r[8]) * pz + D(r[11]);
  const D izd = D(1) / z;
  const D ud = x * izd;
  const D vd = y * izd;
  const D r2d = ud * ud + vd * vd;
  const D ad = D(1) + r2d * (D(r[13]) + D(r[14]) * r2d);
  const D sd = D(r[12]) * ad;
  const T d0 = T(sd * ud - D(obs_u));
  const T d1 = T(sd * vd - D(obs_v));
  const T f = r[12], k1 = r[13], k2 = r[14];
  const T iz = T(izd), u = T(ud), v = T(vd), r2 = T(r2d), a = T(ad);
  const T s = T(sd);
  const T sw = weigh(wk, d0 * d0 + d1 * d1, loss, &o.cost);
  o.r0 = d0 * sw;
  o.r1 = d1 * sw;
  const T g = T(2) * f * (k1 + T(2) * k2 * r2);
  const T gu = g * u, gv = g * v;
  const T m00 = (s + gu * u) * sw * iz;
  const T m01 = gu * v * sw * iz;
  const T m11 = (s + gv * v) * sw * iz;
  // d(uv)/dp, sqrt-weighted: the translation's columns
  const T j02 = -(m00 * u + m01 * v);
  const T j12 = -(m01 * u + m11 * v);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    o.jl0[j] = m00 * r[j] + m01 * r[3 + j] + j02 * r[6 + j];
    o.jl1[j] = m01 * r[j] + m11 * r[3 + j] + j12 * r[6 + j];
  }
  rotation_columns(o, px, py, pz);
  o.jp0[3] = m00;
  o.jp0[4] = m01;
  o.jp0[5] = j02;
  o.jp1[3] = m01;
  o.jp1[4] = m11;
  o.jp1[5] = j12;
  const T su = sw * u, sv = sw * v;
  const T fr2 = f * r2;
  o.jp0[6] = a * su;
  o.jp1[6] = a * sv;
  o.jp0[7] = fr2 * su;
  o.jp1[7] = fr2 * sv;
  o.jp0[8] = fr2 * r2 * su;
  o.jp1[8] = fr2 * r2 * sv;
  return o;
}

template <int P, typename T>
__device__ __forceinline__ SlotLin<T, P> linearize(
    const T (&r)[Width<P>::kRow], T px, T py, T pz, T wk, T obs_u, T obs_v,
    const Loss<T>& loss) {
  if constexpr (P == 6) {
    return linearize6(r, px, py, pz, wk, obs_u, obs_v, loss);
  } else {
    return linearize9(r, px, py, pz, wk, obs_u, obs_v, loss);
  }
}

// W, Hll and gl. Block (32 landmarks, G slot groups); group g walks slots
// k = g, g + G, ...; Hll and gl rows are lm_stride apart
template <typename T, int P>
__global__ void __launch_bounds__(kLanes * kMaxGroups)
landmark_pass(const T* __restrict__ R_flat, const T* __restrict__ t,
              const T* __restrict__ intr,
              const T* __restrict__ points, const T* __restrict__ uv0,
              const T* __restrict__ uv1, const T* __restrict__ w,
              const int* __restrict__ cam, int K, int L, int lm_stride,
              Loss<T> loss, T* __restrict__ Hll, T* __restrict__ gl,
              T* __restrict__ W, unsigned* __restrict__ sums_done) {
  __shared__ T part[kMaxGroups][kLmCols][kLanes];
  const int lane = threadIdx.x, g = threadIdx.y, G = blockDim.y;
  const int l = blockIdx.x * kLanes + lane;
  // camera_sums' count of finished blocks, which runs after this launch
  if (blockIdx.x == 0 && lane == 0 && g == 0) *sums_done = 0;
  T acc[kLmCols];
#pragma unroll
  for (int q = 0; q < kLmCols; ++q) acc[q] = T(0);

  if (l < L) {
    const T px = __ldg(points + static_cast<size_t>(l) * 3 + 0);
    const T py = __ldg(points + static_cast<size_t>(l) * 3 + 1);
    const T pz = __ldg(points + static_cast<size_t>(l) * 3 + 2);
    const size_t KL = static_cast<size_t>(K) * L;
    for (int k = g; k < K; k += G) {
      const size_t n = static_cast<size_t>(k) * L + l;
      const T wk = w[n];
      if (!(wk > T(0))) {
#pragma unroll
        for (int q = 0; q < 3 * P; ++q) W[q * KL + n] = T(0);
        continue;
      }
      T r[Width<P>::kRow];
      load_camera<P>(R_flat, t, intr, cam[n], r);
      const SlotLin<T, P> o =
          linearize<P>(r, px, py, pz, wk, uv0[n], uv1[n], loss);
#pragma unroll
      for (int i = 0; i < P; ++i) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          W[(i * 3 + j) * KL + n] = dot2(o.jp0[i], o.jp1[i], o.jl0[j], o.jl1[j]);
        }
      }
      int q = 0;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = i; j < 3; ++j) {
          acc[q] += dot2(o.jl0[i], o.jl1[i], o.jl0[j], o.jl1[j]);
          ++q;
        }
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) acc[6 + i] += dot2(o.jl0[i], o.jl1[i], o.r0, o.r1);
    }
  }

#pragma unroll
  for (int q = 0; q < kLmCols; ++q) part[g][q][lane] = acc[q];
  __syncthreads();
  if (l < L) {
    for (int q = g; q < kLmCols; q += G) {
      T s = part[0][q][lane];
      for (int h = 1; h < G; ++h) s += part[h][q][lane];
      if (q < 6) {
        Hll[static_cast<size_t>(q) * lm_stride + l] = s;
      } else {
        gl[static_cast<size_t>(q - 6) * lm_stride + l] = s;
      }
    }
  }
}

// One step of the transposing butterfly: the lanes whose bit OFF is clear
// keep columns [0, OFF) of v and add their partner's, the others keep
// [OFF, 2 OFF) moved down to [0, OFF).
template <int OFF, typename T>
__device__ __forceinline__ void fold(T* v, bool upper) {
#pragma unroll
  for (int j = 0; j < OFF; ++j) {
    const T send = upper ? v[j] : v[j + OFF];
    const T keep = upper ? v[j + OFF] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
  }
}

// Sums 32 columns v[0, 32) over the lanes of a warp in a fixed order:
// returns, in lane i, the sum of column i.
template <typename T>
__device__ __forceinline__ T warp_column_sums(T* v) {
  const int lane = threadIdx.x & (kLanes - 1);
  fold<16>(v, lane & 16);
  fold<8>(v, lane & 8);
  fold<4>(v, lane & 4);
  fold<2>(v, lane & 2);
  fold<1>(v, lane & 1);
  return v[0];
}

// Adds slot id's camera columns to v; a pad (id < 0) adds zeros.
template <int P, typename T>
__device__ __forceinline__ void add_camera_columns(
    const T (&r)[Width<P>::kRow], const T* __restrict__ points,
    const T* __restrict__ uv0, const T* __restrict__ uv1,
    const T* __restrict__ w, int L, const Loss<T>& loss, int first, int id,
    AccT<T, P> (&v)[Width<P>::kRegs]) {
  using Acc = AccT<T, P>;
  const int n = id < 0 ? first : id;
  const int l = n % L;
  const T px = __ldg(points + static_cast<size_t>(l) * 3 + 0);
  const T py = __ldg(points + static_cast<size_t>(l) * 3 + 1);
  const T pz = __ldg(points + static_cast<size_t>(l) * 3 + 2);
  const T wk = id < 0 ? T(0) : w[n];
  const SlotLin<T, P> o = linearize<P>(r, px, py, pz, wk, uv0[n], uv1[n], loss);
  int q = 0;
#pragma unroll
  for (int a = 0; a < P; ++a) {
#pragma unroll
    for (int b = a; b < P; ++b) {
      v[q] += dot2(Acc(o.jp0[a]), Acc(o.jp1[a]), Acc(o.jp0[b]),
                   Acc(o.jp1[b]));
      ++q;
    }
  }
#pragma unroll
  for (int a = 0; a < P; ++a) {
    v[Width<P>::kHpp + a] += dot2(Acc(o.jp0[a]), Acc(o.jp1[a]), Acc(o.r0),
                                  Acc(o.r1));
  }
  v[Width<P>::kHpp + P] += Acc(o.cost);
}

// Per-segment partial camera sums: a warp a segment of kSeg slot ids.
template <typename T, int P>
__global__ void __launch_bounds__(kLanes * kSegWarps)
camera_pass(const T* __restrict__ R_flat, const T* __restrict__ t,
            const T* __restrict__ intr,
            const T* __restrict__ points, const T* __restrict__ uv0,
            const T* __restrict__ uv1, const T* __restrict__ w,
            int L, Loss<T> loss, const int* __restrict__ slots,
            const int* __restrict__ seg_cam, int n_seg,
            AccT<T, P>* __restrict__ partial) {
  using Wd = Width<P>;
  using Acc = AccT<T, P>;
  const int lane = threadIdx.x & (kLanes - 1);
  const int s = blockIdx.x * kSegWarps + threadIdx.x / kLanes;
  if (s >= n_seg) return;   // the whole warp
  const int* seg_slots = slots + static_cast<size_t>(s) * kSeg;
  T r[Wd::kRow];
  load_camera<P>(R_flat, t, intr, seg_cam[s], r);
  const int first = seg_slots[0];   // a segment starts with a live slot

  Acc v[Wd::kRegs];
#pragma unroll
  for (int q = 0; q < Wd::kRegs; ++q) v[q] = Acc(0);
  // two slots a lane, with no branch, so that the second's gathers overlap
  // the first's arithmetic: a pad (-1) recomputes the segment's first slot
  // with weight 0, which adds exact zeros
  const int ida = seg_slots[lane];
  const int idb = seg_slots[lane + kLanes];
  add_camera_columns<P>(r, points, uv0, uv1, w, L, loss, first, ida, v);
  add_camera_columns<P>(r, points, uv0, uv1, w, L, loss, first, idb, v);
  // 32 columns a butterfly
#pragma unroll
  for (int b = 0; b < Wd::kRegs; b += kLanes) {
    const Acc total = warp_column_sums(v + b);
    if (b + lane < Wd::kCamCols) {
      partial[static_cast<size_t>(s) * Wd::kCamCols + b + lane] = total;
    }
  }
}

// Column q of camera c = the sum of camera c's partials, in segment order,
// into Hpp, gp or the camera's cost; then the last block to finish adds
// the cameras' costs into cost, a thread a stride of cameras and a tree
// over the block. P = 6: cam_acc is each camera's cost (C,). P = 9: cam_acc
// (C, 55) holds every camera sum in double, which, where accumulate, the
// grid's partials are added to (Hpp and gp get it rounded, and cost the
// sum of its cost column)
template <typename T, int P>
__global__ void __launch_bounds__(kSumThreads)
camera_sums(const AccT<T, P>* __restrict__ partial,
            const int* __restrict__ seg_start, int C, int accumulate,
            T* __restrict__ Hpp, T* __restrict__ gp,
            AccT<T, P>* __restrict__ cam_acc, unsigned* __restrict__ done,
            T* __restrict__ cost) {
  using Wd = Width<P>;
  using Acc = AccT<T, P>;
  __shared__ Acc part[kSumThreads];
  __shared__ bool last;
  const size_t i = static_cast<size_t>(blockIdx.x) * kSumThreads + threadIdx.x;
  if (i < static_cast<size_t>(C) * Wd::kCamCols) {
    const int c = static_cast<int>(i / Wd::kCamCols);
    const int q = static_cast<int>(i - static_cast<size_t>(c) * Wd::kCamCols);
    const int end = seg_start[c + 1];
    Acc acc = Acc(0);
    if constexpr (P == 9) {
      if (accumulate) acc = cam_acc[i];
    }
#pragma unroll 4
    for (int s = seg_start[c]; s < end; ++s) {
      acc += partial[static_cast<size_t>(s) * Wd::kCamCols + q];
    }
    if constexpr (P == 9) cam_acc[i] = acc;
    if (q < Wd::kHpp) {
      Hpp[static_cast<size_t>(c) * Wd::kHpp + q] = T(acc);
    } else if (q < Wd::kHpp + P) {
      gp[static_cast<size_t>(c) * P + q - Wd::kHpp] = T(acc);
    } else if constexpr (P == 6) {
      cam_acc[c] = acc;
    }
  }
  __threadfence();   // this block's camera costs, seen before its count
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  Acc acc = Acc(0);
  for (int c = threadIdx.x; c < C; c += kSumThreads) {
    acc += __ldcg(cam_acc + (P == 9 ? static_cast<size_t>(c) * Wd::kCamCols +
                                          Wd::kCamCols - 1
                                    : static_cast<size_t>(c)));
  }
  part[threadIdx.x] = acc;
  __syncthreads();
#pragma unroll
  for (int half = kSumThreads / 2; half > 0; half /= 2) {
    if (threadIdx.x < half) part[threadIdx.x] += part[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) *cost = T(part[0]);
}

template <typename T, int P>
int launch(const void* R_flat_, const void* t_, const void* intr_,
           const void* points_, const void* uv0_, const void* uv1_,
           const void* w_, const void* cam_, const void* slots_,
           const void* seg_cam_, const void* seg_start_, int n_seg, int C,
           int K, int L, int lm_stride, int accumulate, Loss<T> loss,
           void* Hpp, void* gp, void* Hll, void* gl, void* W, void* cost,
           void* scratch, void* stream_) {
  using Wd = Width<P>;
  using Acc = AccT<T, P>;
  const T* R_flat = static_cast<const T*>(R_flat_);
  const T* t = static_cast<const T*>(t_);
  const T* intr = static_cast<const T*>(intr_);
  const T* points = static_cast<const T*>(points_);
  const T* uv0 = static_cast<const T*>(uv0_);
  const T* uv1 = static_cast<const T*>(uv1_);
  const T* w = static_cast<const T*>(w_);
  const int* cam = static_cast<const int*>(cam_);
  // P = 6: the partials (n_seg, cols), the cameras' costs (C,), the count;
  // P = 9: every camera sum (C, cols) first, where each grid of a problem
  // finds the ones before it left them, then the partials and the count
  Acc* partial;
  Acc* cam_acc;
  unsigned* sums_done;
  if constexpr (P == 9) {
    cam_acc = static_cast<Acc*>(scratch);
    partial = cam_acc + static_cast<size_t>(C) * Wd::kCamCols;
    sums_done = reinterpret_cast<unsigned*>(
        partial + static_cast<size_t>(n_seg) * Wd::kCamCols);
  } else {
    partial = static_cast<Acc*>(scratch);
    cam_acc = partial + static_cast<size_t>(n_seg) * Wd::kCamCols;
    sums_done = reinterpret_cast<unsigned*>(cam_acc + C);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);

  const int groups = K < kMaxGroups ? K : kMaxGroups;
  landmark_pass<T, P><<<(L + kLanes - 1) / kLanes, dim3(kLanes, groups), 0,
                        stream>>>(R_flat, t, intr, points, uv0, uv1, w, cam,
                                  K, L, lm_stride, loss, static_cast<T*>(Hll),
                                  static_cast<T*>(gl), static_cast<T*>(W),
                                  sums_done);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_seg > 0) {
    camera_pass<T, P><<<(n_seg + kSegWarps - 1) / kSegWarps,
                        kLanes * kSegWarps, 0, stream>>>(
        R_flat, t, intr, points, uv0, uv1, w, L, loss,
        static_cast<const int*>(slots_), static_cast<const int*>(seg_cam_),
        n_seg, partial);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t sums = static_cast<size_t>(C) * Wd::kCamCols;
  camera_sums<T, P><<<static_cast<unsigned>((sums + kSumThreads - 1) /
                                            kSumThreads),
                      kSumThreads, 0, stream>>>(
      partial, static_cast<const int*>(seg_start_), C, accumulate,
      static_cast<T*>(Hpp), static_cast<T*>(gp), cam_acc, sums_done,
      static_cast<T*>(cost));
  return static_cast<int>(cudaGetLastError());
}

// launch<T, P> on CUDA device `device`, the caller's current device
// restored after (a switch costs the host far less here than in Python)
template <typename T, int P>
int launch_on(int device, const void* R_flat, const void* t, const void* intr,
              const void* points, const void* uv0, const void* uv1,
              const void* w, const void* cam, const void* slots,
              const void* seg_cam, const void* seg_start, int n_seg, int C,
              int K, int L, int lm_stride, int accumulate, int loss_kind,
              double loss_p, double loss_p2, void* Hpp, void* gp, void* Hll,
              void* gl, void* W, void* cost, void* scratch, void* stream) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Loss<T> loss{loss_kind, static_cast<T>(loss_p),
                     static_cast<T>(loss_p2)};
  const int rc = launch<T, P>(R_flat, t, intr, points, uv0, uv1, w, cam,
                              slots, seg_cam, seg_start, n_seg, C, K, L,
                              lm_stride, accumulate, loss, Hpp, gp, Hll, gl,
                              W, cost, scratch, stream);
  if (prev != device) {
    err = cudaSetDevice(prev);
    if (rc == 0 && err != cudaSuccess) return static_cast<int>(err);
  }
  return rc;
}

}  // namespace

// The entries, one a width and dtype, all of one signature: intr (C, 3)
// holds f, k1, k2 at P = 9 (unread at P = 6); Hll and gl rows lm_stride
// apart; with accumulate (P = 9), Hpp, gp and cost are added to those of
// the grids launched before
#define BA_ASSEMBLE_ENTRY(NAME, T, P)                                        \
  extern "C" int NAME(const void* R_flat, const void* t, const void* intr,   \
                      const void* points, const void* uv0, const void* uv1, \
                      const void* w, const void* cam, const void* slots,    \
                      const void* seg_cam, const void* seg_start, int n_seg,\
                      int C, int K, int L, int lm_stride, int accumulate,   \
                      int loss_kind, double loss_p, double loss_p2,         \
                      void* Hpp, void* gp, void* Hll, void* gl, void* W,    \
                      void* cost, void* scratch, int device, void* stream) {\
    return launch_on<T, P>(device, R_flat, t, intr, points, uv0, uv1, w,    \
                           cam, slots, seg_cam, seg_start, n_seg, C, K, L,  \
                           lm_stride, accumulate, loss_kind, loss_p,        \
                           loss_p2, Hpp, gp, Hll, gl, W, cost, scratch,     \
                           stream);                                         \
  }

BA_ASSEMBLE_ENTRY(ba_assemble_f32, float, 6)
BA_ASSEMBLE_ENTRY(ba_assemble_f64, double, 6)
BA_ASSEMBLE_ENTRY(ba_assemble9_f32, float, 9)
BA_ASSEMBLE_ENTRY(ba_assemble9_f64, double, 9)
