// Newton undistortion of pixels under the radial-tangential (Brown-Conrady)
// model, for Hopper (sm_90a).
//
// Replaces: slam_tricks_tpu/ops/pallas_undistort.py::_undistort_kernel
// (called by undistort_points_pallas). Same function as it and
// slam_tricks_tpu/residuals/camera.py::undistort_points_fast: normalize
// (u0, v0) = ((px - cx) / fx, (py - cy) / fy), then `iters` Newton steps on
// distort(u, v) = (u0, v0) with the analytic 2x2 Jacobian and its
// closed-form inverse, then back to pixels.
//
// What bounds it on the H100: both of its bounds, and they are nearly
// equal. 8,388,608 f32 pixels read and written once are 134 MB, 40.1 us at
// 3.35 TB/s; 5 Newton steps of 62 operations and 8 more a pixel are
// 2.67 GFLOP, 39.8 us at 67 TFLOP/s, a rate that counts an FFMA as two. So
// the kernel has to stream at near the memory rate while it issues about
// one instruction for each two operations.
// What the design does about each:
// - operations: the constants of a call (1/fx, 1/fy, 2 k1, 4 k2, 6 k3,
//   2 p1, 2 p2, 4 p1, 4 p2) are worked out once on the host. A step forms
//   u^2, v^2, u v and r^2 once, the radial polynomial and its derivative by
//   Horner, and the residual, the Jacobian and its determinant as fused
//   multiply-adds around one shared term: 31 instructions for the 62
//   operations. It takes 1/det from the SFU (rcp.approx.ftz, relative error
//   <= 2^-22). That error only scales a step by (1 + e): the residual that
//   fixes the root is computed as before, so Newton converges to the same
//   point. There is no fast-math flag: the build's flags are shared by
//   every source, so the approximation stays in this one intrinsic, and the
//   f64 instance keeps a correctly rounded division. Normalizing is
//   (p - c) (1/f), a subtraction and a product, not one FFMA p (1/f) - c/f:
//   that sum cancels terms of up to ~1.5 down to |u0| < 0.8, so u0 carries
//   up to twice the rounding error. Measured on an H100 over 2^31 + 5
//   pixels, the FFMA took |kernel - plain| to 2.75e-4 px, past the
//   2.5e-4 px (~4 ulp at 700 px) that the kernel is held to.
// - bytes: one block a tile of kTile 16-byte vectors (float4: two f32
//   pixels; double2: one f64 pixel), kVecs a thread, neighbouring threads
//   on neighbouring vectors, read and written once by the streaming path
//   (ld.global.cs / st.global.cs, evict-first: 134 MB does not fit the
//   50 MB L2). The Newton chains of a thread's pixels interleave.
//   A pointer 8 mod 16 (f32) leaves a head pixel before the first vector,
//   and an odd count a tail pixel: thread 0 takes both, so nothing is
//   padded or copied. An output whose 16-byte phase differs from the
//   input's is stored a pixel (8 bytes) at a time.
// - the count: 64 bits end to end (entry point, tiles, indices).
// kThreads and kVecs are the fastest of the candidates that
// tools/undistort_designs.py times.

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 128;     // threads a block
constexpr int kVecs = 8;          // 16-byte vectors a thread
constexpr int kTile = kThreads * kVecs;   // vectors a block

template <typename T>
struct Pair;
template <>
struct Pair<float> { using type = float2; };
template <>
struct Pair<double> { using type = double2; };

// the 16-byte vector of pixels a thread loads and stores
template <typename T>
struct Vec;
template <>
struct Vec<float> { using type = float4; static constexpr int kPix = 2; };
template <>
struct Vec<double> { using type = double2; static constexpr int kPix = 1; };

// the constants of a call, worked out on the host in double
template <typename T>
struct Consts {
  T fx, fy, cx, cy, rfx, rfy;       // intrinsics, 1/fx, 1/fy
  T k1, k2, k3, k1x2, k2x4, k3x6;   // radial; 2 d(radial)/d(r^2) by Horner
  T p1, p2, p1x2, p2x2, p1x4, p2x4; // tangential
};

__device__ __forceinline__ float fma_(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
__device__ __forceinline__ float recip(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ double recip(double x) { return 1.0 / x; }

__device__ __forceinline__ void unpack(const float2& q, float* x, float* y) {
  x[0] = q.x;
  y[0] = q.y;
}
__device__ __forceinline__ void unpack(const double2& q, double* x,
                                       double* y) {
  x[0] = q.x;
  y[0] = q.y;
}
__device__ __forceinline__ void unpack(const float4& q, float* x, float* y) {
  x[0] = q.x;
  y[0] = q.y;
  x[1] = q.z;
  y[1] = q.w;
}
__device__ __forceinline__ void pack(float2& q, const float* x,
                                     const float* y) {
  q = make_float2(x[0], y[0]);
}
__device__ __forceinline__ void pack(double2& q, const double* x,
                                     const double* y) {
  q = make_double2(x[0], y[0]);
}
__device__ __forceinline__ void pack(float4& q, const float* x,
                                     const float* y) {
  q = make_float4(x[0], y[0], x[1], y[1]);
}

// One Newton step for one pixel: 31 instructions in f32 (4 for u^2, v^2,
// u v, r^2; 3 + 2 for the radial polynomial and its derivative; 2 for
// rt = radial + 2 p1 v + 2 p2 u, which the residual and the Jacobian share;
// 2 + 2 for the residual; 2 + 3 + 2 for the Jacobian; 2 for the determinant
// and 1 reciprocal; 3 + 3 for the update).
template <typename T>
__device__ __forceinline__ void newton_step(T& u, T& v, T u0, T v0,
                                            const Consts<T>& c) {
  const T uu = u * u, vv = v * v, uv = u * v;
  const T r2 = fma_(u, u, vv);
  const T radial = fma_(r2, fma_(r2, fma_(r2, c.k3, c.k2), c.k1), T(1));
  const T dr2 = fma_(r2, fma_(r2, c.k3x6, c.k2x4), c.k1x2);
  const T rt = fma_(c.p1x2, v, fma_(c.p2x2, u, radial));
  // residual distort(u, v) - (u0, v0): u rt + p2 r^2 - u0, v rt + p1 r^2 - v0
  const T fu = fma_(u, rt, fma_(c.p2, r2, -u0));
  const T fv = fma_(v, rt, fma_(c.p1, r2, -v0));
  // Jacobian [[a, b], [b, d]]
  const T a = fma_(uu, dr2, fma_(c.p2x4, u, rt));
  const T b = fma_(uv, dr2, fma_(c.p1x2, u, c.p2x2 * v));
  const T d = fma_(vv, dr2, fma_(c.p1x4, v, rt));
  const T inv_det = recip(fma_(a, d, -(b * b)));
  u = fma_(-inv_det, fma_(d, fu, -(b * fv)), u);
  v = fma_(-inv_det, fma_(a, fv, -(b * fu)), v);
}

// P distorted pixels (x, y) -> undistorted, in place; the P Newton chains
// are independent, so their instructions interleave
template <typename T, int P>
__device__ __forceinline__ void undistort_pixels(T (&x)[P], T (&y)[P],
                                                 const Consts<T>& c,
                                                 int iters) {
  T u0[P], v0[P], u[P], v[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    u0[p] = u[p] = (x[p] - c.cx) * c.rfx;
    v0[p] = v[p] = (y[p] - c.cy) * c.rfy;
  }
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int p = 0; p < P; ++p) newton_step(u[p], v[p], u0[p], v0[p], c);
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    x[p] = fma_(c.fx, u[p], c.cx);
    y[p] = fma_(c.fy, v[p], c.cy);
  }
}

template <typename T>
__device__ void undistort_one(const typename Pair<T>::type* __restrict__ in,
                              typename Pair<T>::type* __restrict__ out,
                              long long i, const Consts<T>& c, int iters) {
  T x[1], y[1];
  unpack(__ldcs(in + i), x, y);
  undistort_pixels(x, y, c, iters);
  typename Pair<T>::type q;
  pack(q, x, y);
  __stcs(out + i, q);
}

// Pixels [0, head) and [head + W nvec, n) lie outside the vectors (at most
// W - 1 on each side): thread 0 of block 0 takes them, one at a time.
template <typename T>
__device__ void undistort_edges(const typename Pair<T>::type* __restrict__ in,
                                typename Pair<T>::type* __restrict__ out,
                                long long n, int head, long long nvec,
                                const Consts<T>& c, int iters) {
  for (long long i = 0; i < head; ++i) undistort_one(in, out, i, c, iters);
  for (long long i = head + nvec * Vec<T>::kPix; i < n; ++i)
    undistort_one(in, out, i, c, iters);
}

// One block a tile of kTile vectors: thread t takes vectors t, t + kThreads,
// ... of its block's tile (neighbouring threads on neighbouring vectors),
// the last tile masked.
template <typename T>
__global__ void __launch_bounds__(kThreads)
undistort_kernel(const typename Pair<T>::type* __restrict__ in,
                 typename Pair<T>::type* __restrict__ out, long long n,
                 int head, long long nvec, bool out_vec, Consts<T> c,
                 int iters) {
  using V = typename Vec<T>::type;
  constexpr int W = Vec<T>::kPix;
  constexpr int P = kVecs * W;
  if (blockIdx.x == 0 && threadIdx.x == 0)
    undistort_edges(in, out, n, head, nvec, c, iters);
  const long long first = static_cast<long long>(blockIdx.x) * kTile;
  const long long left = nvec - first;
  const int live = left < kTile ? static_cast<int>(left) : kTile;
  const V* __restrict__ src =
      reinterpret_cast<const V*>(in + head) + first + threadIdx.x;
  T x[P], y[P];
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    V q{};
    if (j * kThreads + static_cast<int>(threadIdx.x) < live)
      q = __ldcs(src + j * kThreads);
    unpack(q, x + j * W, y + j * W);
  }
  undistort_pixels(x, y, c, iters);
  if (out_vec) {
    V* __restrict__ dst =
        reinterpret_cast<V*>(out + head) + first + threadIdx.x;
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      if (j * kThreads + static_cast<int>(threadIdx.x) >= live) break;
      V q;
      pack(q, x + j * W, y + j * W);
      __stcs(dst + j * kThreads, q);
    }
  } else {    // the output's 16-byte phase differs from the input's
    typename Pair<T>::type* __restrict__ dst =
        out + head + (first + threadIdx.x) * W;
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      if (j * kThreads + static_cast<int>(threadIdx.x) >= live) break;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        typename Pair<T>::type q;
        pack(q, x + j * W + w, y + j * W + w);
        __stcs(dst + j * kThreads * W + w, q);
      }
    }
  }
}

template <typename T>
int launch(const void* px, void* out, long long n, const Consts<T>& c,
           int iters, cudaStream_t stream) {
  constexpr int W = Vec<T>::kPix;
  constexpr uintptr_t kPixBytes = 2 * sizeof(T);
  const uintptr_t in_at = reinterpret_cast<uintptr_t>(px);
  const uintptr_t out_at = reinterpret_cast<uintptr_t>(out);
  if (n < 1 || iters < 0 || in_at % kPixBytes || out_at % kPixBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  // pixels before the input's first 16-byte boundary
  const int head = static_cast<int>(
      std::min<long long>(n, (W - (in_at / kPixBytes) % W) % W));
  const long long nvec = (n - head) / W;
  const bool out_vec = (out_at / kPixBytes + head) % W == 0;
  // one block at least: thread 0 takes the head and tail pixels. 2^31 - 1
  // blocks hold 4.4e12 f32 pixels, far more than a card's memory.
  const long long blocks = std::max<long long>(1, (nvec + kTile - 1) / kTile);
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  undistort_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const typename Pair<T>::type*>(px),
      static_cast<typename Pair<T>::type*>(out), n, head, nvec, out_vec, c,
      iters);
  return static_cast<int>(cudaGetLastError());
}

// launch<T> on CUDA device `device`, the caller's current device restored
// after (a switch costs the host far less here than in Python)
template <typename T>
int launch_on(int device, const void* px, void* out, long long n,
              const Consts<T>& c, int iters, void* stream) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rc =
      launch<T>(px, out, n, c, iters, static_cast<cudaStream_t>(stream));
  if (prev != device) {
    err = cudaSetDevice(prev);
    if (rc == 0 && err != cudaSuccess) return static_cast<int>(err);
  }
  return rc;
}

template <typename T>
Consts<T> consts(double fx, double fy, double cx, double cy, double k1,
                 double k2, double k3, double p1, double p2) {
  return {T(fx),     T(fy),     T(cx),     T(cy),     T(1 / fx), T(1 / fy),
          T(k1),     T(k2),     T(k3),     T(2 * k1), T(4 * k2), T(6 * k3),
          T(p1),     T(p2),     T(2 * p1), T(2 * p2), T(4 * p1), T(4 * p2)};
}

}  // namespace

extern "C" int undistort_f32(const void* px, void* out, long long n, float fx,
                             float fy, float cx, float cy, float k1, float k2,
                             float k3, float p1, float p2, int iters,
                             int device, void* stream) {
  return launch_on<float>(
      device, px, out, n,
      consts<float>(fx, fy, cx, cy, k1, k2, k3, p1, p2), iters, stream);
}

extern "C" int undistort_f64(const void* px, void* out, long long n,
                             double fx, double fy, double cx, double cy,
                             double k1, double k2, double k3, double p1,
                             double p2, int iters, int device, void* stream) {
  return launch_on<double>(
      device, px, out, n,
      consts<double>(fx, fy, cx, cy, k1, k2, k3, p1, p2), iters, stream);
}
