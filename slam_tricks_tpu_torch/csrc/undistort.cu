// Newton undistortion of pixels under the radial-tangential (Brown-Conrady)
// model, for Hopper (sm_90a).
//
// Replaces: slam_tricks_tpu/ops/pallas_undistort.py::_undistort_kernel
// (called by undistort_points_pallas). Same math, term for term, as it and
// slam_tricks_tpu/residuals/camera.py::undistort_points_fast: normalize
// (u0, v0) = ((px - cx) / fx, (py - cy) / fy), then `iters` Newton steps on
// distort(u, v) = (u0, v0) with the analytic 2x2 Jacobian and its
// closed-form inverse, then back to pixels.
//
// What bounds it on the H100: device memory. Each pixel reads 2 values and
// writes 2 (8,388,608 f32 pixels: 67 MB each way, 40.1 us at 3.35 TB/s).
// The operations come close: a Newton step needs 62, one of them a
// division (constant products such as 2 p1 worked out once, shared
// subexpressions once), and a pixel 8 more (5 steps: 2.67 GFLOP, 39.8 us at
// 67 TFLOP/s f32).
// What the design does about it: one thread a pixel, one 8- or 16-byte
// load of the interleaved (x, y) pair and one store, the 9 camera
// parameters by value (in the constant bank), every Newton step in
// registers; the ragged end is masked, so nothing is padded.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
struct Pair;
template <>
struct Pair<float> { using type = float2; };
template <>
struct Pair<double> { using type = double2; };

template <typename T>
struct Camera {
  T fx, fy, cx, cy, k1, k2, k3, p1, p2;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
undistort_kernel(const typename Pair<T>::type* __restrict__ px,
                 typename Pair<T>::type* __restrict__ out, int n,
                 Camera<T> c, int iters) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const typename Pair<T>::type q = px[i];
  const T u0 = (q.x - c.cx) / c.fx;
  const T v0 = (q.y - c.cy) / c.fy;
  T u = u0;
  T v = v0;
  for (int it = 0; it < iters; ++it) {
    const T r2 = u * u + v * v;
    const T radial = T(1) + r2 * (c.k1 + r2 * (c.k2 + r2 * c.k3));
    const T dr = c.k1 + r2 * (T(2) * c.k2 + T(3) * c.k3 * r2);
    const T ud = u * radial + T(2) * c.p1 * u * v + c.p2 * (r2 + T(2) * u * u);
    const T vd = v * radial + c.p1 * (r2 + T(2) * v * v) + T(2) * c.p2 * u * v;
    const T fu = ud - u0;
    const T fv = vd - v0;
    const T a = radial + T(2) * u * u * dr + T(2) * c.p1 * v + T(6) * c.p2 * u;
    const T b = T(2) * u * v * dr + T(2) * c.p1 * u + T(2) * c.p2 * v;
    const T d = radial + T(2) * v * v * dr + T(6) * c.p1 * v + T(2) * c.p2 * u;
    const T inv_det = T(1) / (a * d - b * b);
    u = u - inv_det * (d * fu - b * fv);
    v = v - inv_det * (a * fv - b * fu);
  }
  typename Pair<T>::type o;
  o.x = c.fx * u + c.cx;
  o.y = c.fy * v + c.cy;
  out[i] = o;
}

template <typename T>
int launch(const void* px, void* out, int n, Camera<T> c, int iters,
           void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  undistort_kernel<T><<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const typename Pair<T>::type*>(px),
      static_cast<typename Pair<T>::type*>(out), n, c, iters);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int undistort_f32(const void* px, void* out, int n, float fx,
                             float fy, float cx, float cy, float k1, float k2,
                             float k3, float p1, float p2, int iters,
                             void* stream) {
  return launch<float>(px, out, n, {fx, fy, cx, cy, k1, k2, k3, p1, p2}, iters,
                       stream);
}

extern "C" int undistort_f64(const void* px, void* out, int n, double fx,
                             double fy, double cx, double cy, double k1,
                             double k2, double k3, double p1, double p2,
                             int iters, void* stream) {
  return launch<double>(px, out, n, {fx, fy, cx, cy, k1, k2, k3, p1, p2},
                        iters, stream);
}
