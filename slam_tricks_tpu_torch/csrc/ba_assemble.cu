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

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kLanes = 32;
constexpr int kSeg = 2 * kLanes;  // slots of a camera-pass segment: two a lane
constexpr int kMaxGroups = 8;     // slot groups (warps) of a landmark block
constexpr int kSegWarps = 4;      // segments (warps) of a camera-pass block
constexpr int kSumThreads = 256;  // threads of a camera-sums block
constexpr int kCamCols = 28;
constexpr int kLmCols = 9;

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

// R row-major (9) | t (3) of camera c, through the read-only cache
template <typename T>
__device__ __forceinline__ void load_camera(const T* __restrict__ R_flat,
                                            const T* __restrict__ t, int c,
                                            T (&cam)[12]) {
  const size_t c9 = static_cast<size_t>(c) * 9, c3 = static_cast<size_t>(c) * 3;
#pragma unroll
  for (int q = 0; q < 9; ++q) cam[q] = __ldg(R_flat + c9 + q);
#pragma unroll
  for (int q = 0; q < 3; ++q) cam[9 + q] = __ldg(t + c3 + q);
}

// One live slot, sqrt-weighted: residual rows, pose and point Jacobian rows
template <typename T>
struct SlotLin {
  T jp0[6], jp1[6];
  T jl0[3], jl1[3];
  T r0, r1, cost;
};

template <typename T>
__device__ __forceinline__ SlotLin<T> linearize(const T (&r)[12], T px, T py,
                                                T pz, T wk, T obs_u, T obs_v,
                                                const Loss<T>& loss) {
  SlotLin<T> o;
  const T x = r[0] * px + r[1] * py + r[2] * pz + r[9];
  const T y = r[3] * px + r[4] * py + r[5] * pz + r[10];
  const T z = r[6] * px + r[7] * py + r[8] * pz + r[11];
  const T iz = T(1) / z;
  const T u = x * iz;
  const T v = y * iz;
  const T d0 = u - obs_u;
  const T d1 = v - obs_v;
  const T s = d0 * d0 + d1 * d1;
  T sw;
  if (loss.kind == kTrivial) {
    sw = sqrt(wk);
    o.cost = T(0.5) * wk * s;
  } else {
    T weight, rho;
    robust(loss, s, &weight, &rho);
    sw = sqrt(wk * weight);
    o.cost = T(0.5) * wk * rho;
  }
  o.r0 = d0 * sw;
  o.r1 = d1 * sw;
  const T sziz = sw * iz;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    o.jl0[j] = (r[j] - u * r[6 + j]) * sziz;
    o.jl1[j] = (r[3 + j] - v * r[6 + j]) * sziz;
  }
  o.jp0[0] = o.jl0[2] * py - o.jl0[1] * pz;
  o.jp0[1] = o.jl0[0] * pz - o.jl0[2] * px;
  o.jp0[2] = o.jl0[1] * px - o.jl0[0] * py;
  o.jp1[0] = o.jl1[2] * py - o.jl1[1] * pz;
  o.jp1[1] = o.jl1[0] * pz - o.jl1[2] * px;
  o.jp1[2] = o.jl1[1] * px - o.jl1[0] * py;
  o.jp0[3] = sziz;
  o.jp0[4] = T(0);
  o.jp0[5] = -u * sziz;
  o.jp1[3] = T(0);
  o.jp1[4] = sziz;
  o.jp1[5] = -v * sziz;
  return o;
}

// W, Hll and gl. Block (32 landmarks, G slot groups); group g walks slots
// k = g, g + G, ...
template <typename T>
__global__ void __launch_bounds__(kLanes * kMaxGroups)
landmark_pass(const T* __restrict__ R_flat, const T* __restrict__ t,
              const T* __restrict__ points, const T* __restrict__ uv0,
              const T* __restrict__ uv1, const T* __restrict__ w,
              const int* __restrict__ cam, int K, int L, Loss<T> loss,
              T* __restrict__ Hll, T* __restrict__ gl, T* __restrict__ W,
              unsigned* __restrict__ sums_done) {
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
        for (int q = 0; q < 18; ++q) W[q * KL + n] = T(0);
        continue;
      }
      T r[12];
      load_camera(R_flat, t, cam[n], r);
      const SlotLin<T> o = linearize(r, px, py, pz, wk, uv0[n], uv1[n], loss);
#pragma unroll
      for (int i = 0; i < 6; ++i) {
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
        Hll[static_cast<size_t>(q) * L + l] = s;
      } else {
        gl[static_cast<size_t>(q - 6) * L + l] = s;
      }
    }
  }
}

// One step of the transposing butterfly: the lanes whose bit OFF is clear
// keep columns [0, OFF) of v and add their partner's, the others keep
// [OFF, 2 OFF) moved down to [0, OFF).
template <int OFF, typename T>
__device__ __forceinline__ void fold(T (&v)[32], bool upper) {
#pragma unroll
  for (int j = 0; j < OFF; ++j) {
    const T send = upper ? v[j] : v[j + OFF];
    const T keep = upper ? v[j + OFF] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
  }
}

// Sums 32 columns over the lanes of a warp in a fixed order: returns, in
// lane i, the sum of column i.
template <typename T>
__device__ __forceinline__ T warp_column_sums(T (&v)[32]) {
  const int lane = threadIdx.x & (kLanes - 1);
  fold<16>(v, lane & 16);
  fold<8>(v, lane & 8);
  fold<4>(v, lane & 4);
  fold<2>(v, lane & 2);
  fold<1>(v, lane & 1);
  return v[0];
}

// Adds slot id's 28 camera columns to v; a pad (id < 0) adds zeros.
template <typename T>
__device__ __forceinline__ void add_camera_columns(
    const T (&r)[12], const T* __restrict__ points, const T* __restrict__ uv0,
    const T* __restrict__ uv1, const T* __restrict__ w, int L,
    const Loss<T>& loss, int first, int id, T (&v)[32]) {
  const int n = id < 0 ? first : id;
  const int l = n % L;
  const T px = __ldg(points + static_cast<size_t>(l) * 3 + 0);
  const T py = __ldg(points + static_cast<size_t>(l) * 3 + 1);
  const T pz = __ldg(points + static_cast<size_t>(l) * 3 + 2);
  const T wk = id < 0 ? T(0) : w[n];
  const SlotLin<T> o = linearize(r, px, py, pz, wk, uv0[n], uv1[n], loss);
  int q = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a) {
#pragma unroll
    for (int b = a; b < 6; ++b) {
      v[q] += dot2(o.jp0[a], o.jp1[a], o.jp0[b], o.jp1[b]);
      ++q;
    }
  }
#pragma unroll
  for (int a = 0; a < 6; ++a) v[21 + a] += dot2(o.jp0[a], o.jp1[a], o.r0, o.r1);
  v[27] += o.cost;
}

// Per-segment partial camera sums: a warp a segment of kSeg slot ids.
template <typename T>
__global__ void __launch_bounds__(kLanes * kSegWarps)
camera_pass(const T* __restrict__ R_flat, const T* __restrict__ t,
            const T* __restrict__ points, const T* __restrict__ uv0,
            const T* __restrict__ uv1, const T* __restrict__ w,
            int L, Loss<T> loss, const int* __restrict__ slots,
            const int* __restrict__ seg_cam, int n_seg,
            T* __restrict__ partial) {
  const int lane = threadIdx.x & (kLanes - 1);
  const int s = blockIdx.x * kSegWarps + threadIdx.x / kLanes;
  if (s >= n_seg) return;   // the whole warp
  const int* seg_slots = slots + static_cast<size_t>(s) * kSeg;
  T r[12];
  load_camera(R_flat, t, seg_cam[s], r);
  const int first = seg_slots[0];   // a segment starts with a live slot

  T v[32];
#pragma unroll
  for (int q = 0; q < 32; ++q) v[q] = T(0);
  // two slots a lane, with no branch, so that the second's gathers overlap
  // the first's arithmetic: a pad (-1) recomputes the segment's first slot
  // with weight 0, which adds exact zeros
  const int ida = seg_slots[lane];
  const int idb = seg_slots[lane + kLanes];
  add_camera_columns(r, points, uv0, uv1, w, L, loss, first, ida, v);
  add_camera_columns(r, points, uv0, uv1, w, L, loss, first, idb, v);
  const T total = warp_column_sums(v);
  if (lane < kCamCols) partial[static_cast<size_t>(s) * kCamCols + lane] = total;
}

// Column q of camera c = the sum of camera c's partials, in segment order,
// into Hpp, gp or cam_cost; then the last block to finish adds cam_cost
// into cost, a thread a stride of cameras and a tree over the block
template <typename T>
__global__ void __launch_bounds__(kSumThreads)
camera_sums(const T* __restrict__ partial, const int* __restrict__ seg_start,
            int C, T* __restrict__ Hpp, T* __restrict__ gp,
            T* __restrict__ cam_cost, unsigned* __restrict__ done,
            T* __restrict__ cost) {
  __shared__ T part[kSumThreads];
  __shared__ bool last;
  const size_t i = static_cast<size_t>(blockIdx.x) * kSumThreads + threadIdx.x;
  if (i < static_cast<size_t>(C) * kCamCols) {
    const int c = static_cast<int>(i / kCamCols);
    const int q = static_cast<int>(i - static_cast<size_t>(c) * kCamCols);
    const int end = seg_start[c + 1];
    T acc = T(0);
#pragma unroll 4
    for (int s = seg_start[c]; s < end; ++s) {
      acc += partial[static_cast<size_t>(s) * kCamCols + q];
    }
    if (q < 21) {
      Hpp[static_cast<size_t>(c) * 21 + q] = acc;
    } else if (q < 27) {
      gp[static_cast<size_t>(c) * 6 + q - 21] = acc;
    } else {
      cam_cost[c] = acc;
    }
  }
  __threadfence();   // this block's cam_cost, seen before its count
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  T acc = T(0);
  for (int c = threadIdx.x; c < C; c += kSumThreads) acc += __ldcg(cam_cost + c);
  part[threadIdx.x] = acc;
  __syncthreads();
#pragma unroll
  for (int half = kSumThreads / 2; half > 0; half /= 2) {
    if (threadIdx.x < half) part[threadIdx.x] += part[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) *cost = part[0];
}

template <typename T>
int launch(const void* R_flat_, const void* t_, const void* points_,
           const void* uv0_, const void* uv1_, const void* w_,
           const void* cam_, const void* slots_, const void* seg_cam_,
           const void* seg_start_,
           int n_seg, int C, int K, int L, Loss<T> loss, void* Hpp, void* gp,
           void* Hll, void* gl, void* W, void* cost, void* scratch,
           void* stream_) {
  const T* R_flat = static_cast<const T*>(R_flat_);
  const T* t = static_cast<const T*>(t_);
  const T* points = static_cast<const T*>(points_);
  const T* uv0 = static_cast<const T*>(uv0_);
  const T* uv1 = static_cast<const T*>(uv1_);
  const T* w = static_cast<const T*>(w_);
  const int* cam = static_cast<const int*>(cam_);
  T* partial = static_cast<T*>(scratch);                    // (n_seg, 28)
  T* cam_cost = partial + static_cast<size_t>(n_seg) * kCamCols;  // (C,)
  unsigned* sums_done = reinterpret_cast<unsigned*>(cam_cost + C);  // (1,)
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);

  const int groups = K < kMaxGroups ? K : kMaxGroups;
  landmark_pass<T><<<(L + kLanes - 1) / kLanes, dim3(kLanes, groups), 0,
                     stream>>>(R_flat, t, points, uv0, uv1, w, cam, K, L,
                               loss, static_cast<T*>(Hll), static_cast<T*>(gl),
                               static_cast<T*>(W), sums_done);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_seg > 0) {
    camera_pass<T><<<(n_seg + kSegWarps - 1) / kSegWarps, kLanes * kSegWarps,
                     0, stream>>>(R_flat, t, points, uv0, uv1, w, L, loss,
                                  static_cast<const int*>(slots_),
                                  static_cast<const int*>(seg_cam_), n_seg,
                                  partial);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t sums = static_cast<size_t>(C) * kCamCols;
  camera_sums<T><<<static_cast<unsigned>((sums + kSumThreads - 1) / kSumThreads),
                   kSumThreads, 0, stream>>>(
      partial, static_cast<const int*>(seg_start_), C, static_cast<T*>(Hpp),
      static_cast<T*>(gp), cam_cost, sums_done, static_cast<T*>(cost));
  return static_cast<int>(cudaGetLastError());
}

// launch<T> on CUDA device `device`, the caller's current device restored
// after (a switch costs the host far less here than in Python)
template <typename T>
int launch_on(int device, const void* R_flat, const void* t,
              const void* points, const void* uv0, const void* uv1,
              const void* w, const void* cam, const void* slots,
              const void* seg_cam, const void* seg_start, int n_seg, int C,
              int K, int L, int loss_kind, double loss_p, double loss_p2,
              void* Hpp, void* gp, void* Hll, void* gl, void* W, void* cost,
              void* scratch, void* stream) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Loss<T> loss{loss_kind, static_cast<T>(loss_p),
                     static_cast<T>(loss_p2)};
  const int rc = launch<T>(R_flat, t, points, uv0, uv1, w, cam, slots,
                           seg_cam, seg_start, n_seg, C, K, L, loss, Hpp, gp,
                           Hll, gl, W, cost, scratch, stream);
  if (prev != device) {
    err = cudaSetDevice(prev);
    if (rc == 0 && err != cudaSuccess) return static_cast<int>(err);
  }
  return rc;
}

}  // namespace

extern "C" int ba_assemble_f32(const void* R_flat, const void* t,
                               const void* points, const void* uv0,
                               const void* uv1, const void* w, const void* cam,
                               const void* slots, const void* seg_cam,
                               const void* seg_start,
                               int n_seg, int C, int K, int L, int loss_kind,
                               double loss_p, double loss_p2, void* Hpp,
                               void* gp, void* Hll, void* gl, void* W,
                               void* cost, void* scratch, int device,
                               void* stream) {
  return launch_on<float>(device, R_flat, t, points, uv0, uv1, w, cam, slots,
                          seg_cam, seg_start, n_seg, C, K, L, loss_kind,
                          loss_p, loss_p2, Hpp, gp, Hll, gl, W, cost, scratch,
                          stream);
}

extern "C" int ba_assemble_f64(const void* R_flat, const void* t,
                               const void* points, const void* uv0,
                               const void* uv1, const void* w, const void* cam,
                               const void* slots, const void* seg_cam,
                               const void* seg_start,
                               int n_seg, int C, int K, int L, int loss_kind,
                               double loss_p, double loss_p2, void* Hpp,
                               void* gp, void* Hll, void* gl, void* W,
                               void* cost, void* scratch, int device,
                               void* stream) {
  return launch_on<double>(device, R_flat, t, points, uv0, uv1, w, cam, slots,
                           seg_cam, seg_start, n_seg, C, K, L, loss_kind,
                           loss_p, loss_p2, Hpp, gp, Hll, gl, W, cost,
                           scratch, stream);
}
