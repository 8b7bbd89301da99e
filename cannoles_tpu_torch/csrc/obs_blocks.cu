// The per-observation Jacobian blocks of the camera-Schur engine's list route
// (ops/obs_blocks.py, core/ba.py `_ListProducts._at`): for observation o of
// camera c_o and point p_o, Snavely's projection u = snavely_project(cam, X)
// (models/bal.py) at the iterate x, and
//
//   A_o  = du/dcam  (2 x 9), its columns times the camera's frozen-coordinate
//          mask where the solver has one,
//   Bm_o = du/dX    (2 x 3),
//   W_o  = A_o^T Bm_o (9 x 3), from the masked A_o,
//
// written row-major into (lanes, n_obs, 2, 9), (lanes, n_obs, 2, 3) and
// (lanes, n_obs, 9, 3), the layouts that ops/obs_products.py reads.
//
// Replaces no TPU kernel: the JAX package has no observation-list route.
// The plain route pushes 12 forward-mode tangents through the projection
// (vmap(vmap(jacfwd)) over 1.26M observations), which materialises the
// gathered cameras and points and then runs each elementwise step of the
// projection as a kernel over (n_obs, 12, 3) tangent arrays, and forms W by
// a cuBLAS batched GEMM of 1.26M 9 x 2 by 2 x 3 products.
//
// What bounds it.  The bytes: each observation reads two 32-bit indices, a
// camera (356 x 36 B at Dubrovnik-356, cached) and a point (2.7 MB, cached),
// and writes A, Bm and W once, 204 B in float32: 0.28 GB at Dubrovnik-356's
// 1,255,268 observations, 0.084 ms at 3.35 TB/s.  The ~490 operations an
// observation (one sqrt, sin and cos and six divides among them) are far
// below the card's rate in either type.
//
// Design.  One thread per observation, lanes on the grid's y.  The camera
// and point are read straight from x by their offsets (9 c, 9 C + 3 p)
// through the read-only cache, so no gathered copy is made.  The derivatives
// are the forward-mode chain rule of `snavely_project`/`rotate` written out
// in closed form: dP/dX = R(w) and dP/dw by the tangents of theta, k, cos and
// sin, then the projection's and the distortion's 2 x 3 Jacobian, so A, Bm
// and W come out of one pass in registers.  Below theta^2 = 1e-12 the
// rotation is X + w x X, with that branch's derivatives, as jacfwd through
// `torch.where` gives them; theta = sqrt(theta^2 + 1e-30) as in `rotate`.
// The stores: each warp stages its 32 observations' A, then Bm, then W, in
// shared memory, at the offset that puts a 16-byte boundary of the output on
// a 16-byte boundary of the buffer, and writes each as coalesced 16-byte
// stores over its contiguous span of the output (single items at a ragged
// head or tail).  No atomics and no sums across threads, so the blocks
// repeat bit for bit; with --fmad=false every product is rounded before its
// sum.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kCam = 9;             // Snavely: w (3), t (3), f, k1, k2
constexpr int kA = 2 * kCam;        // items of A an observation
constexpr int kB = 2 * 3;           // of Bm
constexpr int kW = kCam * 3;        // of W
constexpr int kStage = 32 * kW + 4;  // a warp's staging buffer, with room to align

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
  static constexpr int n = 4;
};
template <>
struct Vec<double> {
  using type = double2;
  static constexpr int n = 2;
};

template <typename T>
struct Args {
  int n_obs, n_cams;
  const int* cam;   // (n_obs,) camera of each observation
  const int* pt;    // (n_obs,) point of each observation
  const T* x;       // (lanes, 9 n_cams + 3 n_pts), a lane every xb items
  long long xb;
  const T* mask;    // (n_cams, 9) frozen-coordinate mask, or null
  T* A;             // (lanes, n_obs, 2, 9) contiguous
  T* Bm;            // (lanes, n_obs, 2, 3) contiguous
  T* W;             // (lanes, n_obs, 9, 3) contiguous
};

__device__ __forceinline__ float sqrt_(float v) { return sqrtf(v); }
__device__ __forceinline__ double sqrt_(double v) { return ::sqrt(v); }
__device__ __forceinline__ float cos_(float v) { return cosf(v); }
__device__ __forceinline__ double cos_(double v) { return ::cos(v); }
__device__ __forceinline__ float sin_(float v) { return sinf(v); }
__device__ __forceinline__ double sin_(double v) { return ::sin(v); }

template <typename T>
__device__ __forceinline__ void cross(const T* a, const T* b, T* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

// A (2 x 9) and Bm (2 x 3) of Snavely's projection of point X through cam
template <typename T>
__device__ __forceinline__ void snavely_blocks(const T* cam, const T* X, T (&A)[2][kCam], T (&Bm)[2][3]) {
  const T w[3] = {cam[0], cam[1], cam[2]};
  const T th2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  T Pc[3], R[3][3], D[3][3];  // R(w) X; R = dP/dX; D[i][j] = dP_i/dw_j
  if (th2 < T(1e-12)) {
    // P = X + w x X
    T wx[3];
    cross(w, X, wx);
#pragma unroll
    for (int i = 0; i < 3; ++i) Pc[i] = X[i] + wx[i];
    D[0][0] = T(0), D[0][1] = X[2], D[0][2] = -X[1];
    D[1][0] = -X[2], D[1][1] = T(0), D[1][2] = X[0];
    D[2][0] = X[1], D[2][1] = -X[0], D[2][2] = T(0);
    R[0][0] = T(1), R[0][1] = -w[2], R[0][2] = w[1];
    R[1][0] = w[2], R[1][1] = T(1), R[1][2] = -w[0];
    R[2][0] = -w[1], R[2][1] = w[0], R[2][2] = T(1);
  } else {
    // P = c X + s (k x X) + (1 - c)(k . X) k, k = w / theta
    const T th = sqrt_(th2 + T(1e-30));
    const T k[3] = {w[0] / th, w[1] / th, w[2] / th};
    const T c = cos_(th), s = sin_(th), omc = T(1) - c;
    T kx[3];
    cross(k, X, kx);
    const T kX = k[0] * X[0] + k[1] * X[1] + k[2] * X[2];
    const T g = omc * kX;
#pragma unroll
    for (int i = 0; i < 3; ++i) Pc[i] = (c * X[i] + s * kx[i]) + g * k[i];
    // dP/dX = c I + s [k]x + (1 - c) k k^T
    const T K[3][3] = {{T(0), -k[2], k[1]}, {k[2], T(0), -k[0]}, {-k[1], k[0], T(0)}};
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) R[i][j] = ((i == j ? c : T(0)) + s * K[i][j]) + omc * k[i] * k[j];
    // along w_j: dtheta = k_j, dk = (e_j - k k_j) / theta, dc = -s dtheta,
    // ds = c dtheta
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const T dth = k[j];
      T dk[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) dk[i] = ((i == j ? T(1) : T(0)) - k[i] * k[j]) / th;
      const T dc = -s * dth, ds = c * dth;
      T dkx[3];
      cross(dk, X, dkx);
      const T dkX = dk[0] * X[0] + dk[1] * X[1] + dk[2] * X[2];
#pragma unroll
      for (int i = 0; i < 3; ++i)
        D[i][j] = (dc * X[i] + ds * kx[i] + s * dkx[i]) + ((omc * dkX - dc * kX) * k[i] + g * dk[i]);
    }
  }
  // P = R(w) X + t;  p = -P_xy / P_z;  u = f (1 + k1 r2 + k2 r2^2) p
  const T P0 = Pc[0] + cam[3], P1 = Pc[1] + cam[4], P2 = Pc[2] + cam[5];
  const T f = cam[6], k1 = cam[7], k2 = cam[8];
  const T p[2] = {-P0 / P2, -P1 / P2};
  const T r2 = p[0] * p[0] + p[1] * p[1];
  const T d = (T(1) + k1 * r2) + k2 * r2 * r2;
  const T fd = f * d;
  const T h = T(2) * (k1 + T(2) * k2 * r2);  // dd/dp_m = h p_m
  const T q = T(-1) / P2;                    // dp/dP = q [[1, 0, p0], [0, 1, p1]]
  T JuP[2][3];                               // du/dP
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const T j0 = (i == 0 ? fd : T(0)) + f * p[i] * h * p[0];
    const T j1 = (i == 1 ? fd : T(0)) + f * p[i] * h * p[1];
    JuP[i][0] = j0 * q;
    JuP[i][1] = j1 * q;
    JuP[i][2] = (j0 * p[0] + j1 * p[1]) * q;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      A[i][j] = JuP[i][0] * D[0][j] + JuP[i][1] * D[1][j] + JuP[i][2] * D[2][j];
      A[i][3 + j] = JuP[i][j];
      Bm[i][j] = JuP[i][0] * R[0][j] + JuP[i][1] * R[1][j] + JuP[i][2] * R[2][j];
    }
    A[i][6] = d * p[i];
    A[i][7] = f * r2 * p[i];
    A[i][8] = f * r2 * r2 * p[i];
  }
}

template <typename T>
__device__ __forceinline__ typename Vec<T>::type vec(const T* s);
template <>
__device__ __forceinline__ float4 vec<float>(const float* s) {
  return *reinterpret_cast<const float4*>(s);
}
template <>
__device__ __forceinline__ double2 vec<double>(const double* s) {
  return *reinterpret_cast<const double2*>(s);
}

// the warp's `count` items of one output, staged by its threads at
// sh[mis + ...], written to dst[0 .. count): 16-byte stores where both sides
// are aligned (sh and dst share their offset from a 16-byte boundary),
// single items at the head and tail
template <typename T>
__device__ __forceinline__ void put(T* dst, int mis, int count, const T* sh, int lane) {
  using V = typename Vec<T>::type;
  constexpr int vn = Vec<T>::n;
  const int end = mis + count;
  const int v0 = (mis + vn - 1) / vn, v1 = end / vn;  // whole vectors [v0, v1)
  T* base = dst - mis;                                  // position 0 of the staged span
  if (v0 >= v1) {
    for (int i = mis + lane; i < end; i += 32) base[i] = sh[i];
    return;
  }
  for (int i = mis + lane; i < v0 * vn; i += 32) base[i] = sh[i];
  for (int v = v0 + lane; v < v1; v += 32) reinterpret_cast<V*>(base)[v] = vec<T>(sh + v * vn);
  for (int i = v1 * vn + lane; i < end; i += 32) base[i] = sh[i];
}

template <typename T>
__device__ __forceinline__ int misalign(const T* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) & 15) / sizeof(T));
}

template <typename T>
__global__ void __launch_bounds__(kThreads) obs_blocks_kernel(Args<T> a) {
  __shared__ __align__(16) T stage[kWarps][kStage];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long o0 = static_cast<long long>(blockIdx.x) * kThreads + warp * 32;
  if (o0 >= a.n_obs) return;  // the whole warp
  const int cnt = static_cast<int>(a.n_obs - o0 < 32 ? a.n_obs - o0 : 32);
  const long long b = blockIdx.y;
  T A[2][kCam], Bm[2][3], W[kCam][3];
  if (lane < cnt) {
    const long long o = o0 + lane;
    const int c = __ldg(a.cam + o), pi = __ldg(a.pt + o);
    const T* xb = a.x + b * a.xb;
    const T* cp = xb + static_cast<long long>(c) * kCam;
    const T* pp = xb + static_cast<long long>(a.n_cams) * kCam + static_cast<long long>(pi) * 3;
    T cam[kCam], X[3];
#pragma unroll
    for (int k = 0; k < kCam; ++k) cam[k] = __ldg(cp + k);
#pragma unroll
    for (int k = 0; k < 3; ++k) X[k] = __ldg(pp + k);
    snavely_blocks<T>(cam, X, A, Bm);
    if (a.mask != nullptr) {
      const T* m = a.mask + static_cast<long long>(c) * kCam;
#pragma unroll
      for (int k = 0; k < kCam; ++k) {
        const T mk = __ldg(m + k);
        A[0][k] = A[0][k] * mk;
        A[1][k] = A[1][k] * mk;
      }
    }
#pragma unroll
    for (int i = 0; i < kCam; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) W[i][j] = A[0][i] * Bm[0][j] + A[1][i] * Bm[1][j];
  }
  T* sh = stage[warp];
  const long long lane_obs = static_cast<long long>(a.n_obs) * b;
  {
    T* dst = a.A + (lane_obs + o0) * kA;
    const int mis = misalign(dst);
    if (lane < cnt) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int k = 0; k < kCam; ++k) sh[mis + lane * kA + i * kCam + k] = A[i][k];
    }
    __syncwarp();
    put<T>(dst, mis, cnt * kA, sh, lane);
    __syncwarp();
  }
  {
    T* dst = a.Bm + (lane_obs + o0) * kB;
    const int mis = misalign(dst);
    if (lane < cnt) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) sh[mis + lane * kB + i * 3 + j] = Bm[i][j];
    }
    __syncwarp();
    put<T>(dst, mis, cnt * kB, sh, lane);
    __syncwarp();
  }
  {
    T* dst = a.W + (lane_obs + o0) * kW;
    const int mis = misalign(dst);
    if (lane < cnt) {
#pragma unroll
      for (int i = 0; i < kCam; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) sh[mis + lane * kW + i * 3 + j] = W[i][j];
    }
    __syncwarp();
    put<T>(dst, mis, cnt * kW, sh, lane);
  }
}

template <typename T>
int launch(int lanes, int n_obs, int n_cams, const int* cam, const int* pt, const T* x, long long xb,
           const T* mask, T* A, T* Bm, T* W, void* stream) {
  if (lanes <= 0 || n_obs <= 0) return 0;
  Args<T> a{n_obs, n_cams, cam, pt, x, xb, mask, A, Bm, W};
  const dim3 grid(static_cast<unsigned>((static_cast<long long>(n_obs) + kThreads - 1) / kThreads), lanes);
  obs_blocks_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// cam, pt (n_obs,) int32 on the card; x the iterates, a lane every xb items
// (cameras of 9 parameters first, then points of 3); mask (n_cams, 9) or
// null; A, Bm, W contiguous (lanes, n_obs, 2, 9), (lanes, n_obs, 2, 3),
// (lanes, n_obs, 9, 3).  Returns cudaGetLastError() after the launch (0 and
// no launch for no lane or no observation).
int cannoles_obs_blocks_f32(int lanes, int n_obs, int n_cams, const int* cam, const int* pt, const float* x,
                            long long xb, const float* mask, float* A, float* Bm, float* W, void* stream) {
  return launch<float>(lanes, n_obs, n_cams, cam, pt, x, xb, mask, A, Bm, W, stream);
}

int cannoles_obs_blocks_f64(int lanes, int n_obs, int n_cams, const int* cam, const int* pt, const double* x,
                            long long xb, const double* mask, double* A, double* Bm, double* W, void* stream) {
  return launch<double>(lanes, n_obs, n_cams, cam, pt, x, xb, mask, A, Bm, W, stream);
}

}  // extern "C"
