// The products over observations of the camera-Schur engine's list route
// (ops/obs_products.py, core/ba.py `_ListProducts`, `_list_system`): with
// per-observation blocks A_o (2 x cd), Bm_o (2 x 3), X_o and W_o (cd x 3),
// camera c_o and point p_o of observation o,
//
//   jv      (J v)_o = A_o v_c[c_o] + Bm_o v_p[p_o]                  (n_obs x 2)
//   jtw     g_c = sum_{o in obs(c)} A_o^T w_o,  g_p = sum_{o in obs(p)} Bm_o^T w_o
//   reduce  r_c = sum_{o in obs(c)} X_o b[p_o]
//   lift    l_p = sum_{o in obs(p)} W_o^T z[c_o]
//   uv      U_c = sum_{o in obs(c)} A_o^T A_o,  V_p = sum_{o in obs(p)} Bm_o^T Bm_o
//
// obs(c) and obs(p) being CSR lists of each camera's and each point's
// observations in ascending order, built once per observation structure.
//
// Replaces no TPU kernel: the JAX package has no observation-list route (its
// Schur engine takes the dense (C, P) grid and its einsums).  The plain route
// is einsums over 1.26M observations, which cuBLAS runs as as many 2 x 9
// batched GEMVs, each product written out to device memory, and then a
// segment sum by `index_put_` that sorts the indices again at every call.
//
// What bounds it.  The bytes: every block read once (n_obs x 24-27 items),
// the index lists once, the vectors and outputs once; a product pass moves
// 0.11-0.15 GB at Dubrovnik-356's size, 35-45 us at 3.35 TB/s.  The 2-4
// flops an item read are far below the card's rate.
//
// Design.  Nothing per observation is written to device memory: each
// product is formed in registers from the blocks, read by their strides (the
// forward-mode Jacobian's transposed layout, where an observation's A and Bm
// share one record, as read), and summed where it is formed.  `jv` takes one
// thread per output row (o, k), so that a warp reads 32 neighbouring rows.
// The segment kinds launch one grid of two roles, one launch a call: a block
// per camera (its ~3,500 observations spread over 256 threads, each summing
// its share in ascending order in registers, then a shuffle tree within each
// warp and the warps' sums in warp order), and a thread per point (its ~5.5
// observations in ascending order, as the plain segment sum adds them).
// Every sum has an order fixed by the lists and the launch shape, with no
// float atomics, so the result repeats bit for bit; with --fmad=false every
// product is rounded before its sum.  Lanes are the grid's y.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

enum Kind { kJv = 0, kJtw = 1, kReduce = 2, kLift = 3, kUv = 4 };

template <typename T>
struct Args {
  int n_obs, n_cams, n_pts;
  const int* cam;        // (n_obs,) camera of each observation
  const int* pt;         // (n_obs,) point of each observation
  const int* cam_order;  // (n_obs,) observations by camera, ascending within one
  const int* cam_start;  // (n_cams + 1,)
  const int* pt_order;   // (n_obs,) observations by point, ascending within one
  const int* pt_start;   // (n_pts + 1,)
  const T* m1;           // A (jv, jtw, uv), X (reduce), W (lift): (lanes, n_obs, rows, cols)
  long long m1b, m1o, m1r, m1c;
  const T* m2;  // Bm (jv, jtw, uv): (lanes, n_obs, 2, 3)
  long long m2b, m2o, m2r, m2c;
  const T* vec;  // v (jv), w (jtw), b (reduce), z (lift): one contiguous row a lane
  long long vecb;
  T* out1;  // J v, [g_c; g_p], r, l, U: one contiguous row a lane
  long long out1b;
  T* out2;  // V (uv)
  long long out2b;
};

template <typename T>
__device__ __forceinline__ T ld(const T* p) {
  return __ldg(p);
}

template <typename T, int CD>
__global__ void __launch_bounds__(kThreads) obs_jv_kernel(Args<T> a) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= 2LL * a.n_obs) return;
  const long long b = blockIdx.y;
  const long long o = e >> 1;
  const int k = static_cast<int>(e & 1);
  const T* A = a.m1 + b * a.m1b + o * a.m1o + k * a.m1r;
  const T* Bm = a.m2 + b * a.m2b + o * a.m2o + k * a.m2r;
  const T* v = a.vec + b * a.vecb;
  const T* vc = v + static_cast<long long>(ld(a.cam + o)) * CD;
  const T* vp = v + static_cast<long long>(a.n_cams) * CD + static_cast<long long>(ld(a.pt + o)) * 3;
  T s1 = T(0), s2 = T(0);
#pragma unroll
  for (int i = 0; i < CD; ++i) s1 = s1 + ld(A + i * a.m1c) * ld(vc + i);
#pragma unroll
  for (int j = 0; j < 3; ++j) s2 = s2 + ld(Bm + j * a.m2c) * ld(vp + j);
  a.out1[b * a.out1b + e] = s1 + s2;
}

// the upper triangle (i <= j) of an N x N block, row by row
template <int N>
constexpr int tri() {
  return N * (N + 1) / 2;
}

template <int KIND, int CD>
struct Shape {
  static constexpr bool cams = KIND == kJtw || KIND == kReduce || KIND == kUv;
  static constexpr bool pts = KIND == kJtw || KIND == kLift || KIND == kUv;
  static constexpr int nc = KIND == kUv ? tri<CD>() : CD;  // sums a camera
  static constexpr int np = KIND == kUv ? tri<3>() : 3;    // sums a point
};

// observation o's terms of its camera's sums
template <typename T, int CD, int KIND>
__device__ __forceinline__ void camera_terms(const Args<T>& a, long long b, long long o, T* t) {
  const T* M = a.m1 + b * a.m1b + o * a.m1o;
  if constexpr (KIND == kJtw) {
    const T* w = a.vec + b * a.vecb + 2 * o;
    const T w0 = ld(w), w1 = ld(w + 1);
#pragma unroll
    for (int i = 0; i < CD; ++i) t[i] = ld(M + i * a.m1c) * w0 + ld(M + a.m1r + i * a.m1c) * w1;
  } else if constexpr (KIND == kReduce) {
    const T* x = a.vec + b * a.vecb + static_cast<long long>(ld(a.pt + o)) * 3;
    const T x0 = ld(x), x1 = ld(x + 1), x2 = ld(x + 2);
#pragma unroll
    for (int i = 0; i < CD; ++i) {
      const T* r = M + i * a.m1r;
      t[i] = ld(r) * x0 + ld(r + a.m1c) * x1 + ld(r + 2 * a.m1c) * x2;
    }
  } else if constexpr (KIND == kUv) {
    T r0[CD], r1[CD];
#pragma unroll
    for (int i = 0; i < CD; ++i) {
      r0[i] = ld(M + i * a.m1c);
      r1[i] = ld(M + a.m1r + i * a.m1c);
    }
    int n = 0;
#pragma unroll
    for (int i = 0; i < CD; ++i)
#pragma unroll
      for (int j = i; j < CD; ++j) t[n++] = r0[i] * r0[j] + r1[i] * r1[j];
  }
}

// observation o's terms of its point's sums
template <typename T, int CD, int KIND>
__device__ __forceinline__ void point_terms(const Args<T>& a, long long b, long long o, T* t) {
  if constexpr (KIND == kJtw) {
    const T* B = a.m2 + b * a.m2b + o * a.m2o;
    const T* w = a.vec + b * a.vecb + 2 * o;
    const T w0 = ld(w), w1 = ld(w + 1);
#pragma unroll
    for (int j = 0; j < 3; ++j) t[j] = ld(B + j * a.m2c) * w0 + ld(B + a.m2r + j * a.m2c) * w1;
  } else if constexpr (KIND == kLift) {
    const T* W = a.m1 + b * a.m1b + o * a.m1o;
    const T* z = a.vec + b * a.vecb + static_cast<long long>(ld(a.cam + o)) * CD;
    T zi[CD];
#pragma unroll
    for (int i = 0; i < CD; ++i) zi[i] = ld(z + i);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      T s = T(0);
#pragma unroll
      for (int i = 0; i < CD; ++i) s = s + ld(W + i * a.m1r + j * a.m1c) * zi[i];
      t[j] = s;
    }
  } else if constexpr (KIND == kUv) {
    const T* B = a.m2 + b * a.m2b + o * a.m2o;
    T r0[3], r1[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      r0[j] = ld(B + j * a.m2c);
      r1[j] = ld(B + a.m2r + j * a.m2c);
    }
    int n = 0;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = i; j < 3; ++j) t[n++] = r0[i] * r0[j] + r1[i] * r1[j];
  }
}

// (i, j) of the n-th entry of an N x N block's upper triangle
template <int N>
__device__ __forceinline__ int2 upper(int n) {
  int i = 0;
  while (n >= N - i) {
    n -= N - i;
    ++i;
  }
  return make_int2(i, i + n);
}

// write sum n of a camera (c) or a point (p)
template <typename T, int CD, int KIND>
__device__ __forceinline__ void put_camera(const Args<T>& a, long long b, int c, int n, T v) {
  T* out = a.out1 + b * a.out1b;
  if constexpr (KIND == kUv) {
    const int2 ij = upper<CD>(n);
    out[(static_cast<long long>(c) * CD + ij.x) * CD + ij.y] = v;
    out[(static_cast<long long>(c) * CD + ij.y) * CD + ij.x] = v;
  } else {
    out[static_cast<long long>(c) * CD + n] = v;
  }
}

template <typename T, int CD, int KIND>
__device__ __forceinline__ void put_point(const Args<T>& a, long long b, long long p, int n, T v) {
  if constexpr (KIND == kUv) {
    T* out = a.out2 + b * a.out2b + p * 9;
    const int2 ij = upper<3>(n);
    out[ij.x * 3 + ij.y] = v;
    out[ij.y * 3 + ij.x] = v;
  } else if constexpr (KIND == kJtw) {
    a.out1[b * a.out1b + static_cast<long long>(a.n_cams) * CD + p * 3 + n] = v;
  } else {
    a.out1[b * a.out1b + p * 3 + n] = v;
  }
}

// blocks [0, n_cams) sum one camera each (for the kinds with camera sums),
// the blocks after them kThreads points each (for the kinds with point sums)
template <typename T, int CD, int KIND>
__global__ void __launch_bounds__(kThreads) obs_segments_kernel(Args<T> a) {
  using S = Shape<KIND, CD>;
  const long long b = blockIdx.y;
  int cam_blocks = 0;
  if constexpr (S::cams) {
    cam_blocks = a.n_cams;
    if (static_cast<int>(blockIdx.x) < cam_blocks) {
      constexpr int N = S::nc;
      __shared__ T part[kWarps][N];
      const int c = blockIdx.x;
      const int s = ld(a.cam_start + c), e = ld(a.cam_start + c + 1);
      T acc[N];
#pragma unroll
      for (int n = 0; n < N; ++n) acc[n] = T(0);
      for (int k = s + static_cast<int>(threadIdx.x); k < e; k += kThreads) {
        T t[N];
        camera_terms<T, CD, KIND>(a, b, ld(a.cam_order + k), t);
#pragma unroll
        for (int n = 0; n < N; ++n) acc[n] = acc[n] + t[n];
      }
      const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        T v = acc[n];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) v = v + __shfl_down_sync(0xffffffffu, v, off);
        if (lane == 0) part[warp][n] = v;
      }
      __syncthreads();
      for (int n = threadIdx.x; n < N; n += kThreads) {
        T v = part[0][n];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) v = v + part[w][n];
        put_camera<T, CD, KIND>(a, b, c, n, v);
      }
      return;
    }
  }
  if constexpr (S::pts) {
    constexpr int N = S::np;
    const long long p = (static_cast<long long>(blockIdx.x) - cam_blocks) * kThreads + threadIdx.x;
    if (p >= a.n_pts) return;
    const int s = ld(a.pt_start + p), e = ld(a.pt_start + p + 1);
    T acc[N];
#pragma unroll
    for (int n = 0; n < N; ++n) acc[n] = T(0);
    for (int k = s; k < e; ++k) {
      T t[N];
      point_terms<T, CD, KIND>(a, b, ld(a.pt_order + k), t);
#pragma unroll
      for (int n = 0; n < N; ++n) acc[n] = acc[n] + t[n];
    }
#pragma unroll
    for (int n = 0; n < N; ++n) put_point<T, CD, KIND>(a, b, p, n, acc[n]);
  }
}

template <typename T, int CD>
int launch_cd(int kind, int lanes, const Args<T>& a, cudaStream_t s) {
  const long long point_blocks = (static_cast<long long>(a.n_pts) + kThreads - 1) / kThreads;
  dim3 block(kThreads);
  switch (kind) {
    case kJv: {
      dim3 grid(static_cast<unsigned>((2LL * a.n_obs + kThreads - 1) / kThreads), lanes);
      obs_jv_kernel<T, CD><<<grid, block, 0, s>>>(a);
      break;
    }
    case kJtw:
      obs_segments_kernel<T, CD, kJtw><<<dim3(a.n_cams + point_blocks, lanes), block, 0, s>>>(a);
      break;
    case kReduce:
      obs_segments_kernel<T, CD, kReduce><<<dim3(a.n_cams, lanes), block, 0, s>>>(a);
      break;
    case kLift:
      obs_segments_kernel<T, CD, kLift><<<dim3(point_blocks, lanes), block, 0, s>>>(a);
      break;
    case kUv:
      obs_segments_kernel<T, CD, kUv><<<dim3(a.n_cams + point_blocks, lanes), block, 0, s>>>(a);
      break;
    default:
      return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(int kind, int cd, int lanes, int n_obs, int n_cams, int n_pts, const int* cam, const int* pt,
           const int* cam_order, const int* cam_start, const int* pt_order, const int* pt_start, const T* m1,
           const T* m2, const T* vec, T* out1, T* out2, const long long* strides, void* stream) {
  Args<T> a{n_obs,     n_cams,     n_pts,      cam,        pt,         cam_order,  cam_start,
            pt_order,  pt_start,   m1,         strides[0], strides[1], strides[2], strides[3],
            m2,        strides[4], strides[5], strides[6], strides[7], vec,        strides[8],
            out1,      strides[9], out2,       strides[10]};
  if (lanes <= 0 || n_obs <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cd == 9) return launch_cd<T, 9>(kind, lanes, a, s);
  if (cd == 6) return launch_cd<T, 6>(kind, lanes, a, s);
  return -1;
}

}  // namespace

extern "C" {

// kind: 0 jv, 1 jtw, 2 reduce, 3 lift, 4 uv; cd: 6 or 9; cam, pt, the
// orders (n_obs,) and starts (n_cams + 1,), (n_pts + 1,) int32 on the card;
// m1, m2 the blocks, read by their element strides; vec, out1, out2 one
// contiguous row a lane; strides (host memory, 11 items): m1's (lane, obs,
// row, column), m2's, then the lane strides of vec, out1 and out2.  Returns
// cudaGetLastError() after the launch (0 and no launch for no lane or no
// observation), -1 for a kind or cd it does not take.
int cannoles_obs_products_f32(int kind, int cd, int lanes, int n_obs, int n_cams, int n_pts, const int* cam,
                              const int* pt, const int* cam_order, const int* cam_start, const int* pt_order,
                              const int* pt_start, const float* m1, const float* m2, const float* vec,
                              float* out1, float* out2, const long long* strides, void* stream) {
  return launch<float>(kind, cd, lanes, n_obs, n_cams, n_pts, cam, pt, cam_order, cam_start, pt_order, pt_start,
                       m1, m2, vec, out1, out2, strides, stream);
}

int cannoles_obs_products_f64(int kind, int cd, int lanes, int n_obs, int n_cams, int n_pts, const int* cam,
                              const int* pt, const int* cam_order, const int* cam_start, const int* pt_order,
                              const int* pt_start, const double* m1, const double* m2, const double* vec,
                              double* out1, double* out2, const long long* strides, void* stream) {
  return launch<double>(kind, cd, lanes, n_obs, n_cams, n_pts, cam, pt, cam_order, cam_start, pt_order, pt_start,
                        m1, m2, vec, out1, out2, strides, stream);
}

}  // extern "C"
