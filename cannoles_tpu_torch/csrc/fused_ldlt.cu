// Fused batched LDLᵀ factor + solve for small symmetric KKT systems.
//
// Replaces the Pallas TPU kernel `_fused_kernel` of
// cannoles_tpu/ops/pallas_ldlt.py (lines 79-125).  For each of B independent
// systems W x = rhs it runs an unpivoted LDLᵀ in the fixed order
// k = 0..N-1.  A pivot with |d_k| <= eig_tol is skipped: its inverse is 0,
// its L column is zero and it makes no trailing update.  Then forward
// substitution with unit L, scaling by 1/d (0 where a pivot was skipped) and
// backward substitution.  It returns x and the RAW pivots d, which the
// caller's inertia test turns into the rho-ladder verdict.  No refinement
// step (the batched semantics of the JAX package).
//
// What bounds it on an H100.  The work is ~N^3/3 multiply-adds per system
// and the bytes are W read once: at the main path's shapes (N = 5,
// B = 16,384 and N = 73, B = 256) the byte bound is about a microsecond and
// the operation bound less.  What a kernel can reach is set by latency: the
// N pivots of one system form a chain of dependent steps, and each step is
// only as wide as the trailing triangle.  So there are two mappings, chosen
// by N in launch(); each is the kernel for its range of N.
//
// N <= kThreadMaxN: one thread per system.  A block takes TB = 32
// consecutive systems; their TB*N*N values are contiguous in W, so the
// block loads them with 16-byte loads and stores them lanes-last in shared
// memory, A[(i*N + j)*LS + t] with LS = TB + 1: the TPU kernel's (N, N, TB)
// layout, padded by one lane so that the transposing stores of the load
// are free of bank conflicts too.  Thread t then moves its upper triangle
// into registers (N is a template parameter, every loop unrolled) and
// eliminates and solves with no barrier and no shared memory traffic: one
// barrier after the load, one before x and d are written back.  Threads
// past the ragged end of B only help with the load and the store.  One
// thread's chain is ~N^3/6 updates, so as N grows it becomes longer than a
// block's chain of N barriers.  Where they cross depends on B: measured on
// an H100 (chip_smoke.py phase 3, PERF.md), one thread per system is ahead
// up to N = 16 at the headline's B = 16,384 and behind from N = 4 at
// B = 256; kThreadMaxN = 16 serves the main path's shapes.
//
// Larger N: one block of 16 x 16 threads per system, one barrier per
// pivot.  Thread (ty, tx) owns the entries (i, j) = (ty + 16r, tx + 16c),
// r, c < C = ceil(N/16), and keeps the upper tiles (c >= r) in registers
// (C is a template parameter, every loop over the tiles unrolled: no
// division or modulo, all loads of a step in flight at once).  Shared
// memory holds each row once it is final, with an odd row stride
// ld = N | 1 (the column reads of the backward solve are then free of bank
// conflicts).  In step k every thread reads row k and 1/d_k, forms
// d_k * l_i and l_j = A[k][j] * (1 / d_k) for its rows and columns and
// updates its registers; the owners of row k + 1, now final, write it out,
// and the owner of (k + 1, k + 1) writes 1/d_{k+1} into the unused lower
// triangle.  One barrier at the top of each step orders the steps.  The
// steps go in phases of 16, one per row tile, so that the tiles above the
// current row tile, which are final, are skipped at compile time.  The
// forward solve is folded into the elimination: thread i updates
// y_i -= l_i * y_k in step k.  The backward solve keeps x_i in thread i's
// register and goes up in blocks of 32 rows: the warp that owns a block
// solves it with shuffles, publishes it, and after one barrier every thread
// above subtracts its 32 terms.  N + ceil(N/32) barriers per system in all
// (76 at N = 73).  Shared memory, (N*ld + N) values, caps N at 240 in
// float32 and 169 in float64 (`max_n` in ops/fused_ldlt.py).
//
// Pivots bit for bit equal to the plain PyTorch version
// (fused_ldlt_solve_reference): the library is built with --fmad=false, and
// every stored entry gets its updates in ascending k as
// A[i][j] - (d_k * l_i) * l_j with l_m = A[k][m] * (1 / d_k) and the row
// index i in the first product, exactly the reference's expression.  The
// reference reads row k (entries (k, j >= k)), and A[i][j], A[j][i] round
// differently, so both mappings keep the upper triangle i <= j.  A skipped
// pivot's zero L column is subtracted as the reference subtracts it.  The
// forward solve and the diagonal scale are the reference's operations too;
// only the backward solve sums in another order.  One thread per system
// sums each row pairwise, in the order of a 32-lane shuffle reduction: the
// solver's float32 trajectories follow the last bit of x, and this is the
// order in which a kernel that reduces each row in one warp sums it (see
// PERF.md on the headline rung).

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kSmemMax = 232448;    // shared memory a block may use on sm_90
constexpr int kThreadMaxN = 16;     // one thread per system up to this N
constexpr int kTile = 16;           // the larger mapping's block is kTile x kTile threads
constexpr int kBlockThreads = kTile * kTile;
constexpr int kBlockMaxC = 15;      // ceil(240 / kTile): the float32 cap

template <typename T>
__device__ __forceinline__ T safe_inv(T v, T tol) {
  return (v < T(0) ? -v : v) > tol ? T(1) / v : T(0);
}

template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
};
template <>
struct Vec16<double> {
  using type = double2;
};

// src[0, count) -> dst lanes-last: element e, entry e % PER of system
// e / PER, goes to dst[(e % PER) * ls + e / PER].  16-byte loads when src is
// aligned to 16 bytes, then the remainder one by one.
template <typename T, int PER>
__device__ __forceinline__ void load_lanes_last(T* dst, const T* __restrict__ src, int count,
                                                int ls) {
  constexpr int V = 16 / sizeof(T);
  using VT = typename Vec16<T>::type;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int nv = count / V;
    const VT* s = reinterpret_cast<const VT*>(src);
    for (int v = threadIdx.x; v < nv; v += blockDim.x) {
      union {
        VT v;
        T e[V];
      } u;
      u.v = s[v];
#pragma unroll
      for (int c = 0; c < V; ++c) {
        const int e = v * V + c;
        const int sys = e / PER;
        dst[(e - sys * PER) * ls + sys] = u.e[c];
      }
    }
    done = nv * V;
  }
  for (int e = done + threadIdx.x; e < count; e += blockDim.x) {
    const int sys = e / PER;
    dst[(e - sys * PER) * ls + sys] = src[e];
  }
}

// One thread per system, blockDim.x systems per block; the system's upper
// triangle lives in registers.
template <typename T, int N>
__global__ void __launch_bounds__(128)
    ldlt_thread_per_system(const T* __restrict__ W, const T* __restrict__ rhs, T* __restrict__ x,
                           T* __restrict__ d, int B, T eig_tol) {
  const int TB = blockDim.x, LS = TB + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* A = reinterpret_cast<T*>(smem_raw);  // A[(i*N + j)*LS + t]; then d at A[i*LS + t]
  T* Y = A + N * N * LS;                  // Y[i*LS + t]: rhs, then x

  const int t = threadIdx.x;
  const long long b0 = (long long)blockIdx.x * TB;
  const int nb = (int)min((long long)TB, (long long)B - b0);
  load_lanes_last<T, N * N>(A, W + b0 * N * N, nb * N * N, LS);
  load_lanes_last<T, N>(Y, rhs + b0 * N, nb * N, LS);
  __syncthreads();

  if (t < nb) {
    T a[N][N], y[N], dd[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      y[i] = Y[i * LS + t];
#pragma unroll
      for (int j = i; j < N; ++j) a[i][j] = A[(i * N + j) * LS + t];
    }
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const T dk = dd[k] = a[k][k];
      const T inv = safe_inv(dk, eig_tol);
#pragma unroll
      for (int j = k + 1; j < N; ++j) a[k][j] = a[k][j] * inv;  // row k: L column k
#pragma unroll
      for (int i = k + 1; i < N; ++i) {
        y[i] = y[i] - a[k][i] * y[k];  // forward substitution, folded in
        const T dli = dk * a[k][i];
#pragma unroll
        for (int j = i; j < N; ++j) a[i][j] = a[i][j] - dli * a[k][j];
      }
    }
    // scale by 1/d and substitute backward: x_k = y_k * (1/d_k) - s_k, with
    // s_k = sum_{i>k} l^k_i x_i summed pairwise as a 32-lane shuffle
    // reduction sums the terms p = i - k - 1: ((t0 + t16) + (t8 + t24)) + ...
#pragma unroll
    for (int k = N - 1; k >= 0; --k) {
      constexpr int kLanes = 32;
      const int m = N - k - 1;  // terms
      T v[N];
#pragma unroll
      for (int p = 0; p < m; ++p) v[p] = a[k][k + 1 + p] * y[k + 1 + p];
#pragma unroll
      for (int w = kLanes / 2; w > 0; w /= 2) {
#pragma unroll
        for (int p = 0; p < w; ++p)
          if (p + w < m) v[p] = v[p] + v[p + w];
      }
      y[k] = y[k] * safe_inv(dd[k], eig_tol) - (m > 0 ? v[0] : T(0));
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      Y[i * LS + t] = y[i];
      A[i * LS + t] = dd[i];
    }
  }
  __syncthreads();

  for (int e = t; e < nb * N; e += TB) {
    const int sys = e / N;
    const int i = e - sys * N;
    x[b0 * N + e] = Y[i * LS + sys];
    d[b0 * N + e] = A[i * LS + sys];
  }
}

// One block of kTile x kTile threads per system, one barrier per pivot.
// Thread (ty, tx) owns the entries (ty + kTile*r, tx + kTile*c), r, c < C =
// ceil(N / kTile), and keeps those of the tiles c >= r (the others lie
// below the diagonal) in registers, E[r][c].
template <typename T, int C>
__global__ void __launch_bounds__(kBlockThreads)
    ldlt_block_per_system(const T* __restrict__ W, const T* __restrict__ rhs, T* __restrict__ x,
                          T* __restrict__ d, int N, T eig_tol) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = N | 1;
  T* S = reinterpret_cast<T*>(smem_raw);  // (N, ld): row k once it is final; 1/d_k at (k, 0)
  T* Y = S + N * ld;                      // rhs -> y; then x_k as it is published

  const int tid = threadIdx.x;
  const int ty = tid / kTile, tx = tid % kTile;
  const size_t b = blockIdx.x;
  const T* Wb = W + b * N * N;
  T E[C][C];
#pragma unroll
  for (int r = 0; r < C; ++r) {
    const int i = ty + kTile * r;
#pragma unroll
    for (int c = r; c < C; ++c) {
      const int j = tx + kTile * c;
      E[r][c] = T(0);
      if (i <= j && j < N) S[i * ld + j] = E[r][c] = Wb[i * N + j];
    }
  }
  if (tid < N) Y[tid] = rhs[b * N + tid];

  // Step k publishes row n = k + 1, which lies in row tile p = n / kTile.
  // The steps go in phases of one p each, so that p is a constant: every
  // entry of the tiles above row tile p is final and skipped.  In the
  // others, entries at or above row k and below the diagonal get updates
  // too, from values that are never used: they are never published again.
#pragma unroll
  for (int p = 0; p < C; ++p) {
    const int k_end = min(N - 1, kTile * p + kTile - 1);
    for (int k = max(0, kTile * p - 1); k < k_end; ++k) {
      __syncthreads();  // row k, 1/d_k and y_k are final
      const T* rk = S + k * ld;
      const T dk = rk[k];
      const T inv = k == 0 ? safe_inv(dk, eig_tol) : rk[0];
      if (tid > k && tid < N) Y[tid] = Y[tid] - (rk[tid] * inv) * Y[k];
      // (reads past column N stay inside the buffer and are never used)
      T dli[C], lj[C];
#pragma unroll
      for (int c = p; c < C; ++c) {
        dli[c] = dk * (rk[ty + kTile * c] * inv);
        lj[c] = rk[tx + kTile * c] * inv;
      }
#pragma unroll
      for (int r = p; r < C; ++r) {
#pragma unroll
        for (int c = r; c < C; ++c) E[r][c] = E[r][c] - dli[r] * lj[c];
      }
      // row n is final: its owners publish it, and the owner of (n, n)
      // publishes 1/d_n
      const int n = k + 1;
      if (ty == n - kTile * p) {
#pragma unroll
        for (int c = p; c < C; ++c) {
          const int j = tx + kTile * c;
          if (j >= n && j < N) S[n * ld + j] = E[p][c];
        }
        if (tx == ty) S[n * ld] = safe_inv(E[p][p], eig_tol);
      }
    }
  }
  __syncthreads();

  // backward substitution, x_i -= l^i_k x_k for k = N-1 down to i+1, in
  // blocks of 32 rows from the bottom: warp w solves its own rows
  // [32w, 32w + 32) with shuffles, publishes them, and after one barrier
  // every thread above the block subtracts the block's 32 terms
  T xi = T(0), di = T(0), invi = T(0);
  if (tid < N) {
    di = S[tid * ld + tid];
    invi = safe_inv(di, eig_tol);
    xi = Y[tid] * invi;
  }
  const int warp = tid / 32;
  for (int w = (N - 1) / 32; w >= 0; --w) {
    const int lo = 32 * w, hi = min(N, lo + 32);
    if (warp == w) {
      for (int k = hi - 1; k > lo; --k) {
        const T xk = __shfl_sync(0xffffffffu, xi, k - lo);
        if (tid < k) xi = xi - (S[tid * ld + k] * invi) * xk;
      }
      if (tid < N) Y[tid] = xi;
    }
    __syncthreads();
    if (tid < lo)
      for (int k = hi - 1; k >= lo; --k) xi = xi - (S[tid * ld + k] * invi) * Y[k];
  }
  if (tid < N) {
    x[b * N + tid] = xi;
    d[b * N + tid] = di;
  }
}

// Lets `Kernel` use up to kSmemMax bytes of shared memory; the attribute is
// set once per device.
template <auto Kernel>
cudaError_t allow_smem() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (e == cudaSuccess) done.fetch_or(bit);
  return e;
}

template <typename T, int N = 1>
cudaError_t launch_thread_per_system(const T* W, const T* rhs, T* x, T* d, int B, int n, T tol,
                                     int tb, cudaStream_t stream) {
  if constexpr (N > kThreadMaxN) {
    return cudaErrorInvalidValue;
  } else {
    if (n != N) return launch_thread_per_system<T, N + 1>(W, rhs, x, d, B, n, tol, tb, stream);
    const size_t smem = size_t(N) * (N + 1) * (tb + 1) * sizeof(T);
    if (smem > kSmemMax) return cudaErrorInvalidValue;
    cudaError_t e = allow_smem<&ldlt_thread_per_system<T, N>>();
    if (e != cudaSuccess) return e;
    const unsigned blocks = unsigned((B + (long long)tb - 1) / tb);
    ldlt_thread_per_system<T, N><<<blocks, tb, smem, stream>>>(W, rhs, x, d, B, tol);
    return cudaGetLastError();
  }
}

template <typename T, int C = 1>
cudaError_t launch_block_per_system(const T* W, const T* rhs, T* x, T* d, int B, int n, T tol,
                                    cudaStream_t stream) {
  if constexpr (C > kBlockMaxC) {
    return cudaErrorInvalidValue;
  } else {
    if (n > C * kTile) return launch_block_per_system<T, C + 1>(W, rhs, x, d, B, n, tol, stream);
    const size_t smem = (size_t(n) * (n | 1) + n) * sizeof(T);
    if (smem > kSmemMax) return cudaErrorInvalidValue;
    cudaError_t e = allow_smem<&ldlt_block_per_system<T, C>>();
    if (e != cudaSuccess) return e;
    ldlt_block_per_system<T, C><<<B, kBlockThreads, smem, stream>>>(W, rhs, x, d, n, tol);
    return cudaGetLastError();
  }
}

// route 0: the mapping for N (one thread per system, 32 systems per block,
// up to kThreadMaxN; else one block per system); 32, 64 or 128: one thread
// per system with that many systems per block; -1: one block per system.
template <typename T>
int launch(const T* W, const T* rhs, T* x, T* d, int B, int N, double eig_tol, int route,
           void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const T tol = static_cast<T>(eig_tol);
  if (route == 0) route = N <= kThreadMaxN ? 32 : -1;
  if (route == 32 || route == 64 || route == 128)
    return (int)launch_thread_per_system<T>(W, rhs, x, d, B, N, tol, route, stream);
  if (route == -1) return (int)launch_block_per_system<T>(W, rhs, x, d, B, N, tol, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int cannoles_fused_ldlt_f32(const void* W, const void* rhs, void* x, void* d, int B, int N,
                            double eig_tol, int route, void* stream) {
  return launch<float>(static_cast<const float*>(W), static_cast<const float*>(rhs),
                       static_cast<float*>(x), static_cast<float*>(d), B, N, eig_tol, route,
                       stream);
}

int cannoles_fused_ldlt_f64(const void* W, const void* rhs, void* x, void* d, int B, int N,
                            double eig_tol, int route, void* stream) {
  return launch<double>(static_cast<const double*>(W), static_cast<const double*>(rhs),
                        static_cast<double*>(x), static_cast<double*>(d), B, N, eig_tol, route,
                        stream);
}

int cannoles_fused_ldlt_thread_max_n(void) { return kThreadMaxN; }

}  // extern "C"
