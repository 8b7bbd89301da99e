// Fused batched LDLᵀ factor + solve for small symmetric KKT systems.
//
// Replaces the Pallas TPU kernel `_fused_kernel` of
// cannoles_tpu/ops/pallas_ldlt.py (lines 79-125).  For each of B independent
// systems W x = rhs it runs an unpivoted LDLᵀ in the fixed order
// k = 0..N-1.  A pivot with |d_k| <= eig_tol is skipped: its inverse is 0,
// its L column is zeroed and it makes no trailing update.  Then forward
// substitution with unit L, scaling by 1/d (0 where a pivot was skipped) and
// backward substitution.  It returns x and the RAW pivots d, which the
// caller's inertia test turns into the rho-ladder verdict.  No refinement
// step (the batched semantics of the JAX package).
//
// Design (first, simple version): one thread block per instance.  The
// block copies its (N, N) matrix into shared memory and eliminates it in
// place, exactly as the TPU kernel does with its VMEM block: after step k,
// row k holds the strict-lower column k of L (the matrix is symmetric, so
// row k == column k when it is read).  The trailing rank-1 update of step k
// is spread over the block's threads; the forward substitution is spread
// over the threads too, and the backward substitution's dot products are
// reduced by warp 0 with shuffles.
//
// What bounds it on an H100: shared memory.  A block holds
// (N*N + 2N) * sizeof(T) bytes, at most 227 KB (232,448 bytes) with the
// opt-in attribute, so N <= 240 in float32 and N <= 169 in float64
// (`max_n` in ops/fused_ldlt.py holds the same formula).  The work is
// ~N^3/3 multiply-adds per instance, tiny at the main path's shapes
// (N = 5 at B = 16,384 and N = 73 at B = 256), so the kernel is bound by
// latency: N barriers per elimination and 2N per substitution.  At N = 5 a
// 32-thread block leaves most of its threads idle; packing many instances
// into one block, lanes-last as the TPU kernel does, is later work.
//
// Arithmetic follows the plain PyTorch version (fused_ldlt_solve_reference)
// operation by operation: the update is W[i][j] - (d_k * l_i) * l_j, and
// the library is built with --fmad=false so that no multiply-add is
// contracted.  Only the backward substitution's sums are taken in another
// order.  Entries at or above the diagonal that the reference updates with
// a zero product are not touched here; for finite inputs that is the same.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__device__ __forceinline__ T abs_val(T v) { return v < T(0) ? -v : v; }

template <typename T>
__global__ void fused_ldlt_kernel(const T* __restrict__ W, const T* __restrict__ rhs,
                                  T* __restrict__ x, T* __restrict__ d, int N, T eig_tol) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* A = reinterpret_cast<T*>(smem_raw);  // (N, N), eliminated in place
  T* xs = A + N * N;                      // (N,) rhs -> solution
  T* ds = xs + N;                         // (N,) raw pivots

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const size_t b = blockIdx.x;
  const T* Wb = W + b * (size_t)N * N;
  for (int t = tid; t < N * N; t += nt) A[t] = Wb[t];
  for (int t = tid; t < N; t += nt) xs[t] = rhs[b * N + t];
  __syncthreads();

  // ---- factorization ----
  for (int k = 0; k < N; ++k) {
    const T dk = A[k * N + k];
    const T inv = (abs_val(dk) > eig_tol) ? T(1) / dk : T(0);
    __syncthreads();  // every thread has read d_k before row k is rewritten
    T* row = A + k * N;
    for (int i = tid; i < N; i += nt) row[i] = (i > k) ? row[i] * inv : T(0);
    if (tid == 0) ds[k] = dk;
    __syncthreads();
    const int M = N - k - 1;
    for (int t = tid; t < M * M; t += nt) {
      const int i = k + 1 + t / M;
      const int j = k + 1 + t % M;
      A[i * N + j] = A[i * N + j] - (dk * row[i]) * row[j];
    }
    __syncthreads();
  }

  // ---- forward substitution with unit L: y_i -= L[i,k] y_k ----
  for (int k = 0; k < N; ++k) {
    const T yk = xs[k];
    const T* lk = A + k * N;
    __syncthreads();
    for (int i = tid + k + 1; i < N; i += nt) xs[i] = xs[i] - lk[i] * yk;
    __syncthreads();
  }

  // ---- diagonal scale by 1/d, 0 at skipped pivots ----
  for (int i = tid; i < N; i += nt) {
    const T di = ds[i];
    const T inv = (abs_val(di) > eig_tol) ? T(1) / di : T(0);
    xs[i] = xs[i] * inv;
  }
  __syncthreads();

  // ---- backward substitution: x_k -= sum_{i>k} L[i,k] x_i (warp 0) ----
  if (tid < 32) {
    for (int k = N - 1; k >= 0; --k) {
      const T* lk = A + k * N;
      T s = T(0);
      for (int i = k + 1 + tid; i < N; i += 32) s = s + lk[i] * xs[i];
      for (int off = 16; off > 0; off >>= 1) s = s + __shfl_down_sync(0xffffffffu, s, off);
      if (tid == 0) xs[k] = xs[k] - s;
      __syncwarp();
    }
  }
  __syncthreads();

  for (int t = tid; t < N; t += nt) {
    x[b * N + t] = xs[t];
    d[b * N + t] = ds[t];
  }
}

template <typename T>
int launch(const T* W, const T* rhs, T* x, T* d, int B, int N, double eig_tol, void* stream) {
  const size_t smem = (size_t(N) * N + 2 * size_t(N)) * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(fused_ldlt_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = N <= 16 ? 32 : (N <= 64 ? 128 : 256);
  fused_ldlt_kernel<T><<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      W, rhs, x, d, N, static_cast<T>(eig_tol));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int cannoles_fused_ldlt_f32(const void* W, const void* rhs, void* x, void* d, int B, int N,
                            double eig_tol, void* stream) {
  return launch<float>(static_cast<const float*>(W), static_cast<const float*>(rhs),
                       static_cast<float*>(x), static_cast<float*>(d), B, N, eig_tol, stream);
}

int cannoles_fused_ldlt_f64(const void* W, const void* rhs, void* x, void* d, int B, int N,
                            double eig_tol, void* stream) {
  return launch<double>(static_cast<const double*>(W), static_cast<const double*>(rhs),
                        static_cast<double*>(x), static_cast<double*>(d), B, N, eig_tol, stream);
}

}  // extern "C"
