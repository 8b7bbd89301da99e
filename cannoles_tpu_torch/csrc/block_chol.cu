// Blocked Cholesky for the condensed KKT system: the diagonal-block kernel
// and the whole-matrix panel loop.
//
// Replaces the two Pallas TPU kernels of cannoles_tpu/ops/pallas_chol.py:
//
// * cannoles_chol_block_{f32,f64}: `_chol_block_kernel` (lines 56-70, the
//   step-for-step body `_factor_block_inline`, lines 73-114).  One (nb, nb)
//   SPD diagonal block per lane: A = L L^T in the fixed order t = 0..nb-1,
//   then L^{-1} by substitution, and the RAW pivots d (the Schur diagonals
//   before the square root).  A pivot d_t <= tol is skipped: L gets a zero
//   column t (diagonal included) and makes no trailing update; a zero
//   diagonal of L gives a zero row of L^{-1}.
// * cannoles_chol_fused_{f32,f64}: `_chol_fused_kernel` (lines 117-158).  The
//   whole (N, N) matrix in place, N a multiple of nb: for each panel k the
//   diagonal block is factored and inverted (the kernel above, on a view with
//   row stride N), then L21 = A21 Minv^T and A22 -= L21 L21^T, both with this
//   file's tiled product kernel; at the end the strict upper triangle is
//   zeroed.  The input is the output: the wrapper copies the caller's A into
//   L first.
//
// What bounds them on an H100.  The TPU kernels keep the block (or the whole
// matrix, up to 6.6 MB) in VMEM.  A block here may use 227 KB of shared
// memory: an (nb, nb) block of nb = 256 is 256 KB in float32 and 512 KB in
// float64, and nb may reach 512.  So the block stays in device memory, where
// the 50 MB L2 keeps it resident, and only the current L column (nb values)
// lives in shared memory.  The block factor is a chain of nb dependent
// rank-1 updates inside one CTA, with a barrier between steps: it is bound by
// latency and by one SM's L2 bandwidth, not by flops (nb^3/3 multiply-adds,
// 5.6 MFLOP at nb = 256).  The inverse gives one column of L^{-1} to each
// thread (columns are independent, so no barrier between its steps).  The
// panel products are the bulk of the flops (N^3/3 in all, 0.36 GFLOP at
// N = 1024): 64x64 output tiles, 16-deep k tiles staged in shared memory,
// 4x4 outputs per thread with explicit fma() on the CUDA cores in the working
// type (float32 stays full float32, the TPU kernel's Precision.HIGHEST; no
// TF32).  The trailing update touches only tiles on or below the diagonal.
// The panel loop is a host loop of launches on the caller's stream (simple
// first design; one cooperative kernel with grid-wide barriers, or wgmma/TMA
// tiles, is later work).  With K = N/nb panels a call makes 4K launches.
//
// Arithmetic of the block step follows the plain PyTorch version
// (chol_block_reference) operation by operation: piv = sqrt(d), inv = 1/piv,
// l_i = a_i * inv, a_ij - l_i * l_j, built with --fmad=false so no multiply-add
// is contracted; L and d of a block are then the plain version's bit for bit
// on the same input.  The substitution sums and the panel products sum in
// another order than torch.matmul.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;    // output tile of the panel products
constexpr int KTILE = 16;   // depth of one shared-memory stage
constexpr int GEMM_THREADS = 256;

// Factor + invert one (nb, nb) block per CTA.  A: the block (row stride ld),
// overwritten with L (strict upper triangle zeroed); Minv: (nb, nb) dense,
// row stride nb; d: (nb,) raw pivots.  Batch strides in elements.
template <typename T>
__global__ void chol_block_kernel(T* __restrict__ A, long long sA, int ld,
                                  T* __restrict__ Minv, long long sM,
                                  T* __restrict__ d, long long sd, int nb, T tol) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* lc = reinterpret_cast<T*>(smem_raw);  // (nb,) strict L column t, 0 at rows <= t

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = (nt + 31) >> 5;
  A += blockIdx.x * sA;
  Minv += blockIdx.x * sM;
  d += blockIdx.x * sd;

  // ---- factor: nb rank-1 steps ----
  for (int t = 0; t < nb; ++t) {
    const T dt = A[(size_t)t * ld + t];
    const bool ok = dt > tol;
    const T piv = sqrt(ok ? dt : T(1));
    const T inv = ok ? T(1) / piv : T(0);
    for (int i = tid; i < nb; i += nt) {
      T v = T(0);
      if (i > t) {
        v = A[(size_t)i * ld + t] * inv;
        A[(size_t)i * ld + t] = v;
      }
      lc[i] = v;
    }
    __syncthreads();  // every thread has read d_t and lc is complete
    if (tid == 0) {
      A[(size_t)t * ld + t] = ok ? piv : T(0);
      d[t] = dt;
    }
    // trailing update of the lower triangle, one warp per row
    for (int i = t + 1 + warp; i < nb; i += nwarps) {
      const T li = lc[i];
      T* row = A + (size_t)i * ld;
      for (int j = t + 1 + lane; j <= i; j += 32) row[j] = row[j] - li * lc[j];
    }
    __syncthreads();
  }

  // ---- inverse: thread j owns column j of L^{-1} ----
  for (int j = tid; j < nb; j += nt) {
    for (int t = 0; t < j; ++t) Minv[(size_t)t * nb + j] = T(0);
    for (int t = j; t < nb; ++t) {
      const T* Lt = A + (size_t)t * ld;
      T acc = T(0);
      for (int k = j; k < t; ++k) acc = acc + Lt[k] * Minv[(size_t)k * nb + j];
      const T piv = Lt[t];
      const T inv_t = piv > T(0) ? T(1) / piv : T(0);
      Minv[(size_t)t * nb + j] = ((t == j ? T(1) : T(0)) - acc) * inv_t;
    }
  }
  __syncthreads();  // every column has read L before the upper triangle is cleared
  for (int i = warp; i < nb; i += nwarps) {
    T* row = A + (size_t)i * ld;
    for (int j = i + 1 + lane; j < nb; j += 32) row[j] = T(0);
  }
}

// C (M, Nc) = A (M, Kd) * B (Nc, Kd)^T, or C -= that product when SUB.  With
// LOWER, tiles strictly above the diagonal of C are skipped.  Row-major, row
// strides lda/ldb/ldc, batch strides sA/sB/sC over blockIdx.z.
template <typename T, bool SUB, bool LOWER>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_nt_kernel(int M, int Nc, int Kd, const T* __restrict__ A, int lda, long long sA,
               const T* __restrict__ B, int ldb, long long sB, T* __restrict__ C, int ldc,
               long long sC) {
  const int row0 = blockIdx.y * TILE;
  const int col0 = blockIdx.x * TILE;
  if (LOWER && col0 > row0 + TILE - 1) return;
  A += blockIdx.z * sA;
  B += blockIdx.z * sB;
  C += blockIdx.z * sC;
  __shared__ T As[KTILE][TILE + 1];
  __shared__ T Bs[KTILE][TILE + 1];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  T acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = T(0);

  for (int k0 = 0; k0 < Kd; k0 += KTILE) {
    for (int e = threadIdx.x; e < TILE * KTILE; e += GEMM_THREADS) {
      const int r = e / KTILE;
      const int kk = e % KTILE;
      const int gk = k0 + kk;
      const int gi = row0 + r;
      const int gj = col0 + r;
      As[kk][r] = (gi < M && gk < Kd) ? A[(size_t)gi * lda + gk] : T(0);
      Bs[kk][r] = (gj < Nc && gk < Kd) ? B[(size_t)gj * ldb + gk] : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KTILE; ++kk) {
      T a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fma(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gi = row0 + ty + 16 * i;
    if (gi >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gj = col0 + tx + 16 * j;
      if (gj >= Nc) continue;
      T* c = C + (size_t)gi * ldc + gj;
      *c = SUB ? *c - acc[i][j] : acc[i][j];
    }
  }
}

// dst (M, w) row stride ldd  <-  src (M, w) row stride lds, batched over blockIdx.y
template <typename T>
__global__ void copy_rows_kernel(int M, int w, const T* __restrict__ src, int lds, long long sS,
                                 T* __restrict__ dst, int ldd, long long sD) {
  src += blockIdx.y * sS;
  dst += blockIdx.y * sD;
  const size_t total = (size_t)M * w;
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    const size_t r = e / w, c = e % w;
    dst[r * ldd + c] = src[r * lds + c];
  }
}

// zero the strict upper triangle of each (N, N) matrix: one CTA per row
template <typename T>
__global__ void zero_upper_kernel(T* __restrict__ L, int N) {
  T* row = L + blockIdx.y * (size_t)N * N + (size_t)blockIdx.x * N;
  for (int j = blockIdx.x + 1 + threadIdx.x; j < N; j += blockDim.x) row[j] = T(0);
}

inline int block_threads(int nb) { return ((nb + 31) / 32) * 32; }

template <typename T>
int launch_block(T* A, long long sA, int ld, T* Minv, long long sM, T* d, long long sd, int B,
                 int nb, double tol, cudaStream_t st) {
  chol_block_kernel<T><<<B, block_threads(nb), nb * sizeof(T), st>>>(
      A, sA, ld, Minv, sM, d, sd, nb, static_cast<T>(tol));
  return (int)cudaGetLastError();
}

template <typename T>
int chol_block(T* L, T* Linv, T* d, int B, int nb, double tol, void* stream) {
  const long long s = (long long)nb * nb;
  return launch_block<T>(L, s, nb, Linv, s, d, nb, B, nb, tol, static_cast<cudaStream_t>(stream));
}

template <typename T>
int chol_fused(T* L, T* Linv, T* d, T* scratch, int B, int N, int nb, double tol, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int K = N / nb;
  const long long sL = (long long)N * N;
  const long long sLinv = (long long)K * nb * nb;
  const long long sS = (long long)N * nb;
  int err;
  for (int k = 0; k < K; ++k) {
    const int j0 = k * nb;
    const int j1 = j0 + nb;
    T* Lkk = L + (size_t)j0 * N + j0;
    T* Minv = Linv + (size_t)k * nb * nb;
    if ((err = launch_block<T>(Lkk, sL, N, Minv, sLinv, d + j0, N, B, nb, tol, st)) != 0) return err;
    if (j1 >= N) break;
    const int M = N - j1;
    T* A21 = L + (size_t)j1 * N + j0;
    const dim3 gp((nb + TILE - 1) / TILE, (M + TILE - 1) / TILE, B);
    gemm_nt_kernel<T, false, false><<<gp, GEMM_THREADS, 0, st>>>(
        M, nb, nb, A21, N, sL, Minv, nb, sLinv, scratch, nb, sS);
    if ((err = (int)cudaGetLastError()) != 0) return err;
    const dim3 gt((M + TILE - 1) / TILE, (M + TILE - 1) / TILE, B);
    gemm_nt_kernel<T, true, true><<<gt, GEMM_THREADS, 0, st>>>(
        M, M, nb, scratch, nb, sS, scratch, nb, sS, L + (size_t)j1 * N + j1, N, sL);
    if ((err = (int)cudaGetLastError()) != 0) return err;
    const size_t copy_blocks = ((size_t)M * nb + 255) / 256;
    const dim3 gc(copy_blocks < 1024 ? (unsigned)copy_blocks : 1024u, B);
    copy_rows_kernel<T><<<gc, 256, 0, st>>>(M, nb, scratch, nb, sS, A21, N, sL);
    if ((err = (int)cudaGetLastError()) != 0) return err;
  }
  zero_upper_kernel<T><<<dim3(N, B), 256, 0, st>>>(L, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int cannoles_chol_block_f32(void* L, void* Linv, void* d, int B, int nb, double tol, void* stream) {
  return chol_block<float>(static_cast<float*>(L), static_cast<float*>(Linv),
                           static_cast<float*>(d), B, nb, tol, stream);
}

int cannoles_chol_block_f64(void* L, void* Linv, void* d, int B, int nb, double tol, void* stream) {
  return chol_block<double>(static_cast<double*>(L), static_cast<double*>(Linv),
                            static_cast<double*>(d), B, nb, tol, stream);
}

int cannoles_chol_fused_f32(void* L, void* Linv, void* d, void* scratch, int B, int N, int nb,
                            double tol, void* stream) {
  return chol_fused<float>(static_cast<float*>(L), static_cast<float*>(Linv),
                           static_cast<float*>(d), static_cast<float*>(scratch), B, N, nb, tol,
                           stream);
}

int cannoles_chol_fused_f64(void* L, void* Linv, void* d, void* scratch, int B, int N, int nb,
                            double tol, void* stream) {
  return chol_fused<double>(static_cast<double*>(L), static_cast<double*>(Linv),
                            static_cast<double*>(d), static_cast<double*>(scratch), B, N, nb, tol,
                            stream);
}

}  // extern "C"
