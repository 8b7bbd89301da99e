// Blocked Cholesky for the condensed KKT system: one persistent cooperative
// kernel that factors every lane's matrix, inverts its diagonal blocks and
// records the raw pivots.
//
// Replaces the two Pallas TPU kernels of cannoles_tpu/ops/pallas_chol.py:
//
// * `_chol_block_kernel` (lines 56-70, the step-for-step body
//   `_factor_block_inline`, lines 73-114): one (nb, nb) SPD diagonal block
//   per lane: A = L L^T in the fixed order t = 0..nb-1, then L^{-1}, and the
//   RAW pivots d (the Schur diagonals before the square root).  A pivot
//   d_t <= tol is skipped: L gets a zero column t (diagonal included) and
//   makes no trailing update; a zero diagonal of L gives a zero row of
//   L^{-1}.  Entry cannoles_chol_{f32,f64} with N = nb.
// * `_chol_fused_kernel` (lines 117-158): the whole (N, N) matrix, N a
//   multiple of nb, with the inverse of each of its K = N/nb diagonal
//   blocks.  The same entry with N = K nb.
//
// What bounds it on an H100.  The work is N^3/3 flops for the factor and
// nb^3/3 per block inverse (0.38 GFLOP at N = 1024, nb = 256: 5.7 us at the
// card's float32 rate outside the tensor cores), the bytes a few MB (A read,
// L, L^{-1} and d written: 9.4 MB, 2.8 us); one f64 nb = 256 block is 1.6 MB,
// 0.47 us.  What holds a factorization back is its chain of N dependent
// pivots, each a correctly rounded square root and reciprocal.  The first
// port ran the nb pivots of a block as nb CTA-wide steps on one SM, each
// rewriting the block's lower triangle through L2, inverted with one thread
// per column, and left 131 of 132 SMs idle at B = 1.
//
// The design.  A right-looking factorization by sub-panels of W = 32
// columns over the whole matrix, in one cooperative launch of a persistent
// grid (as many CTAs of 256 threads as the widest phase has tiles, up to
// two per SM in float32 and one in float64), with a grid-wide barrier
// between phases.  The matrix stays in device memory (L2 holds it: 4 MB at
// f32 N = 1024) and moves through shared memory in 32x32 tiles, every
// thread's loads of a tile in flight at once.  Shared memory could hold one
// f32 nb = 256 block but not an f64 one or nb = 512, and a block on one SM
// is the serial chain this design removes.  Phases:
//   - first: each CTA factors tile (0, 0) with one warp (lane r holds row r
//     in registers; column t goes to the other lanes by shuffles, no CTA
//     barrier) and solves 8 tiles of rows below it, a warp per tile and a
//     lane per row, in registers;
//   - update p = 0..: the tiles (I, J), p < J <= I, get sub-panel p's 32
//     columns, one tile per CTA over the whole grid.  The CTA of tile
//     (p+1, p+1) factors it and writes its pivots; each CTA of a tile
//     (I, p+1) below updates that diagonal tile as well, factors it itself
//     (the same operations on the same data: the same bits) and solves its
//     rows against it, so sub-panel p+1's panel costs no barrier of its own.
//     The factored diagonal tile is staged in scratch, because the others
//     read it unfactored in the same phase, and copied into L a phase later;
//   - inverse: one warp per 32x32 diagonal sub-block of each (nb, nb) block
//     (a lane per column), then levels of doubling: a pair of groups of s
//     sub-blocks with known inverses gets its off-diagonal part
//     -X_right L_rl X_left as two grid-wide stages of 32x32 tile products.
// The strict upper triangles of L and of each L^{-1} block are zeroed in
// the first phase by CTAs with no tile to factor.  So a factorization is
// one launch with ceil(N/32) + 2 log2(nb/32) grid barriers (38 at N = 1024,
// nb = 256), not 4K+1 launches of N CTA-wide steps on one SM.
//
// Arithmetic.  Every element of the factor gets its updates in ascending
// column order as a multiply and then a subtract (built with --fmad=false),
// and the pivots come from the plain PyTorch version's expressions
// (piv = sqrt(d), inv = 1/piv as a correctly rounded reciprocal,
// l = a*inv, a - l_i*l_j): a delayed update in ascending order is the
// rank-1 sweep's sequence of operations, so L and d of one block (N = nb)
// are the plain version's bit for bit.  On a whole matrix the plain version
// forms L21 = A21 Minv^T and the trailing update with torch.matmul, which
// sums in another order.  The inverse's products use fma() in any order.
// float32 stays float32 (no TF32).  N and nb need not be multiples of 32:
// the last tile of the matrix and of each block is padded with identity in
// shared memory and masked on store.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int W = 32;                // sub-panel width, tile edge
constexpr int TP = W + 1;            // shared-memory pitch of a tile
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;  // 8
constexpr int PER = W / WARPS;       // tile rows per thread in CTA-wide tile work (4)
constexpr int SMEM_TILES = WARPS + 1;
constexpr int QB = 4;                // chunks of an inverse product loaded at once
constexpr unsigned FULL = 0xffffffffu;

// CTAs per SM the kernel is built for: float64 gets the whole register file
template <typename T> struct CtasPerSm { static constexpr int value = 2; };
template <> struct CtasPerSm<double> { static constexpr int value = 1; };

template <typename T>
struct Job {
  T* L;        // (B, N, N) row-major: A on entry (lower part used), L on exit
  T* Linv;     // (B, K, nb, nb): the inverses of L's diagonal blocks
  T* d;        // (B, N): raw pivots
  T* scratch;  // (B, max(K nb nb, W W)): a staged diagonal tile, then the inverse's products
  int B, N, nb;
  T tol;
};

__device__ __forceinline__ int tiles_of(int n) { return (n + W - 1) / W; }

// lane b's part of the scratch buffer
template <typename T>
__device__ __forceinline__ T* scratch_of(const Job<T>& job, int b) {
  const size_t per = max((size_t)job.N * job.nb, (size_t)W * W);
  return job.scratch + (size_t)b * per;
}
__device__ __forceinline__ float rcp(float x) { return __frcp_rn(x); }    // == 1.0f / x
__device__ __forceinline__ double rcp(double x) { return __drcp_rn(x); }  // == 1.0 / x

// A tile moves between memory and shared memory through registers, NTH
// threads with W*W/NTH elements each (element tid + i NTH), so that all of a
// thread's loads are in flight before the first store.
template <int NTH, typename T>
struct Frag {
  T v[W * W / NTH];
};

// R <- M[r0 + r][c0 + c] (row stride ld) for r < nr and c < nc; outside,
// the identity (eye) or zero.
template <int NTH, typename T>
__device__ __forceinline__ void fetch(Frag<NTH, T>& R, const T* M, size_t ld, int r0, int c0, int nr,
                                      int nc, bool eye, int tid) {
#pragma unroll
  for (int i = 0; i < W * W / NTH; ++i) {
    const int e = tid + i * NTH, r = e / W, c = e % W;
    const T* src = M + (size_t)(r0 + r) * ld + c0 + c;
    R.v[i] = (r < nr && c < nc) ? *src : (eye && r == c ? T(1) : T(0));
  }
}

template <int NTH, typename T>
__device__ __forceinline__ void put(T* S, const Frag<NTH, T>& R, int tid) {
#pragma unroll
  for (int i = 0; i < W * W / NTH; ++i) {
    const int e = tid + i * NTH;
    S[(e / W) * TP + e % W] = R.v[i];
  }
}

template <int NTH, typename T>
__device__ __forceinline__ void load_tile(T* S, const T* M, size_t ld, int r0, int c0, int nr, int nc,
                                          bool eye, int tid) {
  Frag<NTH, T> R;
  fetch<NTH>(R, M, ld, r0, c0, nr, nc, eye, tid);
  put(S, R, tid);
}

// M[r0 + r][c0 + c] <- S (or 0 above the diagonal when lower) for r < nr, c < nc
template <int NTH, typename T>
__device__ __forceinline__ void store_tile(T* M, size_t ld, int r0, int c0, int nr, int nc, const T* S,
                                           bool lower, int tid) {
#pragma unroll
  for (int i = 0; i < W * W / NTH; ++i) {
    const int e = tid + i * NTH, r = e / W, c = e % W;
    if (r < nr && c < nc) M[(size_t)(r0 + r) * ld + c0 + c] = (lower && c > r) ? T(0) : S[r * TP + c];
  }
}

template <typename T>
__device__ __forceinline__ void zero_tile(T* M, size_t ld, int r0, int c0, int nr, int nc, int tid) {
#pragma unroll
  for (int i = 0; i < W * W / THREADS; ++i) {
    const int e = tid + i * THREADS, r = e / W, c = e % W;
    if (r < nr && c < nc) M[(size_t)(r0 + r) * ld + c0 + c] = T(0);
  }
}

// acc[m] (row warp + WARPS m, column lane) += (P Q)[row][lane], P and Q W x W
// tiles in shared memory
template <typename T>
__device__ __forceinline__ void tile_fma(T (&acc)[PER], const T* P, const T* Q, int lane, int warp) {
  for (int q = 0; q < W; ++q) {
    const T x = Q[q * TP + lane];
#pragma unroll
    for (int m = 0; m < PER; ++m) acc[m] = fma(P[(warp + WARPS * m) * TP + q], x, acc[m]);
  }
}

// One warp factors the tile S in place, lower triangle, in the plain
// version's order (rows and columns past the matrix are identity padding).
// Lane r holds row r in registers; column t goes to the other lanes by
// shuffles, and lane t+1 forms the next pivot from its own l, so the chain
// from pivot to pivot is a square root, a reciprocal, two multiplies, a
// subtract and one shuffle.  Entries above the diagonal take harmless
// updates (they are dropped when the tile is stored).  Lane t returns the
// raw pivot d_t.
template <typename T>
__device__ T factor_tile(T* S, T tol, int lane) {
  T a[W];
#pragma unroll
  for (int j = 0; j < W; ++j) a[j] = S[lane * TP + j];
  T mine = T(0);
  T dnext = __shfl_sync(FULL, a[0], 0);
#pragma unroll
  for (int t = 0; t < W; ++t) {
    const T dt = dnext;
    const bool ok = dt > tol;
    const T piv = sqrt(ok ? dt : T(1));
    const T inv = ok ? rcp(piv) : T(0);
    const T l = lane > t ? a[t] * inv : T(0);
    mine = lane == t ? dt : mine;
    a[t] = lane > t ? l : (lane == t ? (ok ? piv : T(0)) : a[t]);
    if (t + 1 < W) dnext = __shfl_sync(FULL, a[t + 1] - l * l, t + 1);  // lane t+1's own update
#pragma unroll
    for (int j = t + 1; j < W; ++j) a[j] = a[j] - l * __shfl_sync(FULL, l, j);
  }
#pragma unroll
  for (int j = 0; j < W; ++j) S[lane * TP + j] = a[j];
  __syncwarp();
  return mine;
}

// One warp solves the 32 rows in X (lane r: row r, in registers) against
// the factored diagonal tile Ld of their sub-panel: l_rt = (a_rt - sum_{s<t}
// l_rs l_ts) inv_t, subtracting in ascending s.
template <typename T>
__device__ void solve_rows(T* X, const T* Ld, const T* inv, int lane) {
  T v[W];
#pragma unroll
  for (int s = 0; s < W; ++s) v[s] = X[lane * TP + s];
#pragma unroll
  for (int t = 0; t < W; ++t) {
    T x = v[t];
#pragma unroll
    for (int s = 0; s < t; ++s) x = x - v[s] * Ld[t * TP + s];
    v[t] = x * inv[t];
  }
#pragma unroll
  for (int s = 0; s < W; ++s) X[lane * TP + s] = v[s];
  __syncwarp();
}

// inv_t = 1/sqrt(d_t) where d_t > tol, else 0 (the factor's expressions)
template <typename T>
__device__ __forceinline__ T inv_pivot(T dt, T tol) {
  return dt > tol ? rcp(sqrt(dt)) : T(0);
}

// Warp 0 factors the diagonal tile D (updated, identity-padded) and puts
// the inverse pivots in inv; returns the raw pivot d_t in lane t of warp 0.
template <typename T>
__device__ __forceinline__ T factor_diag(T* D, T* inv, T tol, int lane) {
  const T dt = factor_tile(D, tol, lane);
  inv[lane] = inv_pivot(dt, tol);
  __syncwarp();
  return dt;
}

// Sub-panel 0.  Each CTA factors tile (0, 0) itself (the same operations
// on the same data give the same bits everywhere) and solves 8 tiles of
// rows below it, one warp per tile; the CTA with the first rows writes tile
// (0, 0) and its pivots.  Spare CTAs zero the tiles above the diagonal of L
// and of each L^{-1} block, one row of tiles each.
template <typename T>
__device__ void first_phase(const Job<T>& job, T* sm) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int N = job.N, nt = tiles_of(N), M = nt - 1;
  const int nb = job.nb, K = N / nb, ns = tiles_of(nb);
  const int G = M > 0 ? (M + WARPS - 1) / WARPS : 1;
  const long long groups = (long long)job.B * G, zl = (long long)job.B * M;
  const long long total = groups + zl + (long long)job.B * K * (ns - 1);
  T* D = sm;
  T* inv = sm + SMEM_TILES * W * TP;
  for (long long item = blockIdx.x; item < total; item += gridDim.x) {
    if (item >= groups + zl) {  // row s of tiles of L^{-1} block k, right of the diagonal
      const long long z = item - groups - zl;
      const int b = (int)(z / ((long long)K * (ns - 1)));
      const int rem = (int)(z % ((long long)K * (ns - 1)));
      const int k = rem / (ns - 1), s = rem % (ns - 1);
      T* Mk = job.Linv + ((size_t)b * K + k) * nb * nb;
      for (int s2 = s + 1; s2 < ns; ++s2)
        zero_tile(Mk, nb, s * W, s2 * W, W, min(W, nb - s2 * W), tid);
      continue;
    }
    if (item >= groups) {  // row I of tiles of L, right of the diagonal
      const long long z = item - groups;
      const int b = (int)(z % job.B), I = (int)(z / job.B);
      for (int J = I + 1; J < nt; ++J)
        zero_tile(job.L + (size_t)b * N * N, N, I * W, J * W, W, min(W, N - J * W), tid);
      continue;
    }
    const int b = (int)(item % job.B), g = (int)(item / job.B);
    T* Lb = job.L + (size_t)b * N * N;
    const int n0 = min(W, N);
    load_tile<THREADS>(D, Lb, N, 0, 0, n0, n0, true, tid);
    __syncthreads();
    if (tid < 32) {
      const T dt = factor_diag(D, inv, job.tol, lane);
      if (g == 0 && lane < n0) job.d[(size_t)b * N + lane] = dt;
    }
    __syncthreads();
    if (g == 0) {  // the other CTAs may still read tile (0, 0): stage it unless it is the last
      if (nt == 1) store_tile<THREADS>(Lb, N, 0, 0, n0, n0, D, true, tid);
      else store_tile<THREADS>(scratch_of(job, b), W, 0, 0, W, W, D, true, tid);
    }
    const int I = 1 + g * WARPS + warp;
    if (I < nt) {
      const int nr = min(W, N - I * W);
      T* X = sm + (1 + warp) * W * TP;
      load_tile<32>(X, Lb, N, I * W, 0, nr, W, false, lane);
      __syncwarp();
      solve_rows(X, D, inv, lane);
      store_tile<32>(Lb, N, I * W, 0, nr, W, X, false, lane);
    }
    __syncthreads();
  }
}

// Sub-panel p's update of the tiles (I, J), p < J <= I, and sub-panel
// p+1's panel.  The CTA of tile (p+1, p+1) factors it and writes its
// pivots; each CTA of a tile (I, p+1) below it updates that diagonal tile
// too, factors it itself (bit for bit the same result) and solves its rows
// against it, so one grid barrier per sub-panel suffices and no CTA waits
// for another within a phase.  Since those CTAs read tile (p+1, p+1) while
// it is factored, the factored tile is staged in scratch and copied into L
// by the next phase's diagonal CTA (the last one goes to L directly).
template <typename T>
__device__ void update_phase(const Job<T>& job, int p, T* sm) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int N = job.N, nt = tiles_of(N), M = nt - p - 1;
  const long long total = (long long)job.B * M * (M + 1) / 2;
  T* Li = sm;
  T* Lj = sm + W * TP;
  T* S = sm + 2 * W * TP;
  T* D = sm + 3 * W * TP;
  T* inv = sm + SMEM_TILES * W * TP;
  for (long long item = blockIdx.x; item < total; item += gridDim.x) {
    const int b = (int)(item % job.B);
    int q = (int)(item / job.B), c = 0;
    while (q >= M - c) q -= M - c++;  // column c of the lower triangle, row c + q
    const int I = p + 1 + c + q, J = p + 1 + c;
    const bool panel = J == p + 1 && I != J;  // also factors tile (J, J)
    T* Lb = job.L + (size_t)b * N * N;
    T* stage = scratch_of(job, b);
    const int nr = min(W, N - I * W), nc = min(W, N - J * W);
    if (J == p + 1 && !panel) {  // tile (p, p), staged by the previous phase, into L
      Frag<THREADS, T> f;
      fetch<THREADS>(f, stage, W, 0, 0, W, W, false, tid);
#pragma unroll
      for (int i = 0; i < W * W / THREADS; ++i) {
        const int e = tid + i * THREADS;
        Lb[(size_t)(p * W + e / W) * N + p * W + e % W] = f.v[i];
      }
    }
    {
      Frag<THREADS, T> fi, fj;
      fetch<THREADS>(fi, Lb, N, I * W, p * W, nr, W, false, tid);
      fetch<THREADS>(fj, Lb, N, J * W, p * W, nc, W, false, tid);
      put(Li, fi, tid);
      put(Lj, fj, tid);
    }
    T a[PER], e[PER];
#pragma unroll
    for (int m = 0; m < PER; ++m) {
      const int rr = warp + WARPS * m;
      a[m] = (rr < nr && lane < nc) ? Lb[(size_t)(I * W + rr) * N + J * W + lane] : T(0);
      e[m] = panel ? Lb[(size_t)(J * W + rr) * N + J * W + lane] : T(0);
    }
    __syncthreads();
    for (int s = 0; s < W; ++s) {
      const T lj = Lj[lane * TP + s];
#pragma unroll
      for (int m = 0; m < PER; ++m) {
        a[m] = a[m] - Li[(warp + WARPS * m) * TP + s] * lj;
        if (panel) e[m] = e[m] - Lj[(warp + WARPS * m) * TP + s] * lj;
      }
    }
    if (J != p + 1) {
#pragma unroll
      for (int m = 0; m < PER; ++m) {
        const int rr = warp + WARPS * m;
        if (rr < nr && lane < nc) Lb[(size_t)(I * W + rr) * N + J * W + lane] = a[m];
      }
      __syncthreads();
      continue;
    }
#pragma unroll
    for (int m = 0; m < PER; ++m) {
      const int rr = warp + WARPS * m;
      if (panel) {
        S[rr * TP + lane] = (rr < nr) ? a[m] : T(0);
        D[rr * TP + lane] = e[m];
      } else {
        D[rr * TP + lane] = (rr < nr && lane < nc) ? a[m] : (rr == lane ? T(1) : T(0));
      }
    }
    __syncthreads();
    if (tid < 32) {
      const T dt = factor_diag(D, inv, job.tol, lane);
      if (panel) {
        solve_rows(S, D, inv, lane);
      } else if (lane < nr) {
        job.d[(size_t)b * N + I * W + lane] = dt;
      }
    }
    __syncthreads();
    if (panel) {
      store_tile<THREADS>(Lb, N, I * W, J * W, nr, W, S, false, tid);
    } else if (M == 1) {
      store_tile<THREADS>(Lb, N, I * W, I * W, nr, nr, D, true, tid);
    } else {
      store_tile<THREADS>(stage, W, 0, 0, W, W, D, true, tid);
    }
    __syncthreads();
  }
}

// The 32x32 diagonal sub-blocks of every (nb, nb) block inverted, one warp
// each: lane j forms column j by substitution, in registers.
template <typename T>
__device__ void inverse_diag_phase(const Job<T>& job, T* sm) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int N = job.N, nb = job.nb, K = N / nb, ns = tiles_of(nb);
  const long long jobs = (long long)job.B * K * ns;
  const long long total = (jobs + WARPS - 1) / WARPS;
  T* X = sm + warp * W * TP;
  for (long long item = blockIdx.x; item < total; item += gridDim.x) {
    const long long wi = item * WARPS + warp;
    if (wi >= jobs) continue;
    const int b = (int)(wi / ((long long)K * ns));
    const int rem = (int)(wi % ((long long)K * ns));
    const int k = rem / ns, s = rem % ns;
    const int v = min(W, nb - s * W);
    const T* Lb = job.L + (size_t)b * N * N;
    T* Mk = job.Linv + ((size_t)b * K + k) * nb * nb;
    __syncwarp();
    load_tile<32>(X, Lb, N, k * nb + s * W, k * nb + s * W, v, v, true, lane);
    __syncwarp();
    // lane t: 1/L_tt (0 where L_tt is not positive), broadcast below
    const T piv_l = X[lane * TP + lane];
    const T inv_l = piv_l > T(0) ? rcp(piv_l) : T(0);
    T x[W];
#pragma unroll
    for (int t = 0; t < W; ++t) {
      T acc = T(0);
#pragma unroll
      for (int kk = 0; kk < t; ++kk) acc = fma(X[t * TP + kk], x[kk], acc);
      x[t] = ((t == lane ? T(1) : T(0)) - acc) * __shfl_sync(FULL, inv_l, t);
    }
#pragma unroll
    for (int t = 0; t < W; ++t)
      if (t < v && lane < v) Mk[(size_t)(s * W + t) * nb + s * W + lane] = x[t];
  }
}

// One level of the blocked inverse of every (nb, nb) block, by doubling:
// pairs of s-sub-block groups [left | right] whose inverses are known give
// the off-diagonal part of the pair's inverse, -X_right L_rl X_left, as two
// grid-parallel stages of 32x32 tile products: T = L_rl X_left into the
// scratch buffer, then X_rl = -X_right T.
template <typename T>
__device__ void inverse_level(const Job<T>& job, int s, bool second, T* sm) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int N = job.N, nb = job.nb, K = N / nb, ns = tiles_of(nb);
  const int P = (ns + 2 * s - 1) / (2 * s);
  const long long total = (long long)job.B * K * P * s * s;
  for (long long item = blockIdx.x; item < total; item += gridDim.x) {
    long long t = item;
    const int c = (int)(t % s);
    t /= s;
    const int r = (int)(t % s);
    t /= s;
    const int g = (int)(t % P);
    t /= P;
    const int k = (int)(t % K), b = (int)(t / K);
    const int left0 = 2 * s * g, right0 = left0 + s;
    if (right0 + r >= ns) continue;  // the same for every thread of the CTA
    const T* Lb = job.L + (size_t)b * N * N + (size_t)k * nb * N + (size_t)k * nb;
    T* Mk = job.Linv + ((size_t)b * K + k) * nb * nb;
    T* Sk = scratch_of(job, b) + (size_t)k * nb * nb;
    const int row = (right0 + r) * W, nr = min(W, nb - row), col = (left0 + c) * W;
    // T(r, c) = sum_{q >= c} L(right0 + r, left0 + q) X(left0 + q, left0 + c);
    // X(r, c) = -sum_{q <= r} X(right0 + r, right0 + q) T(q, c)
    const int q0 = second ? 0 : c, q1 = second ? r + 1 : s;
    T acc[PER];
#pragma unroll
    for (int m = 0; m < PER; ++m) acc[m] = T(0);
    for (int qa = q0; qa < q1; qa += QB) {
      const int qn = min(QB, q1 - qa);
      Frag<THREADS, T> fp[QB], fq[QB];
#pragma unroll
      for (int u = 0; u < QB; ++u) {
        if (u >= qn) break;
        const int q = qa + u;
        if (!second) {
          fetch<THREADS>(fp[u], Lb, N, row, (left0 + q) * W, nr, W, false, tid);
          fetch<THREADS>(fq[u], (const T*)Mk, nb, (left0 + q) * W, col, W, W, false, tid);
        } else {
          const int rq = (right0 + q) * W, nq = min(W, nb - rq);
          fetch<THREADS>(fp[u], (const T*)Mk, nb, row, rq, nr, nq, false, tid);
          fetch<THREADS>(fq[u], (const T*)Sk, nb, rq, col, nq, W, false, tid);
        }
      }
#pragma unroll
      for (int u = 0; u < QB; ++u) {
        if (u >= qn) break;
        put(sm + (2 * u) * W * TP, fp[u], tid);
        put(sm + (2 * u + 1) * W * TP, fq[u], tid);
      }
      __syncthreads();
      for (int u = 0; u < qn; ++u) tile_fma(acc, sm + (2 * u) * W * TP, sm + (2 * u + 1) * W * TP, lane, warp);
      __syncthreads();
    }
    T* dst = second ? Mk : Sk;
#pragma unroll
    for (int m = 0; m < PER; ++m) {
      const int rr = warp + WARPS * m;
      if (rr < nr) dst[(size_t)(row + rr) * nb + col + lane] = second ? -acc[m] : acc[m];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, CtasPerSm<T>::value) chol_kernel(Job<T> job) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  cg::grid_group grid = cg::this_grid();
  const int N = job.N, nt = tiles_of(N), ns = tiles_of(job.nb);

  first_phase(job, sm);
  grid.sync();
  for (int p = 0; p + 1 < nt; ++p) {
    update_phase(job, p, sm);
    grid.sync();
  }
  inverse_diag_phase(job, sm);
  for (int s = 1; s < ns; s *= 2) {
    grid.sync();
    inverse_level(job, s, false, sm);
    grid.sync();
    inverse_level(job, s, true, sm);
  }
}

template <typename T>
int chol(T* L, T* Linv, T* d, T* scratch, int B, int N, int nb, double tol, void* stream) {
  if (B <= 0 || N <= 0 || nb <= 0 || N % nb != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (SMEM_TILES * W * TP + W) * sizeof(T);
  auto kern = chol_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, occ = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, THREADS, smem)) != cudaSuccess)
    return (int)e;
  if (occ < 1) return (int)cudaErrorInvalidConfiguration;
  // as many CTAs as the widest phase has items, up to what can be co-resident
  const long long nt = (N + W - 1) / W;
  const long long blocks = (long long)(N / nb) * ((nb + W - 1) / W);
  const long long work = (long long)B * (nt * (nt - 1) / 2 > blocks ? nt * (nt - 1) / 2 : blocks);
  const long long cap = (long long)sms * (occ < CtasPerSm<T>::value ? occ : CtasPerSm<T>::value);
  const int grid = (int)(work < 1 ? 1 : (work < cap ? work : cap));
  Job<T> job{L, Linv, d, scratch, B, N, nb, static_cast<T>(tol)};
  void* args[] = {&job};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern), dim3(grid), dim3(THREADS),
                                  args, smem, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// L (B, N, N) holds A on entry and L on exit; Linv (B, N/nb, nb, nb); d (B, N);
// scratch (B, max(N nb, 1024))
int cannoles_chol_f32(void* L, void* Linv, void* d, void* scratch, int B, int N, int nb, double tol,
                      void* stream) {
  return chol<float>(static_cast<float*>(L), static_cast<float*>(Linv), static_cast<float*>(d),
                     static_cast<float*>(scratch), B, N, nb, tol, stream);
}

int cannoles_chol_f64(void* L, void* Linv, void* d, void* scratch, int B, int N, int nb, double tol,
                      void* stream) {
  return chol<double>(static_cast<double*>(L), static_cast<double*>(Linv), static_cast<double*>(d),
                      static_cast<double*>(scratch), B, N, nb, tol, stream);
}

}  // extern "C"
