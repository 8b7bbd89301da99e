// The pair accumulation of the camera-Schur system on an observation list
// (ops/schur_pairs.py, core/ba.py): for each lower-triangle camera block b,
//
//     T_b = sum over b's pairs (i, j) of X_i W_j^T,   X_i, W_j (cd x 3),
//
// the pairs being the observations i, j of one point with cam_i >= cam_j,
// sorted by target block once per scene (ops/schur_pairs.py `plan`).
//
// Replaces no TPU kernel: the JAX package's Schur engine takes the dense
// (C, P) grid and its einsum.  On an observation list the plain route is a
// bmm per pair and a scatter-add: it writes cd^2 floats per pair (3.4 GB a
// solve at BAL Dubrovnik-356's 5.9M pairs for a 41 MB matrix), and on a card
// index_add_ sums by float atomics in no fixed order, so that two runs of one
// solve could differ in their last bits and take other LM paths.
//
// What bounds it.  The bytes: X and W read once (n_obs x 2 x 3cd items), the
// pair list once, each block written once; 2 cd^2 3 flops a pair are far
// below the card's float32 rate for that traffic.
//
// Design.  One thread block per target block, cd^2 x G threads: thread
// (g, r, c) sums entry (r, c) over the pairs k = g, g + G, ... of each
// chunk, in registers; chunks of kChunk pairs' X_i and W_j rows are staged in
// shared memory first (each row 3cd contiguous items).  The G partial sums
// are added in the order g = 0, 1, ..., G - 1, and the block is written once.
// The order of every sum is fixed by the plan, so the result repeats bit for
// bit; with --fmad=false each product is rounded before its sum.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 32;  // pairs staged in shared memory a step

template <typename T, int CD, int G>
__global__ void __launch_bounds__(CD * CD * G)
schur_pairs_kernel(const T* __restrict__ X, const T* __restrict__ W, const int* __restrict__ pair_i,
                   const int* __restrict__ pair_j, const int* __restrict__ start, T* __restrict__ out) {
  constexpr int K = CD * 3;  // items of one X_i or W_j
  constexpr int NT = CD * CD * G;
  __shared__ T xs[kChunk * K];
  __shared__ T ws[kChunk * K];
  __shared__ T part[(G - 1) * CD * CD];
  const int b = blockIdx.x;
  const int s = start[b], e = start[b + 1];
  const int t = threadIdx.x;
  const int g = t / (CD * CD), q = t - g * (CD * CD);
  const int r = q / CD, c = q - r * CD;
  T acc = T(0);
  for (int base = s; base < e; base += kChunk) {
    const int n = min(kChunk, e - base);
    for (int v = t; v < n * K; v += NT) {
      const int k = v / K, off = v - k * K;
      xs[v] = X[static_cast<size_t>(pair_i[base + k]) * K + off];
      ws[v] = W[static_cast<size_t>(pair_j[base + k]) * K + off];
    }
    __syncthreads();
    for (int k = g; k < n; k += G) {
      const T* x = xs + k * K + r * 3;
      const T* w = ws + k * K + c * 3;
      acc = acc + x[0] * w[0];
      acc = acc + x[1] * w[1];
      acc = acc + x[2] * w[2];
    }
    __syncthreads();
  }
  if (g > 0) part[(g - 1) * CD * CD + q] = acc;
  __syncthreads();
  if (g == 0) {
    for (int h = 1; h < G; ++h) acc = acc + part[(h - 1) * CD * CD + q];
    out[static_cast<size_t>(b) * CD * CD + q] = acc;
  }
}

template <typename T>
int launch(const T* X, const T* W, const int* pi, const int* pj, const int* start, int n_blocks, int cd, T* out,
           void* stream) {
  if (n_blocks <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cd == 9) {
    schur_pairs_kernel<T, 9, 4><<<n_blocks, 9 * 9 * 4, 0, s>>>(X, W, pi, pj, start, out);
  } else if (cd == 6) {
    schur_pairs_kernel<T, 6, 8><<<n_blocks, 6 * 6 * 8, 0, s>>>(X, W, pi, pj, start, out);
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// X, W: (n_obs, cd, 3) contiguous; pair_i, pair_j: (n_pairs,) int32;
// start: (n_blocks + 1,) int32; out: (n_blocks, cd, cd).  Returns
// cudaGetLastError() after the launch (0 and no launch for no block), -1 for
// cd other than 6 or 9.
int cannoles_schur_pairs_f32(const float* X, const float* W, const int* pair_i, const int* pair_j,
                             const int* start, int n_blocks, int cd, float* out, void* stream) {
  return launch<float>(X, W, pair_i, pair_j, start, n_blocks, cd, out, stream);
}

int cannoles_schur_pairs_f64(const double* X, const double* W, const int* pair_i, const int* pair_j,
                             const int* start, int n_blocks, int cd, double* out, void* stream) {
  return launch<double>(X, W, pair_i, pair_j, start, n_blocks, cd, out, stream);
}

}  // extern "C"
