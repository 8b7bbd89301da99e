// Unpivoted LDLᵀ of B symmetric N×N matrices on the host, operation for
// operation as ops/ldlt.py's ldlt_factor in PyTorch, so that L and the raw
// pivots d come out bit for bit equal: the same elimination order, the same
// skipped-pivot rule (a pivot with |d_k| ≤ tol gets the inverse 0), the same
// products in the same association, each rounded to T.  It must be built
// without floating-point contraction and without fast-math
// (-ffp-contract=off; ops/cpp_ldlt.py builds it so): a fused multiply-add
// would round once where PyTorch rounds twice.
//
// Layout: A, L (B, N, N) row-major, d (B, N).  Column k scales the entries
// below its pivot by the pivot's inverse (into L, plus 0 so that -0 reads
// +0, as PyTorch adds the unit diagonal's column) and updates the trailing
// block W[k+1:, k+1:] -= (d_k · l_i) · l_j; a pivot is the diagonal entry
// that no later column touches.

#include <cmath>
#include <cstring>
#include <vector>

namespace {

template <typename T>
void factor(const T* A, T* L, T* d, long B, int N, T tol) {
  std::vector<T> W(static_cast<size_t>(N) * N), col(N);
  const size_t NN = static_cast<size_t>(N) * N;
  for (long b = 0; b < B; ++b) {
    const T* a = A + b * NN;
    T* l = L + b * NN;
    std::memcpy(W.data(), a, NN * sizeof(T));
    for (size_t e = 0; e < NN; ++e) l[e] = T(0);
    for (int i = 0; i < N; ++i) l[i * N + i] = T(1);
    for (int k = 0; k + 1 < N; ++k) {
      const T dk = W[k * N + k];
      const bool ok = std::fabs(dk) > tol;
      const T inv = ok ? T(1) / dk : T(0);
      for (int i = k + 1; i < N; ++i) {
        col[i] = W[i * N + k] * inv;
        l[i * N + k] = col[i] + T(0);
      }
      for (int i = k + 1; i < N; ++i) {
        const T s = dk * col[i];
        T* w = &W[i * N];
        for (int j = k + 1; j < N; ++j) w[j] = w[j] - s * col[j];
      }
    }
    for (int i = 0; i < N; ++i) d[b * N + i] = W[i * N + i];
  }
}

}  // namespace

extern "C" {

void cannoles_ldlt_exact_f64(const double* A, double* L, double* d, long B, int N, double tol) {
  factor<double>(A, L, d, B, N, tol);
}

void cannoles_ldlt_exact_f32(const float* A, float* L, float* d, long B, int N, double tol) {
  // PyTorch compares a float32 pivot with the tolerance cast to float32
  factor<float>(A, L, d, B, N, static_cast<float>(tol));
}

}  // extern "C"
