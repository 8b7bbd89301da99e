// Host-side unpivoted LDL^T with inertia: the linsolve="cpp" backend of
// cannoles_tpu_torch, the port's own copy of the JAX package's
// native/ldlt.cpp (same arithmetic, same entry points).
//
// Semantics mirror the solver's ldlt backend (ops/ldlt.py):
//   * fixed elimination order (quasi-definite KKT => stable without pivoting)
//   * pivots with |d| <= eig_tol are skipped (column zeroed) so breakdown is
//     reported through the inertia test instead of NaNs
//   * success <=> exactly `nvar` pivots > eig_tol, none within eig_tol, and
//     x and d finite
//
// Built by ops/cpp_ldlt.py at first use:
//   g++ -O3 -march=native -shared -fPIC -fopenmp ldlt_host.cpp -o lib...so

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Factor W (n x n, row-major, symmetric; lower triangle used) in place into
// unit-lower L (strictly-lower part of A) and pivots d.  Returns the number
// of pivots > eig_tol.  zer_out gets the count of |pivot| <= eig_tol.
static int ldlt_factor_inplace(int n, double eig_tol, double* A, double* d,
                               int* zer_out) {
  int pos = 0, zer = 0;
  for (int k = 0; k < n; ++k) {
    const double dk = A[k * n + k];
    d[k] = dk;
    if (dk > eig_tol) ++pos;
    if (std::fabs(dk) <= eig_tol) {
      ++zer;
      // skip pivot: zero the elimination column, leave trailing block as-is
      for (int i = k + 1; i < n; ++i) A[i * n + k] = 0.0;
      continue;
    }
    const double inv = 1.0 / dk;
    for (int i = k + 1; i < n; ++i) A[i * n + k] *= inv;
    for (int j = k + 1; j < n; ++j) {
      const double w = A[j * n + k] * dk;
      for (int i = j; i < n; ++i) A[i * n + j] -= w * A[i * n + k];
    }
  }
  *zer_out = zer;
  return pos;
}

// Fused factor+solve of one system.  Returns 1 on inertia success (pos ==
// nvar && zer == 0), 0 otherwise.  x holds W^{-1} rhs when successful.
int cannoles_ldlt_factor_solve(int n, int nvar, double eig_tol,
                               const double* W, const double* rhs, double* x,
                               double* d) {
  std::vector<double> A(W, W + (size_t)n * n);
  int zer = 0;
  const int pos = ldlt_factor_inplace(n, eig_tol, A.data(), d, &zer);
  const int ok = (pos == nvar) && (zer == 0);
  // forward: L y = rhs
  for (int i = 0; i < n; ++i) {
    double s = rhs[i];
    for (int k = 0; k < i; ++k) s -= A[i * n + k] * x[k];
    x[i] = s;
  }
  // diagonal
  for (int i = 0; i < n; ++i) {
    const double di = d[i];
    x[i] = (std::fabs(di) > eig_tol) ? x[i] / di : 0.0;
  }
  // backward: L^T x = y
  for (int i = n - 1; i >= 0; --i) {
    double s = x[i];
    for (int k = i + 1; k < n; ++k) s -= A[k * n + i] * x[k];
    x[i] = s;
  }
  for (int i = 0; i < n; ++i) {
    if (!std::isfinite(x[i]) || !std::isfinite(d[i])) return 0;
  }
  return ok;
}

// Batched variant: B independent systems, OpenMP across the batch.
void cannoles_ldlt_factor_solve_batch(int B, int n, int nvar, double eig_tol,
                                      const double* W, const double* rhs,
                                      double* x, double* d,
                                      int32_t* success) {
#pragma omp parallel for schedule(static)
  for (int b = 0; b < B; ++b) {
    success[b] = cannoles_ldlt_factor_solve(
        n, nvar, eig_tol, W + (size_t)b * n * n, rhs + (size_t)b * n,
        x + (size_t)b * n, d + (size_t)b * n);
  }
}

}  // extern "C"
