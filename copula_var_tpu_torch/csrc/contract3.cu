// Hand-written Hopper (sm_90a) kernel of the three-asset (dim-3) VaR
// serving path, float64.
//
//   masked_contract3  replaces copula_var_tpu/ops/pallas_quadrature3.py
//                     ::_kernel3 (K4): the dim-3 masked quadrature, (L, T)
//                     slab integrals for L bound rows. Every sweep of the
//                     dim-3 solve (stage 1, stage 2, each bisection
//                     halving) is one launch.
//
// What it computes, per row l and day t:
//
//   out[l, t] = sum_{i0} sum_{b,c} G[t, i0, b, c]
//               * sum_{i1,i2} W1[b, i1] W2[c, i2] V_t[i0, i1, i2] M_lt[...]
//
// with V the copula density rebuilt from per-asset transform columns
// (Student: exp(log_mvt - (lu0 + lu1 + lu2)), NaN where any column is not
// finite; Gaussian: exp(-1/2 (logdet + quad - sum z^2))), times the
// marginal pdf product and nan_to_num for the GARCH family, and M the
// half-space cut resolved on the innermost axis x2.
//
// What bounds it on the H100: the (T, n^3) density is never stored (4 GB
// at T = 500, n = 100), so every launch rebuilds n^3 cells per day, each
// with one log1p and one exp in float64 for the Student copula: 5e8
// transcendental pairs per sweep at the flagship width. The kernel is
// bound by float64 arithmetic, not by memory: its inputs are the
// (T, 3, n) columns and G, ~2.5 MB per launch.
//
// Design (simple first): one block per (day t, outer index i0) slab.
//   1. A[b, i2] = sum_c G[t, i0, b, c] W2[c, i2]          (q x n, shared)
//   2. U[i1, i2] = V[i0, i1, i2] * sum_b W1[b, i1] A[b, i2]  (n x n, shared)
//      i.e. the state contraction folded into one bounds-invariant weight
//      per cell, built once per launch;
//   3. for each row: masked sum of U (the dim-2 sweep kernel's pattern),
//      written to partial[l, t, i0];
//   4. a second kernel sums partial over i0 in a fixed order.
// No floating-point atomics anywhere: repeated launches give identical
// bits. No tensor cores, no TMA: right first, fast later.
//
// Semantics kept from the f64 `xla` engine (copula_var_tpu/backtest.py,
// `msm_tcached` / `garch_tcached` sweeps):
//   * prev = x0 w1 + x1 w2, dyn_up = (b_up - prev) / w_in and
//     dyn_lo = max((b_lo - prev) / w_in, box_min) are formed with
//     __dmul_rn / __dadd_rn / __dsub_rn / __ddiv_rn so that nvcc cannot
//     contract them into FMAs: the mask equals the CPU's bit for bit. The
//     quadratic form and the log-density sums are formed the same way and
//     in the plain twin's order, so only exp / log1p round differently;
//   * only masked-in cells contribute, so a NaN cell (MSM, Student,
//     non-finite column) poisons exactly the slabs that contain it;
//   * GARCH: nan_to_num(C * ((p0 p1) p2)) before the mask: NaN -> 0,
//     +inf -> DBL_MAX, -inf -> -DBL_MAX, as torch.nan_to_num.
//
// Launchers: plain C, no allocation, no synchronisation, launched on the
// caller's stream; each returns cudaGetLastError() (or
// cudaErrorInvalidValue for shapes the kernels do not take).

#include <cfloat>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSumThreads = 128;
constexpr size_t kMaxSharedBytes = 232448;  // 227 KB opt-in per block

__host__ __device__ size_t slab_shared_bytes(int n, int q) {
  return (static_cast<size_t>(n) * n + 3 * static_cast<size_t>(n) +
          static_cast<size_t>(q) * n + kWarps) *
         sizeof(double);
}

__device__ __forceinline__ double nan_to_num(double v) {
  if (v != v) return 0.0;
  if (v == CUDART_INF) return DBL_MAX;
  if (v == -CUDART_INF) return -DBL_MAX;
  return v;
}

__global__ void __launch_bounds__(kThreads)
contract3_slab_kernel(const double* __restrict__ x,           // (n,)
                      const double* __restrict__ z,           // (T, 3, n)
                      const unsigned char* __restrict__ fin,  // (T, 3, n)
                      const double* __restrict__ lu,          // (T, 3, n)
                      const double* __restrict__ p,  // (T, 3, n); null: MSM
                      const double* __restrict__ w1,          // (q, n)
                      const double* __restrict__ w2,          // (q, n)
                      const double* __restrict__ g,           // (T, n, q, q)
                      const double* __restrict__ sigma_inv,   // (3, 3)
                      int student, double nu, double log_norm, double logdet,
                      const double* __restrict__ bounds,      // (L, T, 2)
                      const double* __restrict__ weights,     // (L, 3)
                      double box_min,
                      double* __restrict__ partial,           // (L, T, n)
                      int T, int n, int q, int L) {
  extern __shared__ double smem[];
  const int t = blockIdx.x / n;
  const int i0 = blockIdx.x - t * n;
  double* u = smem;                               // (n, n)
  double* xs = u + static_cast<size_t>(n) * n;    // (n,)
  double* dlo = xs + n;                           // (n,)
  double* dup = dlo + n;                          // (n,)
  double* a = dup + n;                            // (q, n)
  double* red = a + static_cast<size_t>(q) * n;   // (kWarps,)

  const size_t day = static_cast<size_t>(t) * 3 * n;
  const double* gt = g + (static_cast<size_t>(t) * n + i0) * q * q;
  for (int j = threadIdx.x; j < n; j += blockDim.x) xs[j] = x[j];
  for (int idx = threadIdx.x; idx < q * n; idx += blockDim.x) {
    const int b = idx / n;
    const int j = idx - b * n;
    double s = 0.0;
    for (int c = 0; c < q; ++c) s += gt[b * q + c] * w2[c * n + j];
    a[idx] = s;
  }
  __syncthreads();

  // the slab's density, folded with its state weights, built once
  const double s00 = sigma_inv[0], s01x2 = 2.0 * sigma_inv[1],
               s02x2 = 2.0 * sigma_inv[2], s11 = sigma_inv[4],
               s12x2 = 2.0 * sigma_inv[5], s22 = sigma_inv[8];
  const double coef = (nu + 3.0) / 2.0;
  const double z0 = z[day + i0];
  const double* z1 = z + day + n;
  const double* z2 = z + day + 2 * n;
  const double lu0 = lu[day + i0];
  const double* lu1 = lu + day + n;
  const double* lu2 = lu + day + 2 * n;
  const bool f0 = fin[day + i0] != 0;
  const unsigned char* f1 = fin + day + n;
  const unsigned char* f2 = fin + day + 2 * n;
  const double p0 = p != nullptr ? p[day + i0] : 0.0;
  const double zz0 = __dmul_rn(z0, z0);
  const double q00 = __dmul_rn(s00, zz0);
  const int nn = n * n;
  for (int idx = threadIdx.x; idx < nn; idx += blockDim.x) {
    const int i1 = idx / n;
    const int i2 = idx - i1 * n;
    const double za = z1[i1];
    const double zb = z2[i2];
    // z^T Sigma^-1 z in the plain twin's order
    double quad = __dadd_rn(q00, __dmul_rn(s01x2, __dmul_rn(z0, za)));
    quad = __dadd_rn(quad, __dmul_rn(s02x2, __dmul_rn(z0, zb)));
    quad = __dadd_rn(quad, __dmul_rn(s11, __dmul_rn(za, za)));
    quad = __dadd_rn(quad, __dmul_rn(s12x2, __dmul_rn(za, zb)));
    quad = __dadd_rn(quad, __dmul_rn(s22, __dmul_rn(zb, zb)));
    double v;
    if (student) {
      const double log_mvt =
          __dsub_rn(log_norm, __dmul_rn(coef, log1p(__ddiv_rn(quad, nu))));
      const double lu_sum = __dadd_rn(__dadd_rn(lu0, lu1[i1]), lu2[i2]);
      v = exp(__dsub_rn(log_mvt, lu_sum));
      if (!(f0 && f1[i1] != 0 && f2[i2] != 0)) v = CUDART_NAN;
    } else {
      const double sum_z2 = __dadd_rn(__dadd_rn(zz0, __dmul_rn(za, za)),
                                      __dmul_rn(zb, zb));
      v = exp(__dmul_rn(-0.5, __dsub_rn(__dadd_rn(logdet, quad), sum_z2)));
    }
    if (p != nullptr) {
      const double* pd = p + day;
      v = nan_to_num(__dmul_rn(
          v, __dmul_rn(__dmul_rn(p0, pd[n + i1]), pd[2 * n + i2])));
    }
    double h = 0.0;
    for (int b = 0; b < q; ++b) h += w1[b * n + i1] * a[b * n + i2];
    u[idx] = v * h;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const double x0 = xs[i0];
  for (int l = 0; l < L; ++l) {
    const size_t o = static_cast<size_t>(l) * T + t;
    const double b_lo = bounds[2 * o];
    const double b_up = bounds[2 * o + 1];
    const double w_in = weights[3 * l];
    const double p0w = __dmul_rn(x0, weights[3 * l + 1]);
    const double w_o2 = weights[3 * l + 2];
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const double prev = __dadd_rn(p0w, __dmul_rn(xs[i], w_o2));
      dup[i] = __ddiv_rn(__dsub_rn(b_up, prev), w_in);
      const double lo = __ddiv_rn(__dsub_rn(b_lo, prev), w_in);
      // NaN-propagating max, as torch.maximum
      dlo[i] = (lo > box_min || lo != lo) ? lo : box_min;
    }
    __syncthreads();
    double acc = 0.0;
    for (int i = warp; i < n; i += kWarps) {
      const double lo = dlo[i];
      const double up = dup[i];
      const double* row = u + static_cast<size_t>(i) * n;
      for (int j = lane; j < n; j += 32) {
        const double xj = xs[j];
        if (xj > lo && xj <= up) acc += row[j];
      }
    }
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) red[warp] = acc;
    // orders this row's reads of dlo/dup before the next row's writes;
    // red is rewritten only after the next row's barrier
    __syncthreads();
    if (threadIdx.x == 0) {
      double total = 0.0;
      for (int w = 0; w < kWarps; ++w) total += red[w];
      partial[o * n + i0] = total;
    }
  }
}

// out[r] = sum_{i0} partial[r, i0], in index order
__global__ void contract3_sum_kernel(const double* __restrict__ partial,
                                     double* __restrict__ out, int n,
                                     int rows) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const double* pr = partial + static_cast<size_t>(r) * n;
  double s = 0.0;
  for (int i = 0; i < n; ++i) s += pr[i];
  out[r] = s;
}

}  // namespace

extern "C" int cvt_contract3_max_grid_points(int q) {
  int n = 1;
  while (slab_shared_bytes(n + 1, q) <= kMaxSharedBytes) ++n;
  return n;
}

extern "C" int cvt_masked_contract3(
    const double* x, const double* z, const unsigned char* fin,
    const double* lu, const double* p, const double* w1, const double* w2,
    const double* g, const double* sigma_inv, int student, double nu,
    double log_norm, double logdet, const double* bounds,
    const double* weights, double box_min, double* partial, double* out,
    int T, int n, int q, int L, void* stream) {
  if (n <= 0 || q <= 0 || T < 0 || L < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t bytes = slab_shared_bytes(n, q);
  if (bytes > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(T) * n > 0x7fffffffLL ||
      static_cast<long long>(L) * T > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = cudaFuncSetAttribute(
      contract3_slab_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (T == 0 || L == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  contract3_slab_kernel<<<T * n, kThreads, bytes, s>>>(
      x, z, fin, lu, p, w1, w2, g, sigma_inv, student, nu, log_norm, logdet,
      bounds, weights, box_min, partial, T, n, q, L);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int rows = L * T;
  contract3_sum_kernel<<<(rows + kSumThreads - 1) / kSumThreads, kSumThreads,
                         0, s>>>(partial, out, n, rows);
  return static_cast<int>(cudaGetLastError());
}
