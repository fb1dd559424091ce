// Hand-written Hopper (sm_90a) kernels of the three-asset (dim-3) VaR
// serving path, float64. Together they replace
// copula_var_tpu/ops/pallas_quadrature3.py::_kernel3 (K4), the dim-3
// masked quadrature: (L, T) slab integrals for L bound rows.
//
//   contract3_weights  builds, once per backtest, the bounds-invariant
//                      table U (T, n, n, n) in device memory (rows padded
//                      to an odd pitch, see below);
//   masked_contract3   every sweep of the dim-3 solve (stage 1, stage 2,
//                      each bisection halving): streams U through shared
//                      memory (contract3_sweep_kernel), then sums the
//                      per-slab partials in a fixed order
//                      (contract3_sum_kernel).
//   masked_contract3_rebuild
//                      the same sweep with no table, as the TPU kernel
//                      computes it: every launch rebuilds each slab's
//                      cells from the transform columns
//                      (contract3_rebuild_kernel), then the same sum
//                      kernel. It serves the grids the table cannot: n
//                      past the sweep's one-slab shared memory (169 at
//                      q = 5), or a U larger than the card's free memory.
//
// What they compute, per row l and day t:
//
//   out[l, t] = sum_{i0,i1,i2} U[t, i0, i1, i2] M_lt[i0, i1, i2],
//   U[t, i0, i1, i2] = V_t[i0, i1, i2] * sum_{b,c} W1[b, i1] G[t, i0, b, c]
//                                                  W2[c, i2]
//
// with V the copula density rebuilt from per-asset transform columns
// (Student: exp(log_mvt - (lu0 + lu1 + lu2)), NaN where any column is not
// finite; Gaussian: exp(-1/2 (logdet + quad - sum z^2))), times the
// marginal pdf product and nan_to_num for the GARCH family, and M the
// half-space cut resolved on the innermost axis x2. U depends neither on
// the bounds nor on the portfolio weights.
//
// What bounds them on the H100, and the design:
//   * contract3_weights writes T*n^3 f64 (4.0 GB at T = 500, n = 100):
//     ~1.2 ms of HBM writes, against ~5e8 cells of f64 arithmetic with
//     one log1p and one exp each. One block per (t, i0) slab, the cell
//     arithmetic of the former fused kernel (same __dmul_rn / __dadd_rn
//     order), written to global memory instead of shared memory. Rows
//     (i1) have an odd pitch p = n | 1 (one zero pad cell when n is even)
//     and each (t, i0) slab a stride of n*p rounded up to even, so every
//     slab starts on 16 bytes and is a legal bulk-copy source, and the
//     sweep's one-thread-per-row scan hits 16 distinct bank pairs.
//   * contract3_sweep_kernel reads U once per sweep: 4.0 GB, 1.2 ms at
//     3.35 TB/s, so it is bound by HBM. Persistent blocks, one per SM,
//     walk the T*n slabs; the next slab arrives by a 1-D TMA bulk copy
//     (cp.async.bulk + mbarrier) while the current one is summed (two
//     buffers where they fit in 227 KB, n <= 119; one above). Each (i0,
//     i1) row of the slab is turned in place into its inclusive prefix sum
//     over i2 by one thread, in index order and in one pass (a warp-shuffle
//     scan spent most of the sweep's time on f64 shuffles), so its masked
//     sum is the interval rule of interval.cuh: two binary searches on x
//     and one subtraction; a flagged row's cells are read back from the
//     table. The row lookups of a slab are tasks (l, k): bound row l and
//     the k-th span of kSpan = 64 consecutive i1, two per lane. Warps take
//     tasks round-robin, with no block barrier per row; each task writes
//     its warp's sum to partial[l, t, i0, k]. The span is fixed: a
//     partial's bits depend on (l, t, i0, k) alone, not on L, so a row
//     gets the same result alone or in a batch (at L = 1 two warps share a
//     slab's lookups, at L = 32 each of 16 warps takes four tasks). The
//     barriers are two per slab (prefix done, slab done).
//   * the sum kernel adds the partials of each (l, t) in index order.
//   * Outer slabs: the sum over i0 is linear, so the build and the sweep
//     take a range of slabs, i0 in [row0, row0 + rows) of the n outer grid
//     points (grid sharding: each rank builds and sweeps the table of its
//     range, U (T, rows, stride), and the ranks' partial sums add up to
//     the whole day). The columns z, lu, fin, p and G stay whole and are
//     read at row0 + the local slab. At row0 = 0, rows = n every launch is
//     the one-card launch, bit for bit.
//   * contract3_rebuild_kernel: one block per (t, i0) slab and tile of
//     tile_rows consecutive i1 rows (64, or the largest power of two below it
//     whose rows fit in shared memory: 64 up to n ~ 410 at q = 5, 16 at n =
//     1024; the caller picks it, ops/cuda_quadrature3.py
//     `rebuild_tile_rows`), so shared memory bounds no n <=
//     interval::kMaxRow. The block folds G[t, i0] with W2, forms the tile's
//     cells with the build kernel's arithmetic (`cell`), turns each row into
//     its prefix sum (interval::scan_row: a flagged row keeps its cells), and
//     warps take the bound rows, lanes over the tile's rows, each tile's warp
//     sum one partial (l, t, i0, tile). The sweep is latency-bound (chains of
//     f64 exp, log1p and division), so the launcher sizes the block for the
//     most resident warps per SM (256-1024 threads; the bits do not depend on
//     it): at n = 300 one 154 KB tile fits a SM, and 1024 threads keep 32
//     warps on it. At 64 rows a tile is exactly a lookup span of
//     contract3_sweep_kernel: the cells, the prefix sums, the lane order and
//     the partials are the table sweep's, so the two routes give the same
//     bits. Bound by the float64 arithmetic of the cells (one exp and one
//     log1p each, ~n^3 T per sweep), not by memory: it reads only the (T, 3,
//     n) columns and G. The TPU kernel does the same (pallas_quadrature3.py
//     rebuilds a day's slab per call).
// No floating-point atomics anywhere: repeated launches give identical
// bits. No tensor cores: the work is a masked sum, not a product.
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
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "interval.cuh"

namespace {

constexpr int kWeightsThreads = 256;
constexpr int kSweepThreads = 512;
constexpr int kSweepWarps = kSweepThreads / 32;
constexpr int kSpan = 64;  // consecutive i1 of one lookup task, 2 per lane
constexpr int kSumThreads = 128;
// rebuild: threads per block, a power of two in [min, max], chosen per
// launch for the most resident threads per SM (ties: the smaller block)
constexpr int kRebuildMinThreads = 256;
constexpr int kRebuildMaxThreads = 1024;
constexpr int kMaxTileRows = kSpan;  // rebuild: i1 rows per block, at most
constexpr size_t kMaxSharedBytes = CVT_MAX_SHARED_BYTES;  // opt-in per block
constexpr size_t kBarrierBytes = 16;        // two mbarriers

__host__ __device__ size_t weights_shared_bytes(int n, int q) {
  return static_cast<size_t>(q) * n * sizeof(double);
}

// one or two slab buffers (stride doubles each), x (n,), a flag per row
__host__ __device__ size_t sweep_shared_bytes(int n, int stride, int bufs) {
  return kBarrierBytes +
         (static_cast<size_t>(bufs) * stride + n) * sizeof(double) + n;
}

__host__ __device__ int sweep_buffers(int n, int stride) {
  return sweep_shared_bytes(n, stride, 2) <= kMaxSharedBytes ? 2 : 1;
}

__device__ __forceinline__ double nan_to_num(double v) {
  if (v != v) return 0.0;
  if (v == CUDART_INF) return DBL_MAX;
  if (v == -CUDART_INF) return -DBL_MAX;
  return v;
}

// The copula density of one slab (day t, outer point i0) at cells (i1, i2),
// times the marginal pdfs (GARCH, nan_to_num), from the transform columns;
// its per-slab constants are formed once (`Slab`). Both the table build and
// the rebuild sweep take their cells from `cell`, so the two hold the same
// bits.
struct Slab {
  const double* z1;
  const double* z2;
  const double* lu1;
  const double* lu2;
  const unsigned char* f1;
  const unsigned char* f2;
  const double* p;  // the day's (3, n) pdf columns; null: MSM
  double z0, lu0, p0, zz0, q00;
  double s01x2, s02x2, s11, s12x2, s22, coef;
  bool f0;
  int n, student;
  double nu, log_norm, logdet;
};

__device__ __forceinline__ Slab make_slab(
    const double* __restrict__ z, const unsigned char* __restrict__ fin,
    const double* __restrict__ lu, const double* __restrict__ p,
    const double* __restrict__ sigma_inv, int student, double nu,
    double log_norm, double logdet, int t, int i0, int n) {
  Slab s;
  const size_t day = static_cast<size_t>(t) * 3 * n;
  s.s01x2 = 2.0 * sigma_inv[1];
  s.s02x2 = 2.0 * sigma_inv[2];
  s.s11 = sigma_inv[4];
  s.s12x2 = 2.0 * sigma_inv[5];
  s.s22 = sigma_inv[8];
  s.coef = (nu + 3.0) / 2.0;
  s.z0 = z[day + i0];
  s.z1 = z + day + n;
  s.z2 = z + day + 2 * n;
  s.lu0 = lu[day + i0];
  s.lu1 = lu + day + n;
  s.lu2 = lu + day + 2 * n;
  s.f0 = fin[day + i0] != 0;
  s.f1 = fin + day + n;
  s.f2 = fin + day + 2 * n;
  s.p = p != nullptr ? p + day : nullptr;
  s.p0 = p != nullptr ? p[day + i0] : 0.0;
  s.zz0 = __dmul_rn(s.z0, s.z0);
  s.q00 = __dmul_rn(sigma_inv[0], s.zz0);
  s.n = n;
  s.student = student;
  s.nu = nu;
  s.log_norm = log_norm;
  s.logdet = logdet;
  return s;
}

// A[b, i2] = sum_c G[t, i0, b, c] W2[c, i2] into shared memory (q, n)
__device__ __forceinline__ void fold_w2(const double* __restrict__ gt,
                                        const double* __restrict__ w2,
                                        double* a, int q, int n) {
  for (int idx = threadIdx.x; idx < q * n; idx += blockDim.x) {
    const int b = idx / n;
    const int j = idx - b * n;
    double s = 0.0;
    for (int c = 0; c < q; ++c) s += gt[b * q + c] * w2[c * n + j];
    a[idx] = s;
  }
}

// U[t, i0, i1, i2] = V * sum_b W1[b, i1] A[b, i2]
__device__ __forceinline__ double cell(const Slab& s,
                                       const double* __restrict__ w1,
                                       const double* a, int q, int i1,
                                       int i2) {
  const int n = s.n;
  const double za = s.z1[i1];
  const double zb = s.z2[i2];
  // z^T Sigma^-1 z in the plain twin's order
  double quad = __dadd_rn(s.q00, __dmul_rn(s.s01x2, __dmul_rn(s.z0, za)));
  quad = __dadd_rn(quad, __dmul_rn(s.s02x2, __dmul_rn(s.z0, zb)));
  quad = __dadd_rn(quad, __dmul_rn(s.s11, __dmul_rn(za, za)));
  quad = __dadd_rn(quad, __dmul_rn(s.s12x2, __dmul_rn(za, zb)));
  quad = __dadd_rn(quad, __dmul_rn(s.s22, __dmul_rn(zb, zb)));
  double v;
  if (s.student) {
    const double log_mvt = __dsub_rn(
        s.log_norm, __dmul_rn(s.coef, log1p(__ddiv_rn(quad, s.nu))));
    const double lu_sum = __dadd_rn(__dadd_rn(s.lu0, s.lu1[i1]), s.lu2[i2]);
    v = exp(__dsub_rn(log_mvt, lu_sum));
    if (!(s.f0 && s.f1[i1] != 0 && s.f2[i2] != 0)) v = CUDART_NAN;
  } else {
    const double sum_z2 = __dadd_rn(__dadd_rn(s.zz0, __dmul_rn(za, za)),
                                    __dmul_rn(zb, zb));
    v = exp(__dmul_rn(-0.5, __dsub_rn(__dadd_rn(s.logdet, quad), sum_z2)));
  }
  if (s.p != nullptr) {
    v = nan_to_num(__dmul_rn(
        v, __dmul_rn(__dmul_rn(s.p0, s.p[n + i1]), s.p[2 * n + i2])));
  }
  double h = 0.0;
  for (int b = 0; b < q; ++b) h += w1[b * n + i1] * a[b * n + i2];
  return v * h;
}

__global__ void __launch_bounds__(kWeightsThreads)
contract3_weights_kernel(const double* __restrict__ z,           // (T, 3, n)
                         const unsigned char* __restrict__ fin,  // (T, 3, n)
                         const double* __restrict__ lu,          // (T, 3, n)
                         const double* __restrict__ p,  // (T, 3, n); null: MSM
                         const double* __restrict__ w1,          // (q, n)
                         const double* __restrict__ w2,          // (q, n)
                         const double* __restrict__ g,       // (T, n, q, q)
                         const double* __restrict__ sigma_inv,   // (3, 3)
                         int student, double nu, double log_norm,
                         double logdet,
                         double* __restrict__ u,  // (T, rows, stride)
                         int T, int n, int row0, int rows, int q, int pitch,
                         int stride) {
  extern __shared__ double a[];  // (q, n)
  const int t = blockIdx.x / rows;
  const int i0 = row0 + (blockIdx.x - t * rows);  // grid point of the slab
  fold_w2(g + (static_cast<size_t>(t) * n + i0) * q * q, w2, a, q, n);
  __syncthreads();
  const Slab sl = make_slab(z, fin, lu, p, sigma_inv, student, nu, log_norm,
                            logdet, t, i0, n);
  double* slab = u + static_cast<size_t>(blockIdx.x) * stride;
  for (int idx = threadIdx.x; idx < stride; idx += blockDim.x) {
    const int i1 = idx / pitch;
    const int i2 = idx - i1 * pitch;
    // pad cells: defined, never summed
    slab[idx] = (i1 >= n || i2 >= n) ? 0.0 : cell(sl, w1, a, q, i1, i2);
  }
}

// -- TMA 1-D bulk copies, completed on an mbarrier ---------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// One thread: expect `bytes` on `bar`, then copy them global -> shared.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

__global__ void __launch_bounds__(kSweepThreads)
contract3_sweep_kernel(const double* __restrict__ u,  // (T, rows, stride)
                       const double* __restrict__ x,        // (n,)
                       const double* __restrict__ bounds,   // (L, T, 2)
                       const double* __restrict__ weights,  // (L, 3)
                       double box_min,
                       double* __restrict__ partial,  // (L, T, rows, spans)
                       int T, int n, int row0, int rows, int L, int pitch,
                       int stride, int bufs) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);  // (2,)
  double* buf = reinterpret_cast<double*>(smem + kBarrierBytes);
  double* xs = buf + static_cast<size_t>(bufs) * stride;         // (n,)
  unsigned char* flag = reinterpret_cast<unsigned char*>(xs + n);  // (n,)
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int slabs = T * rows;
  const uint32_t bytes = static_cast<uint32_t>(stride) * sizeof(double);

  for (int j = threadIdx.x; j < n; j += blockDim.x) xs[j] = x[j];
  if (threadIdx.x == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int k = 0; k < bufs; ++k) {
      const int s = blockIdx.x + k * gridDim.x;
      if (s < slabs)
        bulk_load(buf + static_cast<size_t>(k) * stride,
                  u + static_cast<size_t>(s) * stride, bytes, &bar[k]);
    }
  }
  __syncthreads();

  for (int k = 0, s = blockIdx.x; s < slabs; ++k, s += gridDim.x) {
    const int b = k % bufs;
    double* slab = buf + static_cast<size_t>(b) * stride;
    mbar_wait(&bar[b], (k / bufs) & 1);
    const int t = s / rows;
    const int i0 = s - t * rows;  // the range's slab, grid point row0 + i0
    const double* cells = u + static_cast<size_t>(s) * stride;  // in HBM
    for (int i1 = threadIdx.x; i1 < n; i1 += blockDim.x)
      flag[i1] = interval::scan_row_once(
          slab + static_cast<size_t>(i1) * pitch, n);
    __syncthreads();
    const double x0 = xs[row0 + i0];
    const int spans = (n + kSpan - 1) / kSpan;  // tasks per bound row
    for (int task = warp; task < L * spans; task += kSweepWarps) {
      const int l = task / spans;
      const int k = task - l * spans;
      const size_t o = static_cast<size_t>(l) * T + t;
      const double b_lo = bounds[2 * o];
      const double b_up = bounds[2 * o + 1];
      const double w_in = weights[3 * l];
      const double p0w = __dmul_rn(x0, weights[3 * l + 1]);
      const double w_o2 = weights[3 * l + 2];
      double acc = 0.0;
#pragma unroll
      for (int c = 0; c < kSpan / 32; ++c) {
        const int i1 = k * kSpan + c * 32 + lane;
        if (i1 < n) {
          const double prev = __dadd_rn(p0w, __dmul_rn(xs[i1], w_o2));
          const double dup = __ddiv_rn(__dsub_rn(b_up, prev), w_in);
          const double d = __ddiv_rn(__dsub_rn(b_lo, prev), w_in);
          // NaN-propagating max, as torch.maximum
          const double dlo = (d > box_min || d != d) ? d : box_min;
          const size_t r = static_cast<size_t>(i1) * pitch;
          acc += interval::row_sum<interval::kShortTop>(
              slab + r, cells + r, flag[i1] != 0, xs, n, dlo, dup);
        }
      }
      acc = interval::warp_sum(acc);
      if (lane == 0) partial[(o * rows + i0) * spans + k] = acc;
    }
    // the prefix writes (generic proxy) before the next bulk copy (async
    // proxy) into this buffer; every warp done with the slab and its flags
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const int next = s + bufs * gridDim.x;
    if (threadIdx.x == 0 && next < slabs)
      bulk_load(slab, u + static_cast<size_t>(next) * stride, bytes, &bar[b]);
  }
}

// out[r] = sum_k partial[r, k] over the row's m partials, in index order
__global__ void contract3_sum_kernel(const double* __restrict__ partial,
                                     double* __restrict__ out, int m,
                                     int rows) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const double* pr = partial + static_cast<size_t>(r) * m;
  double s = 0.0;
  for (int i = 0; i < m; ++i) s += pr[i];
  out[r] = s;
}

// rebuild: x (n,), the (q, n) fold, `tile_rows` rows at the odd pitch and
// a flag byte per row
__host__ __device__ size_t rebuild_shared_bytes(int n, int q,
                                                int tile_rows) {
  return (static_cast<size_t>(n) + static_cast<size_t>(q) * n +
          static_cast<size_t>(tile_rows) * interval::row_pitch(n)) *
             sizeof(double) +
         tile_rows;
}

__global__ void __launch_bounds__(kRebuildMaxThreads)
contract3_rebuild_kernel(const double* __restrict__ z,           // (T, 3, n)
                         const unsigned char* __restrict__ fin,  // (T, 3, n)
                         const double* __restrict__ lu,          // (T, 3, n)
                         const double* __restrict__ p,  // (T, 3, n); null: MSM
                         const double* __restrict__ w1,          // (q, n)
                         const double* __restrict__ w2,          // (q, n)
                         const double* __restrict__ g,       // (T, n, q, q)
                         const double* __restrict__ sigma_inv,   // (3, 3)
                         int student, double nu, double log_norm,
                         double logdet,
                         const double* __restrict__ x,        // (n,)
                         const double* __restrict__ bounds,   // (L, T, 2)
                         const double* __restrict__ weights,  // (L, 3)
                         double box_min,
                         double* __restrict__ partial,  // (L, T, rows, tiles)
                         int T, int n, int row0, int rows, int q, int L,
                         int tile_rows) {
  // not `smem`: contract3_sweep_kernel declares that name with another type
  extern __shared__ double rebuild_shared[];
  const int pitch = interval::row_pitch(n);
  const int tiles = (n + tile_rows - 1) / tile_rows;
  double* xs = rebuild_shared;                        // (n,)
  double* a = xs + n;                                 // (q, n)
  double* u = a + static_cast<size_t>(q) * n;         // (tile_rows, pitch)
  unsigned char* flag = reinterpret_cast<unsigned char*>(
      u + static_cast<size_t>(tile_rows) * pitch);    // (tile_rows,)
  const int tile = blockIdx.x % tiles;
  const int s = blockIdx.x / tiles;  // the slab (t, local)
  const int t = s / rows;
  const int local = s - t * rows;
  const int i0 = row0 + local;       // its grid point
  const int r0 = tile * tile_rows;   // the tile's first i1
  const int nr = min(tile_rows, n - r0);

  for (int j = threadIdx.x; j < n; j += blockDim.x) xs[j] = x[j];
  fold_w2(g + (static_cast<size_t>(t) * n + i0) * q * q, w2, a, q, n);
  __syncthreads();
  const Slab sl = make_slab(z, fin, lu, p, sigma_inv, student, nu, log_norm,
                            logdet, t, i0, n);
  for (int idx = threadIdx.x; idx < nr * n; idx += blockDim.x) {
    const int r = idx / n;
    const int i2 = idx - r * n;
    u[static_cast<size_t>(r) * pitch + i2] = cell(sl, w1, a, q, r0 + r, i2);
  }
  __syncthreads();
  // each row its inclusive prefix sum over i2, or flagged and kept as its
  // cells (interval::scan_row)
  if (threadIdx.x < nr)
    flag[threadIdx.x] =
        interval::scan_row(u + static_cast<size_t>(threadIdx.x) * pitch, n);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const double x0 = xs[i0];
  for (int l = warp; l < L; l += warps) {
    const size_t o = static_cast<size_t>(l) * T + t;
    const double b_lo = bounds[2 * o];
    const double b_up = bounds[2 * o + 1];
    const double w_in = weights[3 * l];
    const double p0w = __dmul_rn(x0, weights[3 * l + 1]);
    const double w_o2 = weights[3 * l + 2];
    double acc = 0.0;
#pragma unroll
    for (int c = 0; c < (kMaxTileRows + 31) / 32; ++c) {
      const int r = c * 32 + lane;  // the tile's row, i1 = r0 + r
      if (r < nr) {
        const double prev = __dadd_rn(p0w, __dmul_rn(xs[r0 + r], w_o2));
        const double dup = __ddiv_rn(__dsub_rn(b_up, prev), w_in);
        const double d = __ddiv_rn(__dsub_rn(b_lo, prev), w_in);
        // NaN-propagating max, as torch.maximum
        const double dlo = (d > box_min || d != d) ? d : box_min;
        const double* row = u + static_cast<size_t>(r) * pitch;
        acc += interval::row_sum<interval::kMaxTop>(row, row, flag[r] != 0,
                                                    xs, n, dlo, dup);
      }
    }
    acc = interval::warp_sum(acc);
    if (lane == 0) partial[(o * rows + local) * tiles + tile] = acc;
  }
}

bool valid_layout(int n, int pitch, int stride) {
  const long long np = static_cast<long long>(n) * pitch;
  return pitch == interval::row_pitch(n) && stride == np + np % 2;
}

}  // namespace

extern "C" int cvt_contract3_weights(
    const double* z, const unsigned char* fin, const double* lu,
    const double* p, const double* w1, const double* w2, const double* g,
    const double* sigma_inv, int student, double nu, double log_norm,
    double logdet, double* u, int T, int n, int row0, int rows, int q,
    int pitch, int stride, void* stream) {
  if (n <= 0 || q <= 0 || T < 0 || !valid_layout(n, pitch, stride) ||
      row0 < 0 || rows <= 0 || row0 + rows > n ||
      static_cast<long long>(T) * rows > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t bytes = weights_shared_bytes(n, q);
  if (bytes > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      contract3_weights_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (T == 0) return 0;
  contract3_weights_kernel<<<T * rows, kWeightsThreads, bytes,
                             static_cast<cudaStream_t>(stream)>>>(
      z, fin, lu, p, w1, w2, g, sigma_inv, student, nu, log_norm, logdet, u,
      T, n, row0, rows, q, pitch, stride);
  return static_cast<int>(cudaGetLastError());
}

// u: the slabs [row0, row0 + rows) of every day; partial: (L, T, rows,
// ceil(n / kSpan)) scratch, summed in order into out
extern "C" int cvt_masked_contract3(const double* u, const double* x,
                                    const double* bounds,
                                    const double* weights, double box_min,
                                    double* partial, double* out, int T,
                                    int n, int row0, int rows, int L,
                                    int pitch, int stride, void* stream) {
  if (n <= 0 || n > interval::kMaxRow || T < 0 || L < 0 ||
      !valid_layout(n, pitch, stride) ||
      row0 < 0 || rows <= 0 || row0 + rows > n ||
      static_cast<long long>(T) * rows > 0x7fffffffLL ||
      static_cast<long long>(L) * T > 0x7fffffffLL ||
      static_cast<long long>(L) * ((n + kSpan - 1) / kSpan) > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int bufs = sweep_buffers(n, stride);
  const size_t bytes = sweep_shared_bytes(n, stride, bufs);
  if (bytes > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      contract3_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (T == 0 || L == 0) return 0;
  int device = 0, sms = 0, per_sm = 0;
  e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, contract3_sweep_kernel, kSweepThreads, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long slabs = static_cast<long long>(T) * rows;
  const int grid = static_cast<int>(
      slabs < static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1)
          ? slabs
          : static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  contract3_sweep_kernel<<<grid, kSweepThreads, bytes, s>>>(
      u, x, bounds, weights, box_min, partial, T, n, row0, rows, L, pitch,
      stride, bufs);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int sums = L * T;  // one per (bound row, day)
  const int m = rows * ((n + kSpan - 1) / kSpan);  // partials per sum
  contract3_sum_kernel<<<(sums + kSumThreads - 1) / kSumThreads, kSumThreads,
                         0, s>>>(partial, out, m, sums);
  return static_cast<int>(cudaGetLastError());
}

// The sweep without a table: the columns, G and the outer slabs [row0,
// row0 + rows) of every day, in tiles of tile_rows i1 rows (a divisor of
// kSpan whose rows fit in shared memory, chosen by the caller);
// partial: (L, T, rows, ceil(n / tile_rows)) scratch, summed in order
// into out
extern "C" int cvt_masked_contract3_rebuild(
    const double* z, const unsigned char* fin, const double* lu,
    const double* p, const double* w1, const double* w2, const double* g,
    const double* sigma_inv, int student, double nu, double log_norm,
    double logdet, const double* x, const double* bounds,
    const double* weights, double box_min, double* partial, double* out,
    int T, int n, int row0, int rows, int q, int L, int tile_rows,
    void* stream) {
  if (n <= 0 || n > interval::kMaxRow || q <= 0 || tile_rows <= 0 ||
      tile_rows > kMaxTileRows || kMaxTileRows % tile_rows != 0 || T < 0 ||
      L < 0 || row0 < 0 || rows <= 0 || row0 + rows > n ||
      rebuild_shared_bytes(n, q, tile_rows) > kMaxSharedBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles = (n + tile_rows - 1) / tile_rows;
  if (static_cast<long long>(T) * rows * tiles > 0x7fffffffLL ||
      static_cast<long long>(L) * T > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t bytes = rebuild_shared_bytes(n, q, tile_rows);
  cudaError_t e = cudaFuncSetAttribute(
      contract3_rebuild_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (T == 0 || L == 0) return 0;
  // the block size that keeps the most threads resident per SM (the
  // sweep is latency-bound: one 1024-thread block per SM at n = 300,
  // two of 512 at n = 180); the result's bits do not depend on it
  int threads = kRebuildMinThreads, resident = 0;
  for (int t = kRebuildMinThreads; t <= kRebuildMaxThreads; t *= 2) {
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, contract3_rebuild_kernel, t, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm * t > resident) {
      resident = per_sm * t;
      threads = t;
    }
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  contract3_rebuild_kernel<<<T * rows * tiles, threads, bytes, s>>>(
      z, fin, lu, p, w1, w2, g, sigma_inv, student, nu, log_norm, logdet, x,
      bounds, weights, box_min, partial, T, n, row0, rows, q, L, tile_rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int sums = L * T;  // one per (bound row, day)
  contract3_sum_kernel<<<(sums + kSumThreads - 1) / kSumThreads, kSumThreads,
                         0, s>>>(partial, out, rows * tiles, sums);
  return static_cast<int>(cudaGetLastError());
}
