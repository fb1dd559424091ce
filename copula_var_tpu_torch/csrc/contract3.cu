// Hand-written Hopper (sm_90a) kernels of the three-asset (dim-3) VaR
// serving path, templates over the working type Real (real.cuh): double
// for the f64 `xla` engine, float for the f32 engine (`engine="pallas"`,
// the JAX package's f32 `_kernel3`); each C launcher has an f64 form and
// an `_f32` form with the same arguments. Together they replace
// copula_var_tpu/ops/pallas_quadrature3.py::_kernel3 (K4), the dim-3
// masked quadrature: (L, T) slab integrals for L bound rows.
//
//   contract3_weights  builds, once per backtest, the bounds-invariant
//                      table U (T, n, n, n) in device memory in the form
//                      the sweep reads (rows padded to an odd pitch, see
//                      below): the cells (contract3_weights_kernel), then
//                      each row as its inclusive prefix sum over i2, or
//                      as its cells where it is flagged, with a byte per
//                      (t, i0, i1) row that says which
//                      (contract3_scan_kernel);
//   masked_contract3   every sweep of the dim-3 solve (stage 1, stage 2,
//                      each bisection halving): each row lookup reads the
//                      two prefixes at its interval's ends, and each day's
//                      partials are summed in a fixed order in the same
//                      launch (contract3_sweep_kernel).
//   contract3_row_flags
//                      builds, once per backtest that sweeps without U, a
//                      byte per (t, i0, i1) row: 1 where a cell of the
//                      whole row is outside [-kMaxCell, kMaxCell] or NaN
//                      (contract3_flags_kernel); the table's build writes
//                      the same bytes;
//   masked_contract3_rebuild
//                      the same sweep with no table: every launch forms
//                      from the transform columns the cells its lookups
//                      read, each row's prefix [0, max_l hi)
//                      (contract3_rebuild_kernel), then sums the partials
//                      (contract3_sum_kernel). It serves the grids the
//                      table cannot: n past the build's one-slab shared
//                      memory (169 at q = 5), or a U larger than the
//                      card's free memory.
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
//   * contract3_weights_kernel writes T*n^3 cells (4.0 GB in f64 at T =
//     500, n = 100): ~1.2 ms of HBM writes, against ~5e8 cells of f64
//     arithmetic with one log1p and one exp each. One block per (t, i0)
//     slab, the cell arithmetic of the former fused kernel (same __dmul_rn
//     / __dadd_rn order), written to global memory. Rows (i1) have an odd
//     pitch p = n | 1 (one zero pad cell when n is even) and each (t, i0)
//     slab a stride of n*p rounded up to 16 bytes, so every slab starts on
//     16 bytes.
//   * contract3_scan_kernel turns the table into its stored form in place,
//     one block per slab: the slab into shared memory (its odd pitch puts
//     the rows that one thread each scans on distinct bank pairs), each
//     row into its inclusive prefix sum in index order by interval::
//     scan_row (in double, each prefix rounded to Real where it is
//     stored), a flagged row left as its cells, and the slab and its row
//     flags back out, the flagged rows counted. One more read and write of
//     the table, once per backtest; no second buffer. The slab in one block's shared memory
//     is what limits the table route's n (169 in f64, the short rows'
//     192 in f32).
//   * contract3_sweep_kernel reads no slab and scans no row: a row lookup
//     is interval::row_sum on the stored row: the row's dynamic bounds
//     (two divisions), two binary searches on x in shared memory and,
//     where the interval holds a grid point, the two prefixes at its ends
//     (a flagged row: its cells [lo, hi)). One block per day t holds
//     every slab of the day, its row flags (in shared memory) and every
//     bound row. Its warps take tasks (i0, k), the k-th span of kSpan
//     = 64 consecutive i1, two rows per lane, and run the bound rows of a
//     task in turn, so the lookups of one row follow each other and hit
//     the same ~0.8 KB row in L1. Each (l, task) writes its warp's sum to
//     the partial (l, t, i0, k) in shared memory: a partial's bits depend
//     on (l, t, i0, k) alone, not on L or on which warp takes it, so a row
//     gets the same result alone or in a batch. After a block barrier the
//     block adds each day's partials in index order, rounded to Real once
//     (the order of the rebuild's sum kernel, in the same launch). What
//     bounds it on the H100 at T = 500, n = 100: not bytes (two 32-byte
//     sectors per non-empty lookup, ~55 MB a sweep at L = 1) but the
//     instructions of all L*T*n^2 lookups, whatever their intervals hold:
//     0.12-0.18 ms a sweep at L = 1, 2-3 ms at L = 32, where a probe that
//     multiplied instead of dividing took 20-40 % less. Two tasks or four
//     side by side in a warp ran slower (more registers, fewer warps).
//   * Outer slabs: the sum over i0 is linear, so the build and the sweep
//     take a range of slabs, i0 in [row0, row0 + rows) of the n outer grid
//     points (grid sharding: each rank builds and sweeps the table of its
//     range, U (T, rows, stride), and the ranks' partial sums add up to
//     the whole day). The columns z, lu, fin, p and G stay whole and are
//     read at row0 + the local slab. At row0 = 0, rows = n every launch is
//     the one-card launch, bit for bit.
//   * contract3_rebuild_kernel. Its first form built all n^2 cells of every
//     slab on every sweep, then scanned each row by one thread while the
//     other 960 of its 1024 waited (242.5 ms a full-T n = 300 sweep on an
//     H100 SXM at 700 W). A masked sum reads only S[lo - 1] and S[hi - 1] of
//     a row's prefix, and a solve's bounds sit in the lower tail, so a sweep
//     needs the cells [0, hi) of each row with an interval: 5-25 % of the
//     cube, and less late in a bisection, where most intervals hold no grid
//     point. One block of 64 threads per (t, i0) slab and tile of 64 i1
//     rows (a lookup span of contract3_sweep_kernel), thread r on row r:
//     (a) each row's (lo, hi) per bound row from x, the bounds and the
//     weights alone; a tile where every interval is empty writes its 0.0
//     partials and stops; (b) the (q, n) fold of the columns the tile
//     reads; (c) each thread walks its row in index order to the longest hi
//     of its bound rows, forming each cell with `cell` and adding it to the
//     row's running prefix sum, which it keeps at lo - 1 and differences at
//     hi - 1 as the walk passes them (`capture`, out of line). No row is
//     stored and no thread waits on a scan: the prefix is the walk. The
//     row flag does not depend on the bounds, so it comes from the flag
//     table (contract3_row_flags, built once per backtest): a flagged row
//     adds its cells to each interval's sum instead, as interval::row_sum
//     does. Without a table (flags null: the route where not even the flags
//     fit in the card's memory) every row with an interval is walked whole,
//     flagged by the scan and summed both ways. Either way every branch is
//     the table route's, so a row's sum, the lanes r and r + 32 and the
//     warp_sum of each partial (l, t, i0, tile) are its bits. What bounds
//     it now: the float64 arithmetic of the cells walked (one exp, one
//     log1p and one division each), at a lower rate than the flag kernel's
//     because a warp walks as far as its longest row; small blocks (12
//     resident per SM) let one tile's tail overlap another's walk. Bound
//     rows go in turns of kWalkRows per launch; a partial depends on (l, t,
//     i0, tile) alone, so that changes no bit.
//   * contract3_flags_kernel: one block per (t, i0) slab, warps over rows,
//     lanes over cells (`cell`): the whole cube once, bound by its f64
//     arithmetic as the table build is, with one byte per row out.
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
// In float: the columns, G, the weight rows, x, the bounds and weights
// and the cells are float; the copula constants (sigma_inv, nu, the
// normalizer, logdet) arrive as doubles and are formed and rounded to
// float as the plain twin's torch operations round them; every cell is
// formed with the Rn<float> intrinsics and the accurate expf / log1pf.
// Every prefix, row sum and partial is a double, rounded to float where it
// is stored (U's prefix rows, the rebuild's captured prefixes, each day's
// sum), so the f32 routes give each other's bits as the f64 routes do. U
// in float is half the bytes (2.02 GB at T = 500, n = 100); a slab's
// stride is rounded up to four floats (16 bytes), and one padded slab fits
// a block's shared memory up to n = 240, so the table takes the short
// rows, n <= 192.
//
// Launchers: plain C, no allocation, no synchronisation, launched on the
// caller's stream; each returns cudaGetLastError() (or
// cudaErrorInvalidValue for shapes the kernels do not take).

#include <cfloat>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "interval.cuh"
#include "real.cuh"

namespace {

constexpr int kWeightsThreads = 256;
constexpr int kScanThreads = 256;  // one per row, n <= kShortRow
constexpr int kSweepThreads = 256;
constexpr int kSweepWarps = kSweepThreads / 32;
constexpr int kSumRows = 16;  // the sweep's bound rows per turn
constexpr int kSpan = 64;  // consecutive i1 of one lookup task, 2 per lane
constexpr int kSumThreads = 128;
constexpr int kFlagsThreads = 256;
// rebuild: one thread per row of a kSpan-row tile; the resident blocks per
// SM its registers are sized for (12, 80 registers a thread, ran faster on
// the H100 than 8 or 10 with more, or 16, which spill; so did one cell per
// step of the walk against two or three)
constexpr int kRebuildMinBlocks = 12;
// bound rows per launch (more go in turns; its home is ops/_build.py)
#ifndef CVT_WALK_ROWS
#error "build through copula_var_tpu_torch/ops/_build.py: it defines the limits"
#endif
constexpr int kWalkRows = CVT_WALK_ROWS;
constexpr size_t kMaxSharedBytes = CVT_MAX_SHARED_BYTES;  // opt-in per block
static_assert(kScanThreads >= interval::kShortRow, "a thread per row");

template <typename Real>
__host__ __device__ size_t weights_shared_bytes(int n, int q) {
  return static_cast<size_t>(q) * n * sizeof(Real);
}

// the scan: one padded slab (stride Reals)
template <typename Real>
__host__ __device__ size_t scan_shared_bytes(int stride) {
  return static_cast<size_t>(stride) * sizeof(Real);
}

// the sweep: a turn's partials (min(L, kSumRows), rows * spans) and the
// day's row flags (rows, n)
__host__ __device__ inline size_t sweep_shared_bytes(int n, int rows, int L) {
  const size_t m = static_cast<size_t>(rows) * ((n + kSpan - 1) / kSpan);
  return m * (L < kSumRows ? L : kSumRows) * sizeof(double) +
         static_cast<size_t>(rows) * n;
}

template <typename Real>
__device__ __forceinline__ Real nan_to_num(Real v) {
  if (v != v) return Real(0);
  if (v == Real(CUDART_INF)) return Rn<Real>::max();
  if (v == -Real(CUDART_INF)) return -Rn<Real>::max();
  return v;
}

// The copula density of one slab (day t, outer point i0) at cells (i1, i2),
// times the marginal pdfs (GARCH, nan_to_num), from the transform columns;
// its per-slab constants are formed once (`Slab`). Both the table build and
// the rebuild sweep take their cells from `cell`, so the two hold the same
// bits. The constants come in as doubles: each is formed in double and
// rounded to Real once, as torch rounds a float64 scalar against a float32
// tensor (the identity for double).
template <typename Real>
struct Slab {
  const Real* z1;
  const Real* z2;
  const Real* lu1;
  const Real* lu2;
  const unsigned char* f1;
  const unsigned char* f2;
  const Real* p;  // the day's (3, n) pdf columns; null: MSM
  Real z0, lu0, p0, zz0, q00;
  Real s01x2, s02x2, s11, s12x2, s22, coef;
  bool f0;
  int n, student;
  Real nu, log_norm, logdet;
};

template <typename Real>
__device__ __forceinline__ Slab<Real> make_slab(
    const Real* __restrict__ z, const unsigned char* __restrict__ fin,
    const Real* __restrict__ lu, const Real* __restrict__ p,
    const double* __restrict__ sigma_inv, int student, double nu,
    double log_norm, double logdet, int t, int i0, int n) {
  Slab<Real> s;
  const size_t day = static_cast<size_t>(t) * 3 * n;
  s.s01x2 = static_cast<Real>(2.0 * sigma_inv[1]);
  s.s02x2 = static_cast<Real>(2.0 * sigma_inv[2]);
  s.s11 = static_cast<Real>(sigma_inv[4]);
  s.s12x2 = static_cast<Real>(2.0 * sigma_inv[5]);
  s.s22 = static_cast<Real>(sigma_inv[8]);
  s.coef = static_cast<Real>((nu + 3.0) / 2.0);
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
  s.p0 = p != nullptr ? p[day + i0] : Real(0);
  s.zz0 = Rn<Real>::mul(s.z0, s.z0);
  s.q00 = Rn<Real>::mul(static_cast<Real>(sigma_inv[0]), s.zz0);
  s.n = n;
  s.student = student;
  s.nu = static_cast<Real>(nu);
  s.log_norm = static_cast<Real>(log_norm);
  s.logdet = static_cast<Real>(logdet);
  return s;
}

// A[b, i2] = sum_c G[t, i0, b, c] W2[c, i2]: one entry, in c order
template <typename Real>
__device__ __forceinline__ Real fold_entry(const Real* __restrict__ gt,
                                           const Real* __restrict__ w2,
                                           int q, int n, int b, int j) {
  Real s = 0.0;
  for (int c = 0; c < q; ++c) s += gt[b * q + c] * w2[c * n + j];
  return s;
}

// the columns [0, cols) of A into shared memory (q, n)
template <typename Real>
__device__ __forceinline__ void fold_w2(const Real* __restrict__ gt,
                                        const Real* __restrict__ w2,
                                        Real* a, int q, int n, int cols) {
  for (int idx = threadIdx.x; idx < q * cols; idx += blockDim.x) {
    const int b = idx / cols;
    const int j = idx - b * cols;
    a[b * n + j] = fold_entry(gt, w2, q, n, b, j);
  }
}

// U[t, i0, i1, i2] = V * sum_b W1[b, i1] A[b, i2]
template <typename Real>
__device__ __forceinline__ Real cell(const Slab<Real>& s,
                                     const Real* __restrict__ w1,
                                     const Real* a, int q, int i1, int i2) {
  using R = Rn<Real>;
  const int n = s.n;
  const Real za = s.z1[i1];
  const Real zb = s.z2[i2];
  // z^T Sigma^-1 z in the plain twin's order
  Real quad = R::add(s.q00, R::mul(s.s01x2, R::mul(s.z0, za)));
  quad = R::add(quad, R::mul(s.s02x2, R::mul(s.z0, zb)));
  quad = R::add(quad, R::mul(s.s11, R::mul(za, za)));
  quad = R::add(quad, R::mul(s.s12x2, R::mul(za, zb)));
  quad = R::add(quad, R::mul(s.s22, R::mul(zb, zb)));
  Real v;
  if (s.student) {
    const Real log_mvt =
        R::sub(s.log_norm, R::mul(s.coef, R::log1p(R::div(quad, s.nu))));
    const Real lu_sum = R::add(R::add(s.lu0, s.lu1[i1]), s.lu2[i2]);
    v = R::exp(R::sub(log_mvt, lu_sum));
    if (!(s.f0 && s.f1[i1] != 0 && s.f2[i2] != 0)) v = R::nan();
  } else {
    const Real sum_z2 = R::add(R::add(s.zz0, R::mul(za, za)), R::mul(zb, zb));
    v = R::exp(R::mul(Real(-0.5), R::sub(R::add(s.logdet, quad), sum_z2)));
  }
  if (s.p != nullptr) {
    v = nan_to_num(
        R::mul(v, R::mul(R::mul(s.p0, s.p[n + i1]), s.p[2 * n + i2])));
  }
  Real h = 0.0;
  for (int b = 0; b < q; ++b) h += w1[b * n + i1] * a[b * n + i2];
  // rounded here: a caller that adds the cell to a sum (the rebuild's
  // prefix walk) must not get it contracted into an FMA
  return R::mul(v, h);
}

template <typename Real>
__global__ void __launch_bounds__(kWeightsThreads)
contract3_weights_kernel(const Real* __restrict__ z,             // (T, 3, n)
                         const unsigned char* __restrict__ fin,  // (T, 3, n)
                         const Real* __restrict__ lu,            // (T, 3, n)
                         const Real* __restrict__ p,  // (T, 3, n); null: MSM
                         const Real* __restrict__ w1,            // (q, n)
                         const Real* __restrict__ w2,            // (q, n)
                         const Real* __restrict__ g,         // (T, n, q, q)
                         const double* __restrict__ sigma_inv,   // (3, 3)
                         int student, double nu, double log_norm,
                         double logdet,
                         Real* __restrict__ u,  // (T, rows, stride)
                         int T, int n, int row0, int rows, int q, int pitch,
                         int stride) {
  extern __shared__ __align__(16) unsigned char weights_shared[];
  Real* a = reinterpret_cast<Real*>(weights_shared);  // (q, n)
  const int t = blockIdx.x / rows;
  const int i0 = row0 + (blockIdx.x - t * rows);  // grid point of the slab
  fold_w2(g + (static_cast<size_t>(t) * n + i0) * q * q, w2, a, q, n, n);
  __syncthreads();
  const Slab<Real> sl = make_slab(z, fin, lu, p, sigma_inv, student, nu,
                                  log_norm, logdet, t, i0, n);
  Real* slab = u + static_cast<size_t>(blockIdx.x) * stride;
  for (int idx = threadIdx.x; idx < stride; idx += blockDim.x) {
    const int i1 = idx / pitch;
    const int i2 = idx - i1 * pitch;
    // pad cells: defined, never summed
    slab[idx] = (i1 >= n || i2 >= n) ? Real(0) : cell(sl, w1, a, q, i1, i2);
  }
}

// The stored form, in place, one block per (t, local) slab: the slab into
// shared memory, each row i1 < n by thread i1 through interval::scan_row
// (its inclusive prefix sum in index order, or its cells where it holds a
// cell outside [-kMaxCell, kMaxCell] or NaN), the row's flag out, the
// slab's flagged rows added to *flagged (an integer atomic: the same count
// in any order), and the slab back. Pads are copied as they are (0).
template <typename Real>
__global__ void __launch_bounds__(kScanThreads)
contract3_scan_kernel(Real* __restrict__ u,  // (T, rows, stride)
                      unsigned char* __restrict__ flags,  // (T, rows, n)
                      int* __restrict__ flagged,          // (1,)
                      int n, int pitch, int stride) {
  extern __shared__ __align__(16) unsigned char scan_shared[];
  Real* slab = reinterpret_cast<Real*>(scan_shared);
  Real* cells = u + static_cast<size_t>(blockIdx.x) * stride;
  for (int j = threadIdx.x; j < stride; j += blockDim.x) slab[j] = cells[j];
  __syncthreads();
  const int i1 = threadIdx.x;
  bool f = false;
  if (i1 < n) {
    f = interval::scan_row(slab + static_cast<size_t>(i1) * pitch, n);
    flags[static_cast<size_t>(blockIdx.x) * n + i1] = f;
  }
  const int slab_flagged = __syncthreads_count(f);
  if (threadIdx.x == 0 && slab_flagged > 0) atomicAdd(flagged, slab_flagged);
  for (int j = threadIdx.x; j < stride; j += blockDim.x) cells[j] = slab[j];
}

// The table sweep: one block per day t. The block first takes x and the
// day's row flags into shared memory. Warps take the
// day's tasks (i0, k) (slab i0, the k-th span of kSpan rows i1 = k kSpan +
// c 32 + lane, c = 0 then 1) and run the bound rows l of a task in turn:
// each lane's rows by interval::row_sum on the stored rows (a flagged row:
// its cells), the lanes' sums by warp_sum into the partial (l, t, i0, k)
// in shared memory. Bound rows go in turns of kSumRows; after each turn
// thread l adds the day's partials of row l in index order and rounds the
// sum to Real once into out[l, t].
template <typename Real>
__global__ void __launch_bounds__(kSweepThreads)
contract3_sweep_kernel(const Real* __restrict__ u,  // (T, rows, stride)
                       const unsigned char* __restrict__ flags,  // (T, rows, n)
                       const Real* __restrict__ x,        // (n,)
                       const Real* __restrict__ bounds,   // (L, T, 2)
                       const Real* __restrict__ weights,  // (L, 3)
                       Real box_min,
                       Real* __restrict__ out,  // (L, T)
                       int T, int n, int row0, int rows, int L, int pitch,
                       int stride) {
  using R = Rn<Real>;
  __shared__ Real xs[interval::kShortRow];
  extern __shared__ __align__(16) unsigned char sweep_shared[];
  const int t = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int spans = (n + kSpan - 1) / kSpan;  // tasks per slab
  const int m = rows * spans;                 // partials per (l, t)
  const size_t cells = static_cast<size_t>(rows) * n;  // the day's rows
  double* part = reinterpret_cast<double*>(sweep_shared);  // (kSumRows, m)
  unsigned char* fl = reinterpret_cast<unsigned char*>(
      part + static_cast<size_t>(min(L, kSumRows)) * m);  // (rows, n)
  for (int j = threadIdx.x; j < n; j += blockDim.x) xs[j] = x[j];
  for (size_t j = threadIdx.x; j < cells; j += blockDim.x)
    fl[j] = flags[t * cells + j];
  __syncthreads();

  for (int l0 = 0; l0 < L; l0 += kSumRows) {
    const int nl = min(kSumRows, L - l0);
    for (int task = warp; task < m; task += kSweepWarps) {
      const int i0 = task / spans;  // the range's slab, grid point row0 + i0
      const int k = task - i0 * spans;
      const Real* slab = u + (static_cast<size_t>(t) * rows + i0) * stride;
      const Real x0 = xs[row0 + i0];
      const Real* row[kSpan / 32];
      Real xi[kSpan / 32];
      bool flagged[kSpan / 32];
#pragma unroll
      for (int c = 0; c < kSpan / 32; ++c) {
        const int i1 = k * kSpan + c * 32 + lane;
        const bool in = i1 < n;
        row[c] = in ? slab + static_cast<size_t>(i1) * pitch : nullptr;
        xi[c] = in ? xs[i1] : Real(0);
        flagged[c] = in && fl[i0 * n + i1] != 0;
      }
      for (int dl = 0; dl < nl; ++dl) {
        const int l = l0 + dl;
        const size_t o = static_cast<size_t>(l) * T + t;
        const Real b_lo = bounds[2 * o];
        const Real b_up = bounds[2 * o + 1];
        const Real w_in = weights[3 * l];
        const Real p0w = R::mul(x0, weights[3 * l + 1]);
        const Real w_o2 = weights[3 * l + 2];
        double acc = 0.0;
#pragma unroll
        for (int c = 0; c < kSpan / 32; ++c) {
          if (row[c] != nullptr) {
            const Real prev = R::add(p0w, R::mul(xi[c], w_o2));
            const Real dup = R::div(R::sub(b_up, prev), w_in);
            const Real d = R::div(R::sub(b_lo, prev), w_in);
            // NaN-propagating max, as torch.maximum
            const Real dlo = (d > box_min || d != d) ? d : box_min;
            acc += interval::row_sum<interval::kShortTop>(
                row[c], row[c], flagged[c], xs, n, dlo, dup);
          }
        }
        acc = interval::warp_sum(acc);
        if (lane == 0) part[static_cast<size_t>(dl) * m + task] = acc;
      }
    }
    __syncthreads();  // every partial of the turn in shared memory
    for (int dl = threadIdx.x; dl < nl; dl += blockDim.x) {
      const double* pr = part + static_cast<size_t>(dl) * m;
      double sum = 0.0;
#pragma unroll 8
      for (int i = 0; i < m; ++i) sum += pr[i];
      out[static_cast<size_t>(l0 + dl) * T + t] = static_cast<Real>(sum);
    }
    __syncthreads();  // the turn's partials read before the next overwrites
  }
}

// out[r] = sum_k partial[r, k] over the row's m partials, in index order,
// rounded to Real once (the rebuild's partials)
template <typename Real>
__global__ void contract3_sum_kernel(const double* __restrict__ partial,
                                     Real* __restrict__ out, int m,
                                     int rows) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const double* pr = partial + static_cast<size_t>(r) * m;
  double s = 0.0;
  for (int i = 0; i < m; ++i) s += pr[i];
  out[r] = static_cast<Real>(s);
}

// bytes rounded up to a multiple of 8 (a double array after Real ones)
__host__ __device__ constexpr size_t align8(size_t bytes) {
  return (bytes + 7) / 8 * 8;
}

// rebuild: x (n,), the (q, n) fold, and per (bound row, tile row) the
// row's masked sum, walking full rows (no flag table) its cell-by-cell sum,
// and the packed interval
template <typename Real>
__host__ __device__ size_t rebuild_shared_bytes(int n, int q, int rows_l,
                                                bool full) {
  const size_t lookups = static_cast<size_t>(rows_l) * kSpan;
  return align8((static_cast<size_t>(n) + static_cast<size_t>(q) * n) *
                sizeof(Real)) +
         lookups * (full ? 2 : 1) * sizeof(double) + lookups * sizeof(int);
}

// The row flags: flags[t, local, i1] = 1 when a cell of the whole row
// (t, row0 + local, i1) lies outside [-kMaxCell, kMaxCell] or is NaN, the
// test of interval::scan_row on the same cells (`cell`). One block
// per (t, local) slab; warps take rows, lanes columns.
template <typename Real>
__global__ void __launch_bounds__(kFlagsThreads)
contract3_flags_kernel(const Real* __restrict__ z,             // (T, 3, n)
                       const unsigned char* __restrict__ fin,  // (T, 3, n)
                       const Real* __restrict__ lu,            // (T, 3, n)
                       const Real* __restrict__ p,  // (T, 3, n); null: MSM
                       const Real* __restrict__ w1,            // (q, n)
                       const Real* __restrict__ w2,            // (q, n)
                       const Real* __restrict__ g,         // (T, n, q, q)
                       const double* __restrict__ sigma_inv,   // (3, 3)
                       int student, double nu, double log_norm,
                       double logdet,
                       unsigned char* __restrict__ flags,  // (T, rows, n)
                       int T, int n, int row0, int rows, int q) {
  extern __shared__ __align__(16) unsigned char flags_shared[];
  Real* a = reinterpret_cast<Real*>(flags_shared);  // (q, n)
  const int t = blockIdx.x / rows;
  const int i0 = row0 + (blockIdx.x - t * rows);
  fold_w2(g + (static_cast<size_t>(t) * n + i0) * q * q, w2, a, q, n, n);
  __syncthreads();
  const Slab<Real> sl = make_slab(z, fin, lu, p, sigma_inv, student, nu,
                                  log_norm, logdet, t, i0, n);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  unsigned char* out = flags + static_cast<size_t>(blockIdx.x) * n;
  for (int i1 = warp; i1 < n; i1 += kFlagsThreads / 32) {
    bool ok = true;
    for (int j = lane; j < n; j += 32)
      ok &= fabs(cell(sl, w1, a, q, i1, j)) <= interval::kMaxCell;
    const bool flagged = __any_sync(0xffffffffu, !ok);
    if (lane == 0) out[i1] = flagged;
  }
}

// The intervals of row r (packed spans, (rows_l, kSpan)) that the walk
// passes at j, its running prefix `run`: S[lo - 1] kept, then S[hi - 1] -
// S[lo - 1] (S[hi - 1] when lo = 0) stored in sums, each prefix as the
// table stores it (interval::stored: rounded to Real). Returns the next j
// that ends an interval, len when none does. Out of line: the walk's hot
// loop calls it once or twice per interval, and keeps its registers.
template <typename Real>
__device__ __noinline__ int capture(double* sums, const int* spans, int r,
                                    int rows_l, int j, double run, int len) {
  const double s = interval::stored<Real>(run);
  int next = len;
  for (int l = 0; l < rows_l; ++l) {
    const int k = l * kSpan + r;
    const int sp = spans[k];
    if (sp == 0) continue;
    const int lo = sp & 0xffff;
    const int hi = sp >> 16;
    if (j == lo - 1) sums[k] = s;
    if (j == hi - 1) sums[k] = lo > 0 ? s - sums[k] : s;
    if (lo - 1 > j) next = min(next, lo - 1);
    if (hi - 1 > j) next = min(next, hi - 1);
  }
  return next;
}

// Cell c of row r at j added, in index order, to the sum of every interval
// of the row that holds j (a flagged row's masked sums).
__device__ __forceinline__ void add_in(double* to, const int* spans, int r,
                                       int rows_l, int j, double c) {
  for (int l = 0; l < rows_l; ++l) {
    const int k = l * kSpan + r;
    const int sp = spans[k];
    if (j >= (sp & 0xffff) && j < (sp >> 16)) to[k] += c;
  }
}

// add_in out of line, for the rows the flag table flags (rare)
__device__ __noinline__ void add_in_flagged(double* to, const int* spans,
                                            int r, int rows_l, int j,
                                            double c) {
  add_in(to, spans, r, rows_l, j, c);
}

// The sweep without U. One block of kSpan threads per (t, i0) slab and
// tile of kSpan consecutive i1 rows, thread r on row i1 = r0 + r; `rows_l`
// bound rows per launch. The block first reads each row's interval per
// bound row (interval::counts_le on x), then walks each row in index order
// only as far as its longest interval reaches, forming each cell with
// `cell` and adding it to the row's running prefix sum (a flagged row:
// to the sums of the intervals that hold it), and captures the prefix at
// lo - 1 and hi - 1 as the walk passes them. The flags come from the flag
// table; without one (`flags` null) every row with an interval is walked
// whole, flagged by the scan and summed both ways (kFull, one
// instantiation each). Either way each row's masked sum is
// interval::row_sum's over the full row's prefix, bit for bit, and the
// partial of each (l, t, i0, tile) adds lanes r and r + 32 and then
// warp_sum, as contract3_sweep_kernel adds a span.
template <typename Real, bool kFull>
__global__ void __launch_bounds__(kSpan, kRebuildMinBlocks)
contract3_rebuild_kernel(const Real* __restrict__ z,             // (T, 3, n)
                         const unsigned char* __restrict__ fin,  // (T, 3, n)
                         const Real* __restrict__ lu,            // (T, 3, n)
                         const Real* __restrict__ p,  // (T, 3, n); null: MSM
                         const Real* __restrict__ w1,            // (q, n)
                         const Real* __restrict__ w2,            // (q, n)
                         const Real* __restrict__ g,         // (T, n, q, q)
                         const double* __restrict__ sigma_inv,   // (3, 3)
                         int student, double nu, double log_norm,
                         double logdet,
                         // (T, rows, n) row flags; null: full rows
                         const unsigned char* __restrict__ flags,
                         const Real* __restrict__ x,        // (n,)
                         const Real* __restrict__ bounds,   // (L, T, 2)
                         const Real* __restrict__ weights,  // (L, 3)
                         Real box_min,
                         double* __restrict__ partial,  // (L, T, rows, tiles)
                         int T, int n, int row0, int rows, int q,
                         int rows_l) {
  using R = Rn<Real>;
  extern __shared__ __align__(16) unsigned char rebuild_shared[];
  __shared__ int warp_reach[kSpan / 32];
  const int tiles = (n + kSpan - 1) / kSpan;
  const size_t lookups = static_cast<size_t>(rows_l) * kSpan;
  Real* xs = reinterpret_cast<Real*>(rebuild_shared);   // (n,)
  Real* a = xs + n;                                     // (q, n)
  double* sums = reinterpret_cast<double*>(             // (rows_l, kSpan)
      rebuild_shared +
      align8((static_cast<size_t>(n) + static_cast<size_t>(q) * n) *
             sizeof(Real)));
  double* cell_sums = sums + lookups;            // kFull: (rows_l, kSpan)
  int* spans = reinterpret_cast<int*>(sums + lookups * (kFull ? 2 : 1));
  const int tile = blockIdx.x % tiles;
  const int s = blockIdx.x / tiles;  // the slab (t, local)
  const int t = s / rows;
  const int local = s - t * rows;
  const int i0 = row0 + local;       // its grid point
  const int r0 = tile * kSpan;       // the tile's first i1
  const int nr = min(kSpan, n - r0);
  const int r = threadIdx.x;
  const int i1 = r0 + r;

  for (int j = threadIdx.x; j < n; j += blockDim.x) xs[j] = x[j];
  __syncthreads();

  // 1. lookups before cells: each row's (lo, hi) per bound row (packed lo |
  // hi << 16, 0 for an interval that row_sum makes 0) and the prefix length
  // the row's lookups read
  int reach = 0;
  if (r < nr) {
    const Real x0 = xs[i0];
    for (int l = 0; l < rows_l; ++l) {
      const size_t o = static_cast<size_t>(l) * T + t;
      const Real b_lo = bounds[2 * o];
      const Real b_up = bounds[2 * o + 1];
      const Real w_in = weights[3 * l];
      const Real p0w = R::mul(x0, weights[3 * l + 1]);
      const Real prev = R::add(p0w, R::mul(xs[i1], weights[3 * l + 2]));
      const Real dup = R::div(R::sub(b_up, prev), w_in);
      const Real d = R::div(R::sub(b_lo, prev), w_in);
      // NaN-propagating max, as torch.maximum
      const Real dlo = (d > box_min || d != d) ? d : box_min;
      int lo = 0, hi = 0;
      if (!(dlo != dlo || dup != dup))
        interval::counts_le<interval::kMaxTop>(xs, n, dlo, dup, &lo, &hi);
      const size_t k = static_cast<size_t>(l) * kSpan + r;
      spans[k] = hi > lo ? (lo | hi << 16) : 0;
      sums[k] = 0.0;
      if (kFull) cell_sums[k] = 0.0;
      if (hi > lo) reach = max(reach, hi);
    }
  }
  const int warp_max = __reduce_max_sync(0xffffffffu, reach);
  if ((threadIdx.x & 31) == 0) warp_reach[threadIdx.x >> 5] = warp_max;
  if (!__syncthreads_or(reach > 0)) {
    // every interval of the tile empty: each partial is the 0.0 the full
    // form adds up
    for (int l = threadIdx.x; l < rows_l; l += blockDim.x)
      partial[((static_cast<size_t>(l) * T + t) * rows + local) * tiles +
              tile] = 0.0;
    return;
  }
  int cols = n;  // the fold's columns the walks read
  if (!kFull) {
    cols = 0;
    for (int w = 0; w < kSpan / 32; ++w) cols = max(cols, warp_reach[w]);
  }
  fold_w2(g + (static_cast<size_t>(t) * n + i0) * q * q, w2, a, q, n, cols);
  __syncthreads();

  // 2. the walk of row r: cells [0, len) in index order
  if (reach > 0) {
    const Slab<Real> sl = make_slab(z, fin, lu, p, sigma_inv, student, nu,
                                    log_norm, logdet, t, i0, n);
    const bool flagged =
        !kFull && flags[(static_cast<size_t>(t) * rows + local) * n + i1] != 0;
    const int len = kFull ? n : reach;
    double run = 0.0;  // the row's inclusive prefix sum
    bool ok = true;    // kFull: no cell outside [-kMaxCell, kMaxCell] yet
    int next = capture<Real>(sums, spans, r, rows_l, -1, run, len);
    for (int j = 0; j < len; ++j) {
      const Real c = cell(sl, w1, a, q, i1, j);
      if (flagged) {
        add_in_flagged(sums, spans, r, rows_l, j, c);
        continue;
      }
      if (kFull) {
        ok &= fabs(c) <= interval::kMaxCell;
        if (j < reach) add_in(cell_sums, spans, r, rows_l, j, c);
      }
      run += static_cast<double>(c);
      if (j == next) next = capture<Real>(sums, spans, r, rows_l, j, run, len);
    }
    if (kFull && !ok) {
      for (int l = 0; l < rows_l; ++l)
        sums[l * kSpan + r] = cell_sums[l * kSpan + r];
    }
  }
  __syncthreads();

  // 3. the partials: warps take the bound rows, lanes rows r and r + 32
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int l = warp; l < rows_l; l += kSpan / 32) {
    double acc = 0.0;
#pragma unroll
    for (int c = 0; c < kSpan / 32; ++c) {
      const int rr = c * 32 + lane;
      if (rr < nr) acc += sums[static_cast<size_t>(l) * kSpan + rr];
    }
    acc = interval::warp_sum(acc);
    if (lane == 0)
      partial[((static_cast<size_t>(l) * T + t) * rows + local) * tiles +
              tile] = acc;
  }
}

// The table's layout: the odd row pitch, and a slab's stride n * pitch
// rounded up to 16 bytes; and one padded slab in a block's shared memory
// (the scan), with rows no longer than the short rows the sweep searches.
template <typename Real>
bool valid_layout(int n, int pitch, int stride) {
  constexpr long long unit = 16 / sizeof(Real);
  const long long np = static_cast<long long>(n) * pitch;
  return n > 0 && n <= interval::kShortRow &&
         pitch == interval::row_pitch(n) &&
         stride == (np + unit - 1) / unit * unit &&
         scan_shared_bytes<Real>(stride) <= kMaxSharedBytes;
}

// u: the table (T, rows, stride) of the slabs [row0, row0 + rows) of every
// day, in its stored form; flags (T, rows, n) its row flags; *flagged (set
// to 0 by the caller) gains the number of flagged rows.
template <typename Real>
int contract3_weights(const Real* z, const unsigned char* fin, const Real* lu,
                      const Real* p, const Real* w1, const Real* w2,
                      const Real* g, const double* sigma_inv, int student,
                      double nu, double log_norm, double logdet, Real* u,
                      unsigned char* flags, int* flagged, int T, int n,
                      int row0, int rows, int q, int pitch, int stride,
                      void* stream) {
  if (q <= 0 || T < 0 || !valid_layout<Real>(n, pitch, stride) ||
      row0 < 0 || rows <= 0 || row0 + rows > n ||
      static_cast<long long>(T) * rows > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t bytes = weights_shared_bytes<Real>(n, q);
  const size_t scan = scan_shared_bytes<Real>(stride);
  if (bytes > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      contract3_weights_kernel<Real>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(contract3_scan_kernel<Real>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(scan));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (T == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  contract3_weights_kernel<Real><<<T * rows, kWeightsThreads, bytes, s>>>(
      z, fin, lu, p, w1, w2, g, sigma_inv, student, nu, log_norm, logdet, u,
      T, n, row0, rows, q, pitch, stride);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  contract3_scan_kernel<Real><<<T * rows, kScanThreads, scan, s>>>(
      u, flags, flagged, n, pitch, stride);
  return static_cast<int>(cudaGetLastError());
}

// u, flags: the table and row flags of the slabs [row0, row0 + rows) of
// every day (contract3_weights), out (L, T). The sweep searches the short
// rows (interval::kShortTop), so it takes n <= 192, and a table that the
// build makes.
template <typename Real>
int masked_contract3(const Real* u, const unsigned char* flags,
                     const Real* x, const Real* bounds, const Real* weights,
                     double box_min, Real* out, int T, int n, int row0,
                     int rows, int L, int pitch, int stride, void* stream) {
  if (T < 0 || L < 0 || !valid_layout<Real>(n, pitch, stride) ||
      row0 < 0 || rows <= 0 || row0 + rows > n ||
      static_cast<long long>(T) * rows > 0x7fffffffLL ||
      static_cast<long long>(L) * T > 0x7fffffffLL ||
      static_cast<long long>(rows) * ((n + kSpan - 1) / kSpan) >
          0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t bytes = sweep_shared_bytes(n, rows, L);
  if (bytes > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      contract3_sweep_kernel<Real>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (T == 0 || L == 0) return 0;
  contract3_sweep_kernel<Real><<<T, kSweepThreads, bytes,
                                 static_cast<cudaStream_t>(stream)>>>(
      u, flags, x, bounds, weights, static_cast<Real>(box_min), out, T, n,
      row0, rows, L, pitch, stride);
  return static_cast<int>(cudaGetLastError());
}

// The row flags of the outer slabs [row0, row0 + rows) of every day:
// flags (T, rows, n) bytes
template <typename Real>
int contract3_row_flags(const Real* z, const unsigned char* fin,
                        const Real* lu, const Real* p, const Real* w1,
                        const Real* w2, const Real* g,
                        const double* sigma_inv, int student, double nu,
                        double log_norm, double logdet, unsigned char* flags,
                        int T, int n, int row0, int rows, int q,
                        void* stream) {
  if (n <= 0 || q <= 0 || T < 0 || row0 < 0 || rows <= 0 ||
      row0 + rows > n || static_cast<long long>(T) * rows > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t bytes = weights_shared_bytes<Real>(n, q);
  if (bytes > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      contract3_flags_kernel<Real>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (T == 0) return 0;
  contract3_flags_kernel<Real><<<T * rows, kFlagsThreads, bytes,
                                 static_cast<cudaStream_t>(stream)>>>(
      z, fin, lu, p, w1, w2, g, sigma_inv, student, nu, log_norm, logdet,
      flags, T, n, row0, rows, q);
  return static_cast<int>(cudaGetLastError());
}

// The sweep without a table: the columns, G and the outer slabs [row0,
// row0 + rows) of every day, in tiles of kSpan i1 rows; flags (T, rows, n)
// the row flags of those slabs, or null to walk full rows and flag them
// by the scan; partial: (L, T, rows, ceil(n / kSpan)) scratch, summed in
// order into out. Launches take up to kWalkRows bound rows each.
template <typename Real>
int masked_contract3_rebuild(
    const Real* z, const unsigned char* fin, const Real* lu, const Real* p,
    const Real* w1, const Real* w2, const Real* g, const double* sigma_inv,
    int student, double nu, double log_norm, double logdet,
    const unsigned char* flags, const Real* x, const Real* bounds,
    const Real* weights, double box_min, double* partial, Real* out, int T,
    int n, int row0, int rows, int q, int L, void* stream) {
  const bool full = flags == nullptr;
  // the limit does not depend on the flags or L: the most a launch takes
  const size_t bytes = rebuild_shared_bytes<Real>(n, q, kWalkRows, true);
  if (n <= 0 || n > interval::kMaxRow || q <= 0 || T < 0 || L < 0 ||
      row0 < 0 || rows <= 0 || row0 + rows > n || bytes > kMaxSharedBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles = (n + kSpan - 1) / kSpan;
  if (static_cast<long long>(T) * rows * tiles > 0x7fffffffLL ||
      static_cast<long long>(L) * T > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto kernel = full ? contract3_rebuild_kernel<Real, true>
                           : contract3_rebuild_kernel<Real, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (T == 0 || L == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // a partial depends on (l, t, i0, tile) alone: bound rows in turns of
  // kWalkRows give the bits of one launch
  const size_t per_row = static_cast<size_t>(T) * rows * tiles;
  for (int l0 = 0; l0 < L; l0 += kWalkRows) {
    const int rows_l = min(kWalkRows, L - l0);
    kernel<<<T * rows * tiles, kSpan,
             rebuild_shared_bytes<Real>(n, q, rows_l, full), s>>>(
        z, fin, lu, p, w1, w2, g, sigma_inv, student, nu, log_norm, logdet,
        flags, x, bounds + 2 * static_cast<size_t>(l0) * T, weights + 3 * l0,
        static_cast<Real>(box_min), partial + l0 * per_row, T, n, row0, rows,
        q, rows_l);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int sums = L * T;  // one per (bound row, day)
  contract3_sum_kernel<Real><<<(sums + kSumThreads - 1) / kSumThreads,
                               kSumThreads, 0, s>>>(partial, out,
                                                    rows * tiles, sums);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The f64 launchers and their f32 twins (same arguments, float tensors;
// sigma_inv and the partials stay double).
#define CVT_DIM3_LAUNCHERS(SUFFIX, Real)                                      \
  extern "C" int cvt_contract3_weights##SUFFIX(                               \
      const Real* z, const unsigned char* fin, const Real* lu,                \
      const Real* p, const Real* w1, const Real* w2, const Real* g,           \
      const double* sigma_inv, int student, double nu, double log_norm,       \
      double logdet, Real* u, unsigned char* flags, int* flagged, int T,      \
      int n, int row0, int rows, int q, int pitch, int stride,                \
      void* stream) {                                                         \
    return contract3_weights<Real>(z, fin, lu, p, w1, w2, g, sigma_inv,       \
                                   student, nu, log_norm, logdet, u, flags,   \
                                   flagged, T, n, row0, rows, q, pitch,       \
                                   stride, stream);                           \
  }                                                                           \
  extern "C" int cvt_masked_contract3##SUFFIX(                                \
      const Real* u, const unsigned char* flags, const Real* x,               \
      const Real* bounds, const Real* weights, double box_min, Real* out,     \
      int T, int n, int row0, int rows, int L, int pitch, int stride,         \
      void* stream) {                                                         \
    return masked_contract3<Real>(u, flags, x, bounds, weights, box_min, out, \
                                  T, n, row0, rows, L, pitch, stride,         \
                                  stream);                                    \
  }                                                                           \
  extern "C" int cvt_contract3_row_flags##SUFFIX(                             \
      const Real* z, const unsigned char* fin, const Real* lu,                \
      const Real* p, const Real* w1, const Real* w2, const Real* g,           \
      const double* sigma_inv, int student, double nu, double log_norm,       \
      double logdet, unsigned char* flags, int T, int n, int row0, int rows,  \
      int q, void* stream) {                                                  \
    return contract3_row_flags<Real>(z, fin, lu, p, w1, w2, g, sigma_inv,     \
                                     student, nu, log_norm, logdet, flags, T, \
                                     n, row0, rows, q, stream);               \
  }                                                                           \
  extern "C" int cvt_masked_contract3_rebuild##SUFFIX(                        \
      const Real* z, const unsigned char* fin, const Real* lu,                \
      const Real* p, const Real* w1, const Real* w2, const Real* g,           \
      const double* sigma_inv, int student, double nu, double log_norm,       \
      double logdet, const unsigned char* flags, const Real* x,               \
      const Real* bounds, const Real* weights, double box_min,                \
      double* partial, Real* out, int T, int n, int row0, int rows, int q,    \
      int L, void* stream) {                                                  \
    return masked_contract3_rebuild<Real>(                                    \
        z, fin, lu, p, w1, w2, g, sigma_inv, student, nu, log_norm, logdet,   \
        flags, x, bounds, weights, box_min, partial, out, T, n, row0, rows,   \
        q, L, stream);                                                        \
  }

CVT_DIM3_LAUNCHERS(, double)
CVT_DIM3_LAUNCHERS(_f32, float)
