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
//   solve_stages3      (f64, one card) the dim-3 solve's two stage sweeps
//                      and its stage-2 bracket in one launch, the widest
//                      bracket folded into a device word
//                      (solve_stages3_kernel);
//   bisect3            (f64, one card) the dim-3 bisection from that word:
//                      one launcher call enqueues every halving and the
//                      roots, with no host read (bisect3_kernel).
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
//     reads; (c) the walk: thread r adds row r's cells in index order to
//     the row's running prefix sum, which it keeps at lo - 1 and
//     differences at hi - 1 as it passes them (`capture`, out of line). No
//     row is stored and no thread waits on a scan: the prefix is the walk.
//     A walk of one thread per row kept a warp walking as far as its
//     longest row: late in a bisection, where a band narrower than a grid
//     step leaves one row in ten or fewer with an interval, a warp formed
//     one cell a step for 32 lanes (32 times the cells needed on the
//     n = 300 query's last halvings, 1.1-1.5 times on its stage sweeps).
//     So the cells are formed where lanes are free: `rank_walks` ranks the
//     tile's rows by length; below `own`, the length of the kOwnWalk-th
//     longest, each row forms its own cells (the dense part, at the rate
//     of the old walk); past it the block forms the remaining cells
//     column by column, 64 a step into a stage in shared memory, and each
//     row's thread takes its staged cells in index order. Sharing a cell
//     costs ~1.4 times forming one alone (the stage, a barrier a step, the
//     row's columns loaded per cell), so rows walk alone while 48 of 64
//     walk (40-56 within 1.5 % on the n = 300 query). Measured on an H100
//     80GB HBM3 at 700 W, a 500-day n = 300 query at level 0.05: the
//     last 13 halvings 277.0 -> 106.2 ms (47.2 -> 32.5 ms down to 1.56
//     -> 1.10 ms, where the floor is (a) for 750 000 blocks), their
//     formation share (the cells needed over the ms at the flag pass's
//     cells per ms) 0.305 -> 0.441 down to 0.002 -> 0.004; the stage
//     sweeps and first 9 halvings, 1.1-1.3 times their cells walked
//     before, 482.9 -> 487.7 ms (share ~0.65): ranking and sharing cost
//     there what they save; the query 760.1 -> 593.5 ms. The row flag
//     does not depend on the bounds, so it comes from the flag table
//     (contract3_row_flags, built once per backtest): a flagged row adds
//     its cells to each interval's sum instead, as interval::row_sum
//     does. Without a table (flags null:
//     the route where not even the flags fit in the card's memory) every
//     row with an interval is walked whole, flagged by the scan and summed
//     both ways. Either way every branch is the table route's and every
//     row adds its cells in index order, so a row's sum, the lanes r and
//     r + 32 and the warp_sum of each partial (l, t, i0, tile) are its
//     bits. What bounds it now: the float64 arithmetic of the cells (one
//     exp, one log1p and one division each) in the dense part, at ~0.8
//     of the flag kernel's rate a lane (80 registers, 24 warps a SM, to
//     the flag kernel's 64 and 32). Bound rows go in turns of kWalkRows
//     per launch; a partial depends on (l, t, i0, tile) alone, so that
//     changes no bit.
//   * contract3_flags_kernel: one block per (t, i0) slab, warps over rows,
//     lanes over cells (`cell`): the whole cube once, bound by its f64
//     arithmetic as the table build is, with one byte per row out.
//   * One sweep body: contract3_sweep_kernel, solve_stages3_kernel and
//     bisect3_kernel run each turn of bound rows through `sweep_turn` (the
//     lookups, warp_sum, the fixed-order day sum) after `load_sweep_day`,
//     so every sweep of the fused solve has the bits K4's launch gives
//     for the same bounds and weights.
//   * solve_stages3_kernel: one block per day, thread dl on row l0 + dl of
//     a turn: the stage-1 bounds into shared memory, a sweep_turn, the
//     stage-2 bounds each row's F1 picks (interval.cuh's
//     `stage2_bounds`), a second sweep_turn, then `bracket` (ops/
//     solvers.py::bracket_state_batched's selects) and `fold_width`, as
//     solve_stages_kernel does at dim 2. Both sweeps of a day need only
//     that day's F1, so one block holds the whole stage.
//   * bisect3_kernel: the composed route halves all (row, day) states
//     together and takes two decisions over every day after each halving
//     (ops/cuda_solver.py::_halving): a row whose results are all exactly
//     0 freezes, and the loop runs on while some row not frozen holds a
//     bracket wider than the tolerance. A block holds one day, so no block
//     can take them inside the halving that needs them. Launch k therefore
//     writes its candidate state beside the state and folds, per row, two
//     integer words by atomicOr ("some result is not 0", "some candidate
//     is still wide"): the same words in any order. Launch k + 1, in every
//     block, first takes halving k's decisions from those words, as
//     _halving takes them, commits the candidate or keeps the state per
//     (row, day), and only then halves. The count is the host's (the
//     widest word through interval::device_halvings); a launch past it
//     exits at once, and the last writes the roots. Each (row, day) state
//     is so, after every halving, the composed route's, freeze and exit
//     included, bit for bit; the decisions are integers and the arithmetic
//     is the composed route's (__dadd_rn / __dsub_rn / __ddiv_rn, K4's
//     slab). The state a turn holds across its sweep sits in shared
//     memory, so both fused kernels keep to 64 registers and four blocks a
//     SM (kSolveMinBlocks): 500 days in one wave, each halving as fast as
//     K4's launch (82 us late in a d3 query on an H100 SXM at 700 W).
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
// cudaErrorInvalidValue for shapes the kernels do not take). The two of
// the fused solve have an f64 form alone (`cvt_solve_stages3`,
// `cvt_bisect3`).

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
// the fused solve's kernels: blocks of kSweepThreads resident per SM (64
// registers a thread), so the d3 book's 500 days run in one wave on the
// H100's 132 SMs; at 98 registers (two blocks a SM) each halving ran
// ~30 % slower than K4's sweep
constexpr int kSolveMinBlocks = 4;
constexpr int kSpan = 64;  // consecutive i1 of one lookup task, 2 per lane
constexpr int kSumThreads = 128;
constexpr int kFlagsThreads = 256;
// rebuild: one thread per row of a kSpan-row tile; the resident blocks per
// SM its registers are sized for (12, 80 registers a thread, ran faster on
// the H100 than 8 or 10 with more, or 16, which spill; so did one cell per
// step of the walk against two or three)
constexpr int kRebuildMinBlocks = 12;
// the rebuild's rows form their own cells while at least kOwnWalk of a
// tile's kSpan rows walk, and share the rest of the tile's cells (a
// shared cell costs ~1.4 times one formed alone)
constexpr int kOwnWalk = 48;
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

// The table sweep's prologue, one block per day t: x and the day's row
// flags (rows, n) into shared memory, then a block barrier.
template <typename Real>
__device__ __forceinline__ void load_sweep_day(
    const unsigned char* __restrict__ flags, const Real* __restrict__ x,
    Real* xs, unsigned char* fl, int t, int n, int rows) {
  const size_t cells = static_cast<size_t>(rows) * n;  // the day's rows
  for (int j = threadIdx.x; j < n; j += blockDim.x) xs[j] = x[j];
  for (size_t j = threadIdx.x; j < cells; j += blockDim.x)
    fl[j] = flags[t * cells + j];
  __syncthreads();
}

// One turn of the table sweep of day t: nl <= kSumRows bound rows, row dl
// between bnd[dl * bstride] and bnd[dl * bstride + 1] under the weights
// w[3 dl], w[3 dl + 1], w[3 dl + 2]. The body of every dim-3 table sweep
// (contract3_sweep_kernel and the fused solve's two kernels), so every
// sweep has its bits. Warps take the day's tasks (i0, k) (slab i0 of
// `day`, the k-th span of kSpan rows i1 = k kSpan + c 32 + lane, c = 0
// then 1) and run the bound rows of a task in turn: each lane's rows by
// interval::row_sum on the stored rows (a flagged row: its cells), the
// lanes' sums by warp_sum into the partial (dl, t, i0, k) in shared memory
// (part, (nl, rows * spans)). After a block barrier thread dl adds row
// dl's partials in index order and rounds the sum to Real once into
// out[dl * ostride]. Every thread of the block calls it; it ends on a
// block barrier, so `out` is visible to the block and `part` and `bnd`
// free again.
template <typename Real>
__device__ __forceinline__ void sweep_turn(
    const Real* __restrict__ day,  // (rows, stride): the day's slabs
    const unsigned char* fl, const Real* xs, const Real* bnd, size_t bstride,
    const Real* __restrict__ w, Real box_min, double* part, Real* out,
    size_t ostride, int n, int row0, int rows, int nl, int pitch,
    int stride) {
  using R = Rn<Real>;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int spans = (n + kSpan - 1) / kSpan;  // tasks per slab
  const int m = rows * spans;                 // partials per (l, t)
  for (int task = warp; task < m; task += kSweepWarps) {
    const int i0 = task / spans;  // the range's slab, grid point row0 + i0
    const int k = task - i0 * spans;
    const Real* slab = day + static_cast<size_t>(i0) * stride;
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
      const Real b_lo = bnd[dl * bstride];
      const Real b_up = bnd[dl * bstride + 1];
      const Real w_in = w[3 * dl];
      const Real p0w = R::mul(x0, w[3 * dl + 1]);
      const Real w_o2 = w[3 * dl + 2];
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
    out[dl * ostride] = static_cast<Real>(sum);
  }
  __syncthreads();  // the turn's partials read before the next overwrites
}

// The table sweep: one block per day t. The block first takes x and the
// day's row flags into shared memory (load_sweep_day), then runs the bound
// rows in turns of kSumRows (sweep_turn), each row's bounds from `bounds`
// and its sum into out[l, t].
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
  __shared__ Real xs[interval::kShortRow];
  extern __shared__ __align__(16) unsigned char sweep_shared[];
  const int t = blockIdx.x;
  const int m = rows * ((n + kSpan - 1) / kSpan);  // partials per (l, t)
  double* part = reinterpret_cast<double*>(sweep_shared);  // (kSumRows, m)
  unsigned char* fl = reinterpret_cast<unsigned char*>(
      part + static_cast<size_t>(min(L, kSumRows)) * m);  // (rows, n)
  load_sweep_day(flags, x, xs, fl, t, n, rows);
  const Real* day = u + static_cast<size_t>(t) * rows * stride;
  for (int l0 = 0; l0 < L; l0 += kSumRows) {
    const size_t o = static_cast<size_t>(l0) * T + t;
    sweep_turn(day, fl, xs, bounds + 2 * o, 2 * static_cast<size_t>(T),
               weights + 3 * l0, box_min, part, out + o,
               static_cast<size_t>(T), n, row0, rows,
               min(kSumRows, L - l0), pitch, stride);
  }
}

// solve_stages3 (f64, one card, whole days): one block per day t, bound
// rows l in turns of kSumRows, thread dl on row l0 + dl. Per turn: the
// stage-1 sweep over [-100, first_guess], the stage-2 bounds each row's
// result picks, their sweep (both by sweep_turn: K4's bits), then the
// bracket's selects (interval::bracket, bracket_state_batched's order);
// the state stored and max(upper - lower, 0) folded into *widest (zeroed
// by the launcher), as solve_stages_kernel folds it at dim 2.
__global__ void __launch_bounds__(kSweepThreads, kSolveMinBlocks)
solve_stages3_kernel(const double* __restrict__ u,  // (T, n, stride)
                     const unsigned char* __restrict__ flags,  // (T, n, n)
                     const double* __restrict__ x,        // (n,)
                     const double* __restrict__ obj,      // (L,)
                     const double* __restrict__ weights,  // (L, 3)
                     interval::StageConfig cfg, double box_min,
                     double* __restrict__ lower,      // (L, T)
                     double* __restrict__ upper,      // (L, T)
                     double* __restrict__ prev_res,   // (L, T)
                     double* __restrict__ prev_up,    // (L, T)
                     unsigned char* __restrict__ ustack,   // (L, T)
                     unsigned char* __restrict__ nan_day,  // (L, T)
                     unsigned long long* widest,  // atomics: no restrict
                     int T, int n, int L, int pitch, int stride) {
  __shared__ double xs[interval::kShortRow];
  __shared__ double bnd[2 * kSumRows];  // the turn's slabs
  __shared__ double res[kSumRows];      // the turn's sweep results
  __shared__ double stage1[kSumRows];   // the turn's F1
  extern __shared__ __align__(16) unsigned char sweep_shared[];
  const int t = blockIdx.x;
  const int m = n * ((n + kSpan - 1) / kSpan);
  double* part = reinterpret_cast<double*>(sweep_shared);
  unsigned char* fl = reinterpret_cast<unsigned char*>(
      part + static_cast<size_t>(min(L, kSumRows)) * m);
  load_sweep_day(flags, x, xs, fl, t, n, n);
  const double* day = u + static_cast<size_t>(t) * n * stride;
  const int dl = threadIdx.x;
  for (int l0 = 0; l0 < L; l0 += kSumRows) {
    const int nl = min(kSumRows, L - l0);
    const bool mine = dl < nl;
    const size_t o = static_cast<size_t>(l0 + dl) * T + t;
    if (mine) {
      bnd[2 * dl] = -100.0;
      bnd[2 * dl + 1] = cfg.fg;
    }
    __syncthreads();
    // a sweep's bits depend on (bounds, weights row, t) alone: F1 is the
    // stage-1 sweep's (L, T) entry whether one row or every row computes it
    sweep_turn(day, fl, xs, bnd, 2, weights + 3 * l0, box_min, part, res, 1,
               n, 0, n, nl, pitch, stride);
    if (mine) {
      const interval::Slab2 s2 = interval::stage2_bounds(res[dl],
                                                         obj[l0 + dl], cfg);
      stage1[dl] = res[dl];
      bnd[2 * dl] = s2.lower;
      bnd[2 * dl + 1] = s2.upper;
    }
    __syncthreads();
    // F1 and the stage-2 bounds stay in shared memory across the sweep
    sweep_turn(day, fl, xs, bnd, 2, weights + 3 * l0, box_min, part, res, 1,
               n, 0, n, nl, pitch, stride);
    if (mine) {
      const interval::Bracket b =
          interval::bracket(stage1[dl], res[dl], obj[l0 + dl], bnd[2 * dl],
                            bnd[2 * dl + 1], cfg);
      lower[o] = b.lo;
      upper[o] = b.hi;
      prev_res[o] = b.res;
      prev_up[o] = b.prev_up;
      ustack[o] = b.ustack;
      nan_day[o] = b.nan;
      interval::fold_width(widest, b.lo, b.hi);
    }
  }
}

// The device bisection's words (int32, zeroed by the launcher), after
// halving k of k_max for bound row l: nz[k][l], some result of the row is
// not exactly 0; wd[k][l], some candidate bracket of the row is wider than
// the tolerance (both folded by atomicOr: the same words in any order);
// and before halving k (k <= k_max), brk[k][l], the row frozen, and
// run[k], the loop's condition (stored by block 0 of launch k).
struct BisectWords {
  int* nz;
  int* wd;
  int* brk;
  int* run;
  int L;

  __host__ __device__ BisectWords(int* w, int k_max, int L)
      : nz(w),
        wd(w + static_cast<size_t>(k_max) * L),
        brk(w + 2 * static_cast<size_t>(k_max) * L),
        run(w + (3 * static_cast<size_t>(k_max) + 1) * L),
        L(L) {}

  // the ints of k_max halvings of L rows
  __host__ __device__ static size_t count(int k_max, int L) {
    return (3 * static_cast<size_t>(k_max) + 1) * L + k_max + 1;
  }

  // halving k - 1's decisions for row l (k >= 1): brk, the row frozen
  // before halving k (frozen before, or its results all exactly 0 while
  // the loop ran), and kept, whether halving k - 1 left the row's state as
  // it was (_halving's `frozen`: that, or the loop no longer running)
  struct Decision {
    bool brk, kept;
  };
  __device__ __forceinline__ Decision decide(int k, int l) const {
    const size_t j = static_cast<size_t>(k - 1) * L + l;
    const bool ran = run[k - 1] != 0;
    const bool brk_before = brk[j] != 0;
    const bool zero = nz[j] == 0 && ran;
    return {brk_before || zero, zero || brk_before || !ran};
  }
};

// Launch k of the dim-3 device bisection (f64, one card, whole days), k =
// 0 .. k_max, one block per day t, thread dl on row l0 + dl of each turn of
// kSumRows rows. The count K = min(device_halvings(*widest), k_max) is the
// host-counted route's; a launch past it exits at once. Launch k (k >= 1)
// first takes halving k - 1's decisions, which need every day's results
// and so could not be taken inside it: each row's freeze (brk) and the
// loop's condition (`running`: it ran, and some row not frozen holds a
// candidate bracket wider than the tolerance), and commits each (row, day)
// state: the candidate of halving k - 1 where the row moved, else the
// state before it (the inputs after halving 0). Launch K writes the roots
// (lo + up) / 2. Every other launch, while the loop runs, halves: the
// slab of each state by sweep_turn, then res = prev_res +- slab, and the
// candidate state into the second buffer, with the row's words. So the
// state after halving k is _halving's, bit for bit, freeze and exit
// included; state and candidate are each (4, L, T) float64 + (L, T) bytes.
__global__ void __launch_bounds__(kSweepThreads, kSolveMinBlocks)
bisect3_kernel(const double* __restrict__ u,  // (T, n, stride)
               const unsigned char* __restrict__ flags,  // (T, n, n)
               const double* __restrict__ x,             // (n,)
               const double* __restrict__ lower,         // (L, T)
               const double* __restrict__ upper,         // (L, T)
               const double* __restrict__ prev_res,      // (L, T)
               const double* __restrict__ prev_up,       // (L, T)
               const unsigned char* __restrict__ ustack,  // (L, T)
               const double* __restrict__ obj,            // (L,)
               const double* __restrict__ weights,        // (L, 3)
               double box_min,
               const unsigned long long* __restrict__ widest,  // (1,)
               double tolerance, int k_max, int k,
               double* state,  // (8, L, T): the state, then the candidate
               unsigned char* ustate,  // (2, L, T): their ustack
               int* words,             // BisectWords
               double* __restrict__ roots,  // (L, T)
               int T, int n, int L, int pitch, int stride) {
  const int count =
      min(interval::device_halvings(*widest, tolerance), k_max);
  if (k > count) return;
  __shared__ double xs[interval::kShortRow];
  __shared__ double bnd[2 * kSumRows];
  __shared__ double res[kSumRows];
  // the turn's states (lo, up, prev_res, prev_up; ustack) across its sweep
  __shared__ double row_state[4 * kSumRows];
  __shared__ bool row_us[kSumRows];
  extern __shared__ __align__(16) unsigned char sweep_shared[];
  const BisectWords bw(words, k_max, L);
  const int t = blockIdx.x;
  const size_t plane = static_cast<size_t>(L) * T;
  double* s_lo = state;  // the state before halving k
  double* s_up = state + plane;
  double* s_pr = state + 2 * plane;
  double* s_pu = state + 3 * plane;
  double* c_lo = state + 4 * plane;  // halving k's candidate
  double* c_up = state + 5 * plane;
  double* c_pr = state + 6 * plane;
  double* c_pu = state + 7 * plane;
  unsigned char* s_us = ustate;
  unsigned char* c_us = ustate + plane;

  bool running = true;  // halving 0 runs whenever K > 0
  if (k == 0) {
    if (blockIdx.x == 0 && threadIdx.x == 0) bw.run[0] = 1;
  } else {
    int wide = 0;
    for (int l = threadIdx.x; l < L; l += blockDim.x) {
      const bool brk_now = bw.decide(k, l).brk;
      wide |= !brk_now && bw.wd[static_cast<size_t>(k - 1) * L + l] != 0;
      if (blockIdx.x == 0) bw.brk[static_cast<size_t>(k) * L + l] = brk_now;
    }
    // every thread reaches the barrier before the loop's last condition
    running = __syncthreads_or(wide) != 0 && bw.run[k - 1] != 0;
    if (blockIdx.x == 0 && threadIdx.x == 0) bw.run[k] = running;
  }
  const bool halve = k < count && running;  // the same in every block

  const int m = n * ((n + kSpan - 1) / kSpan);
  double* part = reinterpret_cast<double*>(sweep_shared);
  unsigned char* fl = reinterpret_cast<unsigned char*>(
      part + static_cast<size_t>(min(L, kSumRows)) * m);
  if (halve) load_sweep_day(flags, x, xs, fl, t, n, n);
  const double* day = u + static_cast<size_t>(t) * n * stride;
  const int dl = threadIdx.x;
  for (int l0 = 0; l0 < L; l0 += kSumRows) {
    const int nl = min(kSumRows, L - l0);
    const bool mine = dl < nl;
    if (mine) {
      const int l = l0 + dl;
      const size_t o = static_cast<size_t>(l) * T + t;
      double lo, up, pr, pu;
      bool us;
      if (k == 0) {
        lo = lower[o];
        up = upper[o];
        pr = prev_res[o];
        pu = prev_up[o];
        us = ustack[o] != 0;
      } else {
        if (!bw.decide(k, l).kept) {
          lo = c_lo[o];
          up = c_up[o];
          pr = c_pr[o];
          pu = c_pu[o];
          us = c_us[o] != 0;
        } else if (k == 1) {
          lo = lower[o];
          up = upper[o];
          pr = prev_res[o];
          pu = prev_up[o];
          us = ustack[o] != 0;
        } else {
          lo = s_lo[o];
          up = s_up[o];
          pr = s_pr[o];
          pu = s_pu[o];
          us = s_us[o] != 0;
        }
        s_lo[o] = lo;
        s_up[o] = up;
        s_pr[o] = pr;
        s_pu[o] = pu;
        s_us[o] = us;
      }
      const double mid = __ddiv_rn(__dadd_rn(lo, up), 2.0);
      if (k == count) roots[o] = mid;
      row_state[4 * dl] = lo;
      row_state[4 * dl + 1] = up;
      row_state[4 * dl + 2] = pr;
      row_state[4 * dl + 3] = pu;
      row_us[dl] = us;
      bnd[2 * dl] = us ? lo : mid;
      bnd[2 * dl + 1] = us ? mid : up;
    }
    if (!halve) continue;
    __syncthreads();
    sweep_turn(day, fl, xs, bnd, 2, weights + 3 * l0, box_min, part, res, 1,
               n, 0, n, nl, pitch, stride);
    if (mine) {
      // the state back from shared memory: no register holds it across
      // the sweep, which keeps the kernel to kSolveMinBlocks a SM
      const int l = l0 + dl;
      const size_t o = static_cast<size_t>(l) * T + t;
      const double lo = row_state[4 * dl];
      const double up = row_state[4 * dl + 1];
      const double pr = row_state[4 * dl + 2];
      const double pu = row_state[4 * dl + 3];
      const double mid = __ddiv_rn(__dadd_rn(lo, up), 2.0);
      const double b_lo = row_us[dl] ? lo : mid;
      const double slab = res[dl];
      const double result = b_lo == pu ? __dadd_rn(pr, slab)
                                       : __dsub_rn(pr, slab);
      const bool below = result < obj[l];
      const double clo = below ? mid : lo;
      const double cup = below ? up : mid;
      c_lo[o] = clo;
      c_up[o] = cup;
      c_pr[o] = result;
      c_pu[o] = mid;
      c_us[o] = below;
      const size_t j = static_cast<size_t>(k) * L + l;
      if (!(result == 0.0) && __ldcg(bw.nz + j) == 0) atomicOr(bw.nz + j, 1);
      if (__dsub_rn(cup, clo) > tolerance && __ldcg(bw.wd + j) == 0)
        atomicOr(bw.wd + j, 1);
    }
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

// the rebuild's walk schedule (`rank_walks`): two stages of kSpan cells,
// and the tile's row lengths, each rank's length and row, each segment's
// first pair and the warps' sums (4 kSpan + 4 ints)
template <typename Real>
__host__ __device__ constexpr size_t walk_shared_bytes() {
  return 2 * kSpan * sizeof(Real) + (4 * kSpan + 4) * sizeof(int);
}

// rebuild: x (n,), the (q, n) fold, per (bound row, tile row) the row's
// masked sum, walking full rows (no flag table) its cell-by-cell sum, and
// the packed interval, and the walk's schedule
template <typename Real>
__host__ __device__ size_t rebuild_shared_bytes(int n, int q, int rows_l,
                                                bool full) {
  const size_t lookups = static_cast<size_t>(rows_l) * kSpan;
  return align8((static_cast<size_t>(n) + static_cast<size_t>(q) * n) *
                sizeof(Real)) +
         lookups * (full ? 2 : 1) * sizeof(double) + lookups * sizeof(int) +
         walk_shared_bytes<Real>();
}

// The row flags: flags[t, local, i1] = 1 when a cell of the whole row
// (t, row0 + local, i1) lies outside [-kMaxCell, kMaxCell] or is NaN, the
// test of interval::scan_row on the same cells (`cell`). One block
// per (t, local) slab; warps take rows, lanes columns. The flagged rows
// are added to *flagged, one integer atomic per warp that flagged any
// (the same count in any order).
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
                       int* __restrict__ flagged,          // (1,)
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
  int warp_flagged = 0;
  for (int i1 = warp; i1 < n; i1 += kFlagsThreads / 32) {
    bool ok = true;
    for (int j = lane; j < n; j += 32)
      ok &= fabs(cell(sl, w1, a, q, i1, j)) <= interval::kMaxCell;
    const bool row_flagged = __any_sync(0xffffffffu, !ok);
    if (lane == 0) out[i1] = row_flagged;
    warp_flagged += row_flagged;
  }
  if (lane == 0 && warp_flagged > 0) atomicAdd(flagged, warp_flagged);
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

// The walk's schedule of one tile, in shared memory. The rows ranked by
// their walk lengths, longest first (ties by row); *own = ls[kOwnWalk - 1]
// the length of the kOwnWalk-th longest, the columns each row walks alone
// (at least kOwnWalk rows walk there). The pairs (row, j), own <= j <
// len, are shared: enumerated column by column and by rank within a
// column, with ls[m] the length of rank m past `own` (0 where shorter), so
// that the ranks [0, a_j) walk column own + j. Where exactly k rows walk,
// own + [ls[k], ls[k - 1]), the pair (rank m, column own + j) is first[k]
// + (j - ls[k]) k + m, with first[k] = k ls[k] + sum_{m >= k} ls[m]
// (first[kSpan] = 0, first[0] the pairs shared). Integer sums: the same
// table in any order. Block-wide; ends on a barrier. Returns thread r's
// rank.
__device__ __forceinline__ int rank_walks(int* lens, int* ls, int* order,
                                          int* first, int* wsum, int len,
                                          int* own) {
  const int r = threadIdx.x;
  lens[r] = len;
  __syncthreads();
  int rank = 0;
  for (int m = 0; m < kSpan; ++m) {
    const int o = lens[m];
    rank += (o > len) || (o == len && m < r);
  }
  ls[rank] = len;
  order[rank] = r;
  if (r == 0) ls[kSpan] = 0;
  __syncthreads();
  *own = ls[kOwnWalk - 1];
  const int v = max(ls[r] - *own, 0);
  // the suffix sum of the shared lengths from rank r: within the warp,
  // then the later warps' totals
  const int lane = r & 31;
  int s = v;
  for (int off = 1; off < 32; off <<= 1) {
    const int u = __shfl_down_sync(0xffffffffu, s, off);
    if (lane + off < 32) s += u;
  }
  if (lane == 0) wsum[r >> 5] = s;
  __syncthreads();
  for (int w = (r >> 5) + 1; w < kSpan / 32; ++w) s += wsum[w];
  ls[r] = v;
  first[r] = r * v + s;
  if (r == 0) first[kSpan] = 0;
  __syncthreads();
  return rank;
}

// The sweep without U. One block of kSpan threads per (t, i0) slab and
// tile of kSpan consecutive i1 rows; `rows_l` bound rows per launch. The
// block first reads each row's interval per bound row (interval::counts_le
// on x), so row r needs its cells [0, len_r), len_r the longest hi of its
// non-empty intervals. Thread r forms row r's cells below `own`
// (`rank_walks`: at least kOwnWalk rows walk each such column); the cells
// past it are shared: the block's threads form them in turn, kSpan a step
// (thread r the pair step kSpan + r of `rank_walks`' order, into a stage
// in shared memory). Thread r adds row r's cells in index order, its own
// and then its staged ones, to the row's running prefix sum (a flagged
// row: to the sums of the intervals that hold it), capturing the prefix at
// lo - 1 and hi - 1 as it passes them. The flags come from the flag table;
// without one (`flags` null) every row with an interval is walked whole,
// flagged by the scan and summed both ways (kFull, one instantiation
// each). Either way each row's masked sum is interval::row_sum's over the
// full row's prefix, bit for bit, and the partial of each (l, t, i0, tile)
// adds lanes r and r + 32 and then warp_sum, as contract3_sweep_kernel
// adds a span.
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
  Real* stage = reinterpret_cast<Real*>(         // (2, kSpan)
      sums + lookups * (kFull ? 2 : 1));
  int* spans = reinterpret_cast<int*>(stage + 2 * kSpan);  // (rows_l, kSpan)
  int* lens = spans + lookups;                   // (kSpan,)
  int* ls = lens + kSpan;                        // (kSpan + 1,)
  int* order = ls + kSpan + 1;                   // (kSpan,)
  int* first = order + kSpan;                    // (kSpan + 1,)
  int* wsum = first + kSpan + 1;                 // (kSpan / 32,)
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

  // 2. the walks: row r's cells [0, len) in index order, the first `own`
  // formed by thread r, the rest by the block in turn, all added up by
  // thread r (rank_walks' barriers order the fold before the first cell)
  const int len = reach > 0 ? (kFull ? n : reach) : 0;
  int own;
  const int rank = rank_walks(lens, ls, order, first, wsum, len, &own);
  const int total = first[0];  // the pairs shared
  const Slab<Real> sl = make_slab(z, fin, lu, p, sigma_inv, student, nu,
                                  log_norm, logdet, t, i0, n);
  const bool flagged =
      !kFull && len > 0 &&
      flags[(static_cast<size_t>(t) * rows + local) * n + i1] != 0;
  double run = 0.0;  // the row's inclusive prefix sum
  bool ok = true;    // kFull: no cell outside [-kMaxCell, kMaxCell] yet
  int next = len;
  if (len > 0) next = capture<Real>(sums, spans, r, rows_l, -1, run, len);
  // cell c of row r at column j, in index order: the walk's loop body
  auto take = [&](int j, Real c) {
    if (flagged) {
      add_in_flagged(sums, spans, r, rows_l, j, c);
      return;
    }
    if (kFull) {
      ok &= fabs(c) <= interval::kMaxCell;
      if (j < reach) add_in(cell_sums, spans, r, rows_l, j, c);
    }
    run += static_cast<double>(c);
    if (j == next) next = capture<Real>(sums, spans, r, rows_l, j, run, len);
  };
  const int alone = min(len, own);
  for (int j = 0; j < alone; ++j) take(j, cell(sl, w1, a, q, i1, j));
  // the shared pairs thread r forms: pair pf = step kSpan + r, in the
  // segment of fk rows that ends at pair fend, at column fcol and rank fm;
  // a step moves it kSpan pairs on, fq columns and fr ranks within a
  // segment
  int pf = r, fk = kSpan + 1, fend = 0, fcol = 0, fm = 0, fq = 0, fr = 0;
  // row r's next shared cell: column own + j, pair pw, in the segment of
  // wk rows whose columns end at own + wend, its pairs wbase + j wk
  int j = 0, wk = kSpan + 1, wend = 0, wbase = 0, pw = 0;
  if (len > own) {
    wk = kSpan;
    while (ls[wk - 1] <= j) --wk;
    wend = ls[wk - 1];
    wbase = first[wk] - ls[wk] * wk + rank;
    pw = wbase;
  }
  const int shared_len = len - alone;
  for (int base = 0; base < total; base += kSpan) {
    Real* st = stage + ((base / kSpan) & 1) * kSpan;
    if (pf < total) {
      if (pf >= fend) {
        do {
          --fk;
          fend = first[fk - 1];
        } while (pf >= fend);
        const int off = pf - first[fk];
        fcol = own + ls[fk] + off / fk;
        fm = off % fk;
        fq = kSpan / fk;
        fr = kSpan % fk;
      }
      st[r] = cell(sl, w1, a, q, r0 + order[fm], fcol);
      pf += kSpan;
      fcol += fq;
      fm += fr;
      if (fm >= fk) {
        fm -= fk;
        ++fcol;
      }
    }
    __syncthreads();
    // row r's staged cells, in index order
    while (j < shared_len && pw < base + kSpan) {
      take(own + j, st[pw - base]);
      if (++j == wend && j < shared_len) {
        while (ls[wk - 1] <= j) --wk;
        wend = ls[wk - 1];
        wbase = first[wk] - ls[wk] * wk + rank;
      }
      pw = wbase + j * wk;
    }
  }
  if (kFull && !ok) {
    for (int l = 0; l < rows_l; ++l)
      sums[l * kSpan + r] = cell_sums[l * kSpan + r];
  }
  __syncthreads();

  // 3. the partials: warps take the bound rows, lanes rows r and r + 32
  const int lane = threadIdx.x & 31;
  for (int l = threadIdx.x >> 5; l < rows_l; l += kSpan / 32) {
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

// The fused dim-3 solve's operands: whole days of the table (u (T, n,
// stride), flags (T, n, n)) the sweep takes, L rows.
bool valid_solve3(int T, int n, int L, int pitch, int stride) {
  return T >= 0 && L >= 0 && valid_layout<double>(n, pitch, stride) &&
         static_cast<long long>(T) * n <= 0x7fffffffLL &&
         static_cast<long long>(L) * T <= 0x7fffffffLL &&
         sweep_shared_bytes(n, n, L) <= kMaxSharedBytes;
}

// solve_stages3: the state (L, T) of every row and day and *widest, zeroed
// here on the stream before the kernel folds into it.
int solve_stages3(const double* u, const unsigned char* flags,
                  const double* x, const double* obj, const double* weights,
                  interval::StageConfig cfg, double box_min, double* lower,
                  double* upper, double* prev_res, double* prev_up,
                  unsigned char* ustack, unsigned char* nan_day,
                  unsigned long long* widest, int T, int n, int L, int pitch,
                  int stride, void* stream) {
  if (!valid_solve3(T, n, L, pitch, stride))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = sweep_shared_bytes(n, n, L);
  cudaError_t e = cudaFuncSetAttribute(
      solve_stages3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (T == 0 || L == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  e = cudaMemsetAsync(widest, 0, sizeof(*widest), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  solve_stages3_kernel<<<T, kSweepThreads, bytes, s>>>(
      u, flags, x, obj, weights, cfg, box_min, lower, upper, prev_res,
      prev_up, ustack, nan_day, widest, T, n, L, pitch, stride);
  return static_cast<int>(cudaGetLastError());
}

// bisect3: the words (BisectWords::count(k_max, L) ints) zeroed on the
// stream, then k_max + 1 launches of bisect3_kernel (halvings 0 ..
// k_max - 1, each gated on the device by the count and the loop's
// condition, and the roots), with no host read; state (8, L, T) and
// ustate (2, L, T) scratch, roots (L, T).
int bisect3(const double* u, const unsigned char* flags, const double* x,
            const double* lower, const double* upper, const double* prev_res,
            const double* prev_up, const unsigned char* ustack,
            const double* obj, const double* weights, double box_min,
            const unsigned long long* widest, double tolerance, int k_max,
            double* state, unsigned char* ustate, int* words, double* roots,
            int T, int n, int L, int pitch, int stride, void* stream) {
  if (!valid_solve3(T, n, L, pitch, stride) || k_max < 0 ||
      k_max > interval::kMaxHalvings || widest == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = sweep_shared_bytes(n, n, L);
  cudaError_t e = cudaFuncSetAttribute(
      bisect3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (T == 0 || L == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  e = cudaMemsetAsync(words, 0, BisectWords::count(k_max, L) * sizeof(int),
                      s);
  if (e != cudaSuccess) return static_cast<int>(e);
  for (int k = 0; k <= k_max; ++k) {
    bisect3_kernel<<<T, kSweepThreads, bytes, s>>>(
        u, flags, x, lower, upper, prev_res, prev_up, ustack, obj, weights,
        box_min, widest, tolerance, k_max, k, state, ustate, words, roots, T,
        n, L, pitch, stride);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

// The row flags of the outer slabs [row0, row0 + rows) of every day:
// flags (T, rows, n) bytes; *flagged (set to 0 by the caller) gains the
// number of flagged rows.
template <typename Real>
int contract3_row_flags(const Real* z, const unsigned char* fin,
                        const Real* lu, const Real* p, const Real* w1,
                        const Real* w2, const Real* g,
                        const double* sigma_inv, int student, double nu,
                        double log_norm, double logdet, unsigned char* flags,
                        int* flagged, int T, int n, int row0, int rows, int q,
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
      flags, flagged, T, n, row0, rows, q);
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
      double logdet, unsigned char* flags, int* flagged, int T, int n,        \
      int row0, int rows, int q, void* stream) {                              \
    return contract3_row_flags<Real>(z, fin, lu, p, w1, w2, g, sigma_inv,     \
                                     student, nu, log_norm, logdet, flags,    \
                                     flagged, T, n, row0, rows, q, stream);   \
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

// The f64 fused dim-3 solve on one card (no f32 form): the stages, and the
// bisection counting its halvings from the widest bracket on the device.
extern "C" int cvt_solve_stages3(
    const double* u, const unsigned char* flags, const double* x,
    const double* obj, const double* weights, double first_guess, double sg0,
    double sg1, double min_var, double max_var, int quirks, double box_min,
    double* lower, double* upper, double* prev_res, double* prev_up,
    unsigned char* ustack, unsigned char* nan_day, unsigned long long* widest,
    int T, int n, int L, int pitch, int stride, void* stream) {
  const interval::StageConfig cfg{first_guess, sg0, sg1,
                                  min_var, max_var, quirks != 0};
  return solve_stages3(u, flags, x, obj, weights, cfg, box_min, lower, upper,
                       prev_res, prev_up, ustack, nan_day, widest, T, n, L,
                       pitch, stride, stream);
}

extern "C" int cvt_bisect3(
    const double* u, const unsigned char* flags, const double* x,
    const double* lower, const double* upper, const double* prev_res,
    const double* prev_up, const unsigned char* ustack, const double* obj,
    const double* weights, double box_min, const unsigned long long* widest,
    double tolerance, int k_max, double* state, unsigned char* ustate,
    int* words, double* roots, int T, int n, int L, int pitch, int stride,
    void* stream) {
  return bisect3(u, flags, x, lower, upper, prev_res, prev_up, ustack, obj,
                 weights, box_min, widest, tolerance, k_max, state, ustate,
                 words, roots, T, n, L, pitch, stride, stream);
}
