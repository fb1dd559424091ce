// Hand-written Hopper (sm_90a) kernels of the two-asset (dim-2) VaR serving
// path, templates over the working type Real (real.cuh): double for the
// f64 `xla` engine, float for the f32 engine (`engine="pallas"`, the
// JAX package's f32 Pallas kernels). Each C launcher below has an f64
// form and an `_f32` form with the same arguments, but the two of the f64
// solve_stages route (`cvt_solve_stages`, `cvt_bisect_levels_widest`).
//
//   sweep_table    builds, once per backtest, the bounds-invariant prefix
//                  table P (T, rows, pitch) and one flag byte per (t, i)
//                  row (sweep_table_kernel).
//   masked_sweep   replaces copula_var_tpu/ops/pallas_quadrature.py
//                  ::_sweep_block_kernel (K2, B days per program) and
//                  ::_day_kernel (K3, one day per program): one masked
//                  state-sandwich sweep, (L, T) slab integrals for L bound
//                  rows, read off P (prefix_sweep_kernel). It also serves the
//                  stage-1 and stage-2 sweeps that
//                  pallas_solver.py::_full_solve computes as XLA einsums.
//   bisect_levels  replaces copula_var_tpu/ops/pallas_solver.py
//                  ::_solve_kernel (K1): the fixed-count bisection for L
//                  rows (confidence levels or portfolios) of one day.
//   solve_stages   (f64 only) the two stage sweeps and the stage-2 bracket
//                  of the f64 solve on one card (what the JAX package's
//                  `xla` engine computes as XLA ops before its while-loop,
//                  and the port otherwise as two K2 launches and ~30 eager
//                  ops), with the widest bracket folded on the device, so
//                  K1 reads its halving count there (solve_stages_kernel).
//
// Both sweep and bisection sum U[i, j] = V[i, j] * sum_k wfc[i, k] * W1[k, j]
// (the W1 product the TPU kernel computes in its body) over a mask that is,
// in each row i, one interval of the ascending grid x, so a row's masked
// sum is the interval rule of interval.cuh: two binary searches on x and
// one subtraction of the row's inclusive prefix sums.
//
// Outer grid rows: the sweep sums over the rows i of each day, and that sum
// is linear, so the table and the sweep take a range of them, [row0, row0 +
// rows) of the n outer grid points (grid sharding: each rank holds its
// range, and the ranks' partial sums add up to the whole day). The inner
// axis j, where the interval rule searches, is always the whole grid x. At
// row0 = 0, rows = n both kernels do what they do for one card, bit for bit.
//
// sweep_table: one block per (day, up to 32 rows; fewer where 32 rows of
// the grid's width would pass the block's shared memory, 28 at n = 1024)
// forms those rows of U
// (`form_rows`) in shared memory at the odd pitch n | 1, one thread per row
// turns its row into its inclusive prefix sum (interval::scan_row, two
// passes: a flagged row keeps its cells for the cell-by-cell sum) and the
// block writes the rows, pad cell zeroed, and the flags to device memory.
// P is T*n*(n|1) f64: 40.4 MB at T = 500, n = 100, inside the H100's 50 MB
// L2. Bound by its ~80 MB of HBM traffic (V in, P out), not by the scan.
//
// masked_sweep: one warp per task (bound row l, day t), four warps per
// block, tasks day-major (t * L + l) so a block's warps read one day's rows.
// Lanes stride over the rows i (up to six chunks of 32, unrolled so the
// lookups overlap; past 192 rows a second instantiation takes 32 chunks,
// up to interval::kMaxRow = 1024 rows); each forms the row's two dynamic
// bounds, reads
// two cells of P (or, for a flagged row, its cells over [lo, hi)) and the
// warp sums the rows in a fixed order. So a result's bits depend on (l, t)
// alone, not on L or the other rows of its batch, and no atomics or block
// barriers sit in the sweep. The work is n row lookups per task (two IEEE
// divisions, two 8-step searches in shared memory, two L2 reads): at
// L = 128 and the flagship size 6.4 M lookups, bound by the divisions and
// the lookups' latency; at L = 1, 500 tasks of one warp each, by the launch.
//
// bisect_levels: U of one day (odd pitch n | 1 in shared memory, so one
// thread per row scans without bank conflicts) is formed per launch and
// turned in place into its prefix rows. Warps then take bound rows l (l =
// warp, warp + warps, ...) and run all n_iters halvings of their row on
// their own: lanes stride over i, a fixed-order shuffle reduction gives
// every lane the slab's same bits, and no block barrier sits inside the
// halving loop. Bound by the lookups' latency and the divisions, not by HBM
// (42 MB per launch at the flagship). It does not read P yet.
//
// solve_stages: K2's task layout (one warp per (l, t), four a block, day-
// major) and K2's slab_sum, so each of its two slabs has K2's bits: the
// stage-1 slab [-100, first_guess], then the stage-2 slab between the
// bounds it picks, then the bracket's selects in registers, in
// ops/solvers.py::bracket_state_batched's order (interval.cuh's `bracket`,
// which the dim-3 stages of contract3.cu share). Lane 0 stores the state
// (lower, upper, prev_res, prev_up, ustack, the NaN-day flag) and folds
// max(upper - lower, 0) into one word by atomicMax on its bits (a non-
// negative double's bits order as the integers do), after a cached read
// that skips the atomic when the word already holds as much. Twice K2's
// lookups per task; at L = 1 it is bound by its launch, at L = 128 by the
// lookups' latency, like K2. K1's f64 launcher `cvt_bisect_levels_widest`
// then derives its count in every block from that word and the tolerance
// (interval::device_halvings), halving as the host's `halvings` does, so
// the count, and every root, is the host-counted route's, bit for bit,
// with no host read between the operands' upload and the roots' copy.
//
// Semantics kept from the f64 `xla` engine (copula_var_tpu/backtest.py):
//   * mask x_j > max((b_lo - x_i w_out) / w_in, box_min) and
//     x_j <= (b_up - x_i w_out) / w_in; the two dynamic bounds are formed
//     with __dmul_rn / __dsub_rn / __ddiv_rn so no FMA contraction moves a
//     bound by an ulp: the interval rule reads the CPU's mask off the
//     ordered grid bit for bit;
//   * only masked-in cells contribute, so a NaN cell poisons exactly the
//     slabs that include it (the fused Pallas path NaNs the whole day): its
//     row is flagged and summed cell by cell;
//   * incremental bookkeeping res = prev +/- slab with the exact test
//     b_lo == prev_up;
//   * the iteration count is the host's count of halvings of the widest
//     bracket (or the same count taken on the device, after
//     solve_stages), i.e. the global count the while-loop engine runs. The
//     while-loop's per-level all-zeros early break (which only fires when
//     every day's CDF is exactly 0) needs a grid-wide reduction and is
//     omitted, as in K1; the plain twin keeps it.
//
// In float (the f32 engine) the cells, grid, bounds, weights and the
// bisection state are float, formed with the Rn<float> intrinsics, as the
// JAX f32 engine forms them in f32 (its mask `(b - x_i w_out) / w_in` in
// that order); every prefix, row sum and warp sum is a double, rounded to
// float where it is stored (interval.cuh): a slab total in float, as
// JAX's. K1 in float runs the caller's fixed count of halvings (the JAX
// engine's `_full_iters`), so the f32 solve reads no bracket on the host.
// Its day takes half the shared memory: n <= 192, the short rows.
//
// Launchers: plain C, no allocation, no synchronisation, launched on the
// caller's stream; each returns cudaGetLastError() (or
// cudaErrorInvalidValue for shapes the kernels do not take).

#include <climits>
#include <cuda_runtime.h>

#include "interval.cuh"

namespace {

constexpr int kTableRows = 32;  // sweep_table: rows of U per block, at most
constexpr int kTableThreads = 128;
constexpr int kSweepThreads = 128;  // masked_sweep: one (l, t) task per warp
constexpr int kSweepWarps = kSweepThreads / 32;
constexpr int kBisectThreads = 512;  // bisect_levels: 16 warps take rows
constexpr int kBisectWarps = kBisectThreads / 32;
constexpr size_t kMaxSharedBytes = CVT_MAX_SHARED_BYTES;  // opt-in per block

// sweep_table: rows of U per block, kTableRows or as many as the block's
// shared memory holds at the row pitch of n
template <typename Real>
__host__ __device__ int table_block_rows(int n) {
  const size_t row = static_cast<size_t>(interval::row_pitch(n)) *
                     sizeof(Real);
  const size_t fit = kMaxSharedBytes / row;
  return fit < static_cast<size_t>(kTableRows) ? static_cast<int>(fit)
                                               : kTableRows;
}

template <typename Real>
__host__ __device__ size_t table_shared_bytes(int n) {
  return static_cast<size_t>(table_block_rows<Real>(n)) *
         interval::row_pitch(n) * sizeof(Real);
}

// bisect_levels: U (n, n | 1) prefix rows, x (n,), one flag byte per row
template <typename Real>
__host__ __device__ size_t bisect_shared_bytes(int n) {
  return (static_cast<size_t>(n) * (n | 1) + n) * sizeof(Real) + n;
}

// U[r, j] = V[r, j] * sum_k wfc[r, k] * W1[k, j] for `rows` rows (v and wfc
// point at the first), written `pitch` apart into u.
template <typename Real>
__device__ void form_rows(const Real* __restrict__ v,
                          const Real* __restrict__ wfc,
                          const Real* __restrict__ w1, Real* u, int rows,
                          int n, int q, int pitch) {
  const int cells = rows * n;
  for (int idx = threadIdx.x; idx < cells; idx += blockDim.x) {
    const int i = idx / n;
    const int j = idx - i * n;
    Real g = 0.0;
    for (int k = 0; k < q; ++k) g += wfc[i * q + k] * w1[k * n + j];
    u[i * pitch + j] = v[idx] * g;
  }
}

// U and the grid of this block's day into shared memory.
template <typename Real>
__device__ void load_day(const Real* __restrict__ v,
                         const Real* __restrict__ wfc,
                         const Real* __restrict__ w1,
                         const Real* __restrict__ x, Real* u, Real* xs,
                         int n, int q, int pitch) {
  form_rows(v, wfc, w1, u, n, n, q, pitch);
  for (int j = threadIdx.x; j < n; j += blockDim.x) xs[j] = x[j];
  __syncthreads();
}

template <typename Real>
__global__ void __launch_bounds__(kTableThreads)
sweep_table_kernel(const Real* __restrict__ v,    // (T, rows, n)
                   const Real* __restrict__ wfc,  // (T, rows, q)
                   const Real* __restrict__ w1,   // (q, n)
                   Real* __restrict__ p,          // (T, rows, pitch)
                   unsigned char* __restrict__ flag,  // (T, rows)
                   int n, int rows, int q, int pitch, int block_rows) {
  extern __shared__ __align__(16) unsigned char table_shared[];
  Real* u = reinterpret_cast<Real*>(table_shared);  // (block_rows, pitch)
  const int r0 = blockIdx.y * block_rows;
  const int nr = min(block_rows, rows - r0);
  const size_t first = static_cast<size_t>(blockIdx.x) * rows + r0;  // (t, r0)
  form_rows(v + first * n, wfc + first * q, w1, u, nr, n, q, pitch);
  __syncthreads();
  if (threadIdx.x < nr)
    flag[first + threadIdx.x] =
        interval::scan_row(u + static_cast<size_t>(threadIdx.x) * pitch, n);
  __syncthreads();
  Real* out = p + first * pitch;
  const int cells = nr * pitch;
  for (int idx = threadIdx.x; idx < cells; idx += blockDim.x)
    out[idx] = idx % pitch < n ? u[idx] : Real(0);  // pad cells: defined, unread
}

// The masked sum of one task's slab (b_lo, b_up] under weights (w_in,
// w_out) over `rows` outer grid rows of one day of P, starting at grid
// point row0: each lane sums its rows (i = lane, lane + 32, ...), the warp
// sums the lanes in a fixed order, and every lane returns the same bits.
// kChunks groups of 32 rows at most (interval.cuh: rows of up to
// kShortRow or kMaxRow cells), searches from kTop.
template <typename Real, int kChunks, int kTop>
__device__ __forceinline__ double slab_sum(
    const Real* __restrict__ day, const unsigned char* __restrict__ fl,
    const Real* xs, int n, int row0, int rows, int pitch, int lane,
    Real b_lo, Real b_up, Real w_in, Real w_out, Real box_min) {
  using R = Rn<Real>;
  double acc = 0.0;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int i = c * 32 + lane;  // the range's row i, grid point row0 + i
    if (c * 32 < rows && i < rows) {
      const Real pv = R::mul(xs[row0 + i], w_out);
      const Real dup = R::div(R::sub(b_up, pv), w_in);
      const Real d = R::div(R::sub(b_lo, pv), w_in);
      // NaN-propagating max, as jnp.maximum / torch.maximum
      const Real dlo = (d > box_min || d != d) ? d : box_min;
      const Real* row = day + static_cast<size_t>(i) * pitch;
      acc += interval::row_sum<kTop>(row, row, fl[i] != 0, xs, n, dlo, dup);
    }
  }
  return interval::warp_sum(acc);
}

template <typename Real, int kChunks, int kTop>
__global__ void __launch_bounds__(kSweepThreads)
prefix_sweep_kernel(const Real* __restrict__ p,  // (T, rows, pitch)
                    const unsigned char* __restrict__ flag,  // (T, rows)
                    const Real* __restrict__ x,        // (n,)
                    const Real* __restrict__ bounds,   // (L, T, 2)
                    const Real* __restrict__ weights,  // (L, 2)
                    Real box_min, Real* __restrict__ out,  // (L, T)
                    int T, int n, int row0, int rows, int L, int pitch) {
  __shared__ Real xs[kChunks * 32];
  for (int j = threadIdx.x; j < n; j += blockDim.x) xs[j] = x[j];
  __syncthreads();
  const int task = blockIdx.x * kSweepWarps + (threadIdx.x >> 5);
  if (task >= L * T) return;  // whole warps: warp_sum's lanes all present
  const int lane = threadIdx.x & 31;
  const int t = task / L;
  const int l = task - t * L;
  const size_t o = static_cast<size_t>(l) * T + t;
  const double acc = slab_sum<Real, kChunks, kTop>(
      p + static_cast<size_t>(t) * rows * pitch,
      flag + static_cast<size_t>(t) * rows, xs, n, row0, rows, pitch, lane,
      bounds[2 * o], bounds[2 * o + 1], weights[2 * l], weights[2 * l + 1],
      box_min);
  if (lane == 0) out[o] = static_cast<Real>(acc);
}

// solve_stages (f64): per task (row l, day t), one warp, tasks day-major
// as in prefix_sweep_kernel, the stage-1 sweep over [-100, first_guess],
// the bracket's stage-2 bounds from it, their sweep, and the bracket
// state, with the selects of ops/solvers.py::bracket_state_batched in its
// order; the widest bracket folded into *widest (zeroed by the launcher).
__global__ void __launch_bounds__(kSweepThreads)
solve_stages_kernel(const double* __restrict__ p,  // (T, n, pitch)
                    const unsigned char* __restrict__ flag,  // (T, n)
                    const double* __restrict__ x,        // (n,)
                    const double* __restrict__ obj,      // (L,)
                    const double* __restrict__ weights,  // (L, 2)
                    interval::StageConfig cfg, double box_min,
                    double* __restrict__ lower,      // (L, T)
                    double* __restrict__ upper,      // (L, T)
                    double* __restrict__ prev_res,   // (L, T)
                    double* __restrict__ prev_up,    // (L, T)
                    unsigned char* __restrict__ ustack,   // (L, T)
                    unsigned char* __restrict__ nan_day,  // (L, T)
                    unsigned long long* widest,  // atomics: no restrict
                    int T, int n, int L, int pitch) {
  constexpr int kChunks = interval::kShortChunks;
  constexpr int kTop = interval::kShortTop;
  __shared__ double xs[kChunks * 32];
  for (int j = threadIdx.x; j < n; j += blockDim.x) xs[j] = x[j];
  __syncthreads();
  const int task = blockIdx.x * kSweepWarps + (threadIdx.x >> 5);
  if (task >= L * T) return;  // whole warps: warp_sum's lanes all present
  const int lane = threadIdx.x & 31;
  const int t = task / L;
  const int l = task - t * L;
  const size_t o = static_cast<size_t>(l) * T + t;
  const double* day = p + static_cast<size_t>(t) * n * pitch;
  const unsigned char* fl = flag + static_cast<size_t>(t) * n;
  const double target = obj[l];
  const double w_in = weights[2 * l], w_out = weights[2 * l + 1];
  // a slab's bits depend on (bounds, weights row, t) alone: F1 is the
  // stage-1 sweep's (L, T) entry whether one row or every row computes it
  const double F1 = slab_sum<double, kChunks, kTop>(
      day, fl, xs, n, 0, n, pitch, lane, -100.0, cfg.fg, w_in, w_out,
      box_min);
  const interval::Slab2 s2 = interval::stage2_bounds(F1, target, cfg);
  const double I2 = slab_sum<double, kChunks, kTop>(
      day, fl, xs, n, 0, n, pitch, lane, s2.lower, s2.upper, w_in, w_out,
      box_min);
  const interval::Bracket b =
      interval::bracket(F1, I2, target, s2.lower, s2.upper, cfg);
  if (lane == 0) {
    lower[o] = b.lo;
    upper[o] = b.hi;
    prev_res[o] = b.res;
    prev_up[o] = b.prev_up;
    ustack[o] = b.ustack;
    nan_day[o] = b.nan;
    interval::fold_width(widest, b.lo, b.hi);
  }
}

template <typename Real>
__global__ void __launch_bounds__(kBisectThreads)
bisect_levels_kernel(const Real* __restrict__ v,
                     const Real* __restrict__ wfc,
                     const Real* __restrict__ w1,
                     const Real* __restrict__ x,
                     const Real* __restrict__ lower,      // (L, T)
                     const Real* __restrict__ upper,      // (L, T)
                     const Real* __restrict__ prev_res,   // (L, T)
                     const Real* __restrict__ prev_up,    // (L, T)
                     const unsigned char* __restrict__ ustack,  // (L, T)
                     const Real* __restrict__ obj,        // (L,)
                     const Real* __restrict__ weights,    // (L, 2)
                     Real box_min, int n_iters,
                     const unsigned long long* __restrict__ widest,
                     double tolerance,
                     Real* __restrict__ roots,            // (L, T)
                     int T, int n, int q, int L) {
  using R = Rn<Real>;
  extern __shared__ __align__(16) unsigned char bisect_shared[];
  // the count on the device (f64 solve_stages route): from the widest
  // bracket solve_stages folded, instead of the host's n_iters
  if (widest != nullptr)
    n_iters = interval::device_halvings(*widest, tolerance);
  const int t = blockIdx.x;
  const int pitch = n | 1;
  Real* u = reinterpret_cast<Real*>(bisect_shared);  // (n, pitch)
  Real* xs = u + static_cast<size_t>(n) * pitch;     // (n,)
  unsigned char* flag = reinterpret_cast<unsigned char*>(xs + n);  // (n,)
  load_day(v + static_cast<size_t>(t) * n * n,
           wfc + static_cast<size_t>(t) * n * q, w1, x, u, xs, n, q, pitch);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    flag[i] = interval::scan_row(u + static_cast<size_t>(i) * pitch, n);
  __syncthreads();
  for (int l = warp; l < L; l += kBisectWarps) {
    const size_t o = static_cast<size_t>(l) * T + t;
    // every lane carries the same scalar state; the slab total it
    // receives has the same bits, so the copies never diverge
    Real lo = lower[o], up = upper[o], pr = prev_res[o], pu = prev_up[o];
    bool us = ustack[o] != 0;
    const Real target = obj[l];
    const Real w_in = weights[2 * l], w_out = weights[2 * l + 1];
    for (int it = 0; it < n_iters; ++it) {
      const Real mid = (lo + up) / Real(2);
      const Real b_lo = us ? lo : mid;
      const Real b_up = us ? mid : up;
      double acc = 0.0;
      // i = lane, lane + 32, ...: unrolled, so the lookups overlap
#pragma unroll
      for (int c = 0; c < interval::kShortChunks; ++c) {
        const int i = c * 32 + lane;
        if (c * 32 < n && i < n) {
          const Real p = R::mul(xs[i], w_out);
          const Real dup = R::div(R::sub(b_up, p), w_in);
          const Real d = R::div(R::sub(b_lo, p), w_in);
          // NaN-propagating max, as jnp.maximum / torch.maximum
          const Real dlo = (d > box_min || d != d) ? d : box_min;
          const Real* row = u + static_cast<size_t>(i) * pitch;
          acc += interval::row_sum<interval::kShortTop>(
              row, row, flag[i] != 0, xs, n, dlo, dup);
        }
      }
      const Real sl = static_cast<Real>(interval::warp_sum(acc));
      const Real res = (b_lo == pu) ? pr + sl : pr - sl;
      const bool below = res < target;
      if (below) lo = mid; else up = mid;
      pr = res;
      pu = mid;
      us = below;
    }
    if (lane == 0) roots[o] = (lo + up) / Real(2);
  }
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t bytes, int T, int n, int q, int L) {
  if (n <= 0 || q <= 0 || T < 0 || L < 0) return cudaErrorInvalidValue;
  if (bytes > kMaxSharedBytes) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// v, wfc, p and flag hold `rows` outer grid rows of every day
template <typename Real>
int sweep_table(const Real* v, const Real* wfc, const Real* w1, Real* p,
                unsigned char* flag, int T, int n, int rows, int q, int pitch,
                void* stream) {
  if (n > interval::kMaxRow || pitch != interval::row_pitch(n) ||
      rows <= 0 || rows > n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int block_rows = table_block_rows<Real>(n);
  const size_t bytes = table_shared_bytes<Real>(n);
  cudaError_t e = prepare(sweep_table_kernel<Real>, bytes, T, n, q, 1);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (T == 0) return 0;
  const dim3 grid(T, (rows + block_rows - 1) / block_rows);
  sweep_table_kernel<Real><<<grid, kTableThreads, bytes,
                             static_cast<cudaStream_t>(stream)>>>(
      v, wfc, w1, p, flag, n, rows, q, pitch, block_rows);
  return static_cast<int>(cudaGetLastError());
}

// p and flag hold the outer grid rows [row0, row0 + rows) of every day;
// out gets their partial sums
template <typename Real>
int masked_sweep(const Real* p, const unsigned char* flag, const Real* x,
                 const Real* bounds, const Real* weights, double box_min,
                 Real* out, int T, int n, int row0, int rows, int L,
                 int pitch, void* stream) {
  if (n <= 0 || n > interval::kMaxRow || T < 0 || L < 0 ||
      row0 < 0 || rows <= 0 || row0 + rows > n ||
      pitch != interval::row_pitch(n) ||
      static_cast<long long>(L) * T > INT_MAX - kSweepWarps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (T == 0 || L == 0) return 0;
  const int grid = (L * T + kSweepWarps - 1) / kSweepWarps;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Real bm = static_cast<Real>(box_min);
  // rows of up to 192 cells: the short form (six unrolled chunks, eight
  // search steps); longer rows: the long form (same sums and counts)
  if (n <= interval::kShortRow) {
    prefix_sweep_kernel<Real, interval::kShortChunks, interval::kShortTop>
        <<<grid, kSweepThreads, 0, s>>>(p, flag, x, bounds, weights, bm, out,
                                        T, n, row0, rows, L, pitch);
  } else {
    prefix_sweep_kernel<Real, interval::kMaxChunks, interval::kMaxTop>
        <<<grid, kSweepThreads, 0, s>>>(p, flag, x, bounds, weights, bm, out,
                                        T, n, row0, rows, L, pitch);
  }
  return static_cast<int>(cudaGetLastError());
}

// n_iters halvings, or (widest not null, f64) the count device_halvings
// takes from the widest bracket's bits and `tolerance`
template <typename Real>
int bisect_levels(const Real* v, const Real* wfc, const Real* w1,
                  const Real* x, const Real* lower, const Real* upper,
                  const Real* prev_res, const Real* prev_up,
                  const unsigned char* ustack, const Real* obj,
                  const Real* weights, double box_min, int n_iters,
                  const unsigned long long* widest, double tolerance,
                  Real* roots, int T, int n, int q, int L, void* stream) {
  if (n > interval::kShortRow || n_iters < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t bytes = bisect_shared_bytes<Real>(n);
  cudaError_t e = prepare(bisect_levels_kernel<Real>, bytes, T, n, q, L);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (T == 0 || L == 0) return 0;
  bisect_levels_kernel<Real><<<T, kBisectThreads, bytes,
                               static_cast<cudaStream_t>(stream)>>>(
      v, wfc, w1, x, lower, upper, prev_res, prev_up, ustack, obj, weights,
      static_cast<Real>(box_min), n_iters, widest, tolerance, roots, T, n, q,
      L);
  return static_cast<int>(cudaGetLastError());
}

// solve_stages: the state (L, T) of every row and day and *widest, zeroed
// here on the stream before the kernel folds into it; whole days of a
// grid K1 takes (n <= kShortRow)
int solve_stages(const double* p, const unsigned char* flag, const double* x,
                 const double* obj, const double* weights,
                 interval::StageConfig cfg,
                 double box_min, double* lower, double* upper,
                 double* prev_res, double* prev_up, unsigned char* ustack,
                 unsigned char* nan_day, unsigned long long* widest, int T,
                 int n, int L, int pitch, void* stream) {
  if (n <= 0 || n > interval::kShortRow || T < 0 || L < 0 ||
      pitch != interval::row_pitch(n) ||
      static_cast<long long>(L) * T > INT_MAX - kSweepWarps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (T == 0 || L == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(widest, 0, sizeof(*widest), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid = (L * T + kSweepWarps - 1) / kSweepWarps;
  solve_stages_kernel<<<grid, kSweepThreads, 0, s>>>(
      p, flag, x, obj, weights, cfg, box_min, lower, upper, prev_res,
      prev_up, ustack, nan_day, widest, T, n, L, pitch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* cvt_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// The f64 launchers and their f32 twins (same arguments, float tensors).
#define CVT_DIM2_LAUNCHERS(SUFFIX, Real)                                      \
  extern "C" int cvt_sweep_table##SUFFIX(                                     \
      const Real* v, const Real* wfc, const Real* w1, Real* p,                \
      unsigned char* flag, int T, int n, int rows, int q, int pitch,          \
      void* stream) {                                                         \
    return sweep_table<Real>(v, wfc, w1, p, flag, T, n, rows, q, pitch,       \
                             stream);                                         \
  }                                                                           \
  extern "C" int cvt_masked_sweep##SUFFIX(                                    \
      const Real* p, const unsigned char* flag, const Real* x,                \
      const Real* bounds, const Real* weights, double box_min, Real* out,     \
      int T, int n, int row0, int rows, int L, int pitch, void* stream) {     \
    return masked_sweep<Real>(p, flag, x, bounds, weights, box_min, out, T,   \
                              n, row0, rows, L, pitch, stream);               \
  }                                                                           \
  extern "C" int cvt_bisect_levels##SUFFIX(                                   \
      const Real* v, const Real* wfc, const Real* w1, const Real* x,          \
      const Real* lower, const Real* upper, const Real* prev_res,             \
      const Real* prev_up, const unsigned char* ustack, const Real* obj,      \
      const Real* weights, double box_min, int n_iters, Real* roots, int T,   \
      int n, int q, int L, void* stream) {                                    \
    return bisect_levels<Real>(v, wfc, w1, x, lower, upper, prev_res,         \
                               prev_up, ustack, obj, weights, box_min,        \
                               n_iters, nullptr, 0.0, roots, T, n, q, L,      \
                               stream);                                       \
  }

CVT_DIM2_LAUNCHERS(, double)
CVT_DIM2_LAUNCHERS(_f32, float)

// The f64 solve_stages route (no f32 form): the fused stages, and K1
// counting its halvings from the widest bracket on the device.
extern "C" int cvt_solve_stages(
    const double* p, const unsigned char* flag, const double* x,
    const double* obj, const double* weights, double first_guess, double sg0,
    double sg1, double min_var, double max_var, int quirks, double box_min,
    double* lower, double* upper, double* prev_res, double* prev_up,
    unsigned char* ustack, unsigned char* nan_day, unsigned long long* widest,
    int T, int n, int L, int pitch, void* stream) {
  const interval::StageConfig cfg{first_guess, sg0, sg1,
                                  min_var, max_var, quirks != 0};
  return solve_stages(p, flag, x, obj, weights, cfg, box_min, lower, upper,
                      prev_res, prev_up, ustack, nan_day, widest, T, n, L,
                      pitch, stream);
}

extern "C" int cvt_bisect_levels_widest(
    const double* v, const double* wfc, const double* w1, const double* x,
    const double* lower, const double* upper, const double* prev_res,
    const double* prev_up, const unsigned char* ustack, const double* obj,
    const double* weights, double box_min,
    const unsigned long long* widest, double tolerance, double* roots,
    int T, int n, int q, int L, void* stream) {
  if (widest == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return bisect_levels<double>(v, wfc, w1, x, lower, upper, prev_res,
                               prev_up, ustack, obj, weights, box_min, 0,
                               widest, tolerance, roots, T, n, q, L, stream);
}
