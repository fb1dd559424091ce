// The interval rule shared by the dim-2 sweep and bisection (quadrature.cu)
// and the dim-3 sweep (contract3.cu): the masked sum of one grid row as two
// binary searches on the grid and one subtraction of inclusive prefix
// sums, instead of a pass over every cell of the row.
//
// A row r of U holds cells U[r, j] at grid points x_j, with x strictly
// ascending (copula_var_tpu/ops/grids.py). For the row's dynamic bounds
// (dlo, dup), dlo already clamped at box_min by the NaN-propagating max,
// the masked sum is
//
//   sum_j U[r, j] [x_j > dlo && x_j <= dup] = S[hi - 1] - S[lo - 1]
//
// with hi = #{j : x_j <= dup}, lo = #{j : x_j <= dlo}, S the row's
// inclusive prefix sum over j and S[-1] = 0; it is 0 when hi <= lo, and 0
// when dlo or dup is NaN (the masked form is false for every j).
//
// A cell of U is the probability mass of one grid cell (U sums to ~1 per
// day; on the flagship and dim-3 records no cell exceeds 4e-3), so a cell
// outside [-kMaxCell, kMaxCell] is no mass: NaN, +/-inf, a GARCH cell
// saturated to +/-DBL_MAX by nan_to_num, or an overflowed density. Such a
// cell would poison or absorb every prefix sum after it, so a row holding
// one is flagged when scanned; its masked sum is taken cell by cell over
// [lo, hi) from the row's cells. So a NaN cell still poisons exactly the
// slabs that hold it, inf - inf never arises, and a huge cell does not
// swallow the intervals that lie after it. In a row that is scanned every
// running sum lies within n * kMaxCell, and the result differs from the
// masked sum only by the rounding of the prefix difference (at most ~n
// ulps of the row's largest running sum).
//
// Rows are scanned one thread each (rows of odd pitch `row_pitch` in
// shared memory put 16 consecutive rows on distinct bank pairs); lookups
// are per-thread, and `warp_sum` is warp-synchronous. None uses a block
// barrier. The header ends with the f64 solve's stage-2 bracket and its
// halving count on the device, which both sources' fused solves share.
//
// Cells, grid and bounds are of the kernels' working type Real (real.cuh:
// double or float). Every running sum is a double for both: a prefix is
// accumulated in a double register and rounded to Real once, where it is
// stored, and a row's masked sum is the difference of two stored prefixes
// taken in double. In float a prefix accumulated in float would lose
// about sqrt(n) ulps of the row's total; rounded once it loses half of
// one, and the difference adds no rounding of its own. For double every
// conversion is the identity: the f64 kernels' sums are what they were.

#pragma once

#include <cuda_runtime.h>

#include "real.cuh"

// The kernels' limits have one home, copula_var_tpu_torch/ops/_build.py,
// which passes them to nvcc: the interval rule's two longest rows in
// chunks of 32 cells (CVT_SHORT_CHUNKS, CVT_MAX_CHUNKS) and a block's
// opt-in shared memory (CVT_MAX_SHARED_BYTES).
#if !defined(CVT_SHORT_CHUNKS) || !defined(CVT_MAX_CHUNKS) || \
    !defined(CVT_MAX_SHARED_BYTES)
#error "build through copula_var_tpu_torch/ops/_build.py: it defines the limits"
#endif

namespace interval {

// The largest power of two <= n (n >= 1).
constexpr int top_step(int n) { return n < 2 ? 1 : 2 * top_step(n / 2); }

// Rows of up to kMaxRow cells. A kernel's lookups are compiled for a
// fixed longest row: rows of up to kShortRow cells (K1, the dim-3 table
// sweep and K2 at n <= kShortRow: a warp's lanes cover them in
// kShortChunks unrolled groups of 32, the searches take the steps
// kShortTop, ..., 1) or of up to kMaxRow (K2 past kShortRow and the dim-3
// rebuild: kMaxChunks groups, steps kMaxTop, ..., 1). A step that would
// pass n changes no count (a + step <= n) and a chunk past the row adds
// nothing, so both forms give the same counts and the same sums for every
// n they take.
constexpr int kShortChunks = CVT_SHORT_CHUNKS;
constexpr int kShortRow = 32 * kShortChunks;
constexpr int kShortTop = top_step(kShortRow);
constexpr int kMaxChunks = CVT_MAX_CHUNKS;
constexpr int kMaxRow = 32 * kMaxChunks;
constexpr int kMaxTop = top_step(kMaxRow);
static_assert(kShortChunks > 0 && kShortChunks <= kMaxChunks,
              "the short rows are the shorter");
constexpr double kMaxCell = 1.0;  // the largest magnitude of a scanned cell

// The pitch of a row of n cells: n rounded up to odd.
__host__ __device__ __forceinline__ int row_pitch(int n) { return n | 1; }

// (#{j : x_j <= dlo}, #{j : x_j <= dup}) for x strictly ascending (n <=
// 2 kTop - 1 entries, shared memory): both counts by binary lifting,
// interleaved, in a fixed number of branch-free steps; a NaN bound
// counts 0.
template <int kTop, typename Real>
__device__ __forceinline__ void counts_le(const Real* xs, int n, Real dlo,
                                          Real dup, int* lo, int* hi) {
  int a = 0, b = 0;
#pragma unroll
  for (int step = kTop; step > 0; step >>= 1) {
    if (a + step <= n && xs[a + step - 1] <= dlo) a += step;
    if (b + step <= n && xs[b + step - 1] <= dup) b += step;
  }
  *lo = a;
  *hi = b;
}

// Masked sum of one row, in double: from its prefix sums `row` when it is
// not flagged, else from its cells `cells`, one by one (searches of
// counts_le<kTop>).
template <int kTop, typename Real>
__device__ __forceinline__ double row_sum(const Real* row, const Real* cells,
                                          bool flagged, const Real* xs,
                                          int n, Real dlo, Real dup) {
  if (dlo != dlo || dup != dup) return 0.0;
  int lo, hi;
  counts_le<kTop>(xs, n, dlo, dup, &lo, &hi);
  if (hi <= lo) return 0.0;
  const double top = static_cast<double>(row[hi - 1]);
  if (!flagged) return lo > 0 ? top - static_cast<double>(row[lo - 1]) : top;
  double s = 0.0;
  for (int j = lo; j < hi; ++j) s += static_cast<double>(cells[j]);
  return s;
}

// One thread turns row[0, n) into its inclusive prefix sum in place, in
// index order, unless the row holds a cell outside [-kMaxCell, kMaxCell]
// (NaN included): then the row is left as it was, to be summed cell by
// cell, and the thread returns true (the stored form of K2's P and K4's
// U). The first pass only checks the cells; the second sums them (in
// double, each prefix rounded to Real).
template <typename Real>
__device__ __forceinline__ bool scan_row(Real* row, int n) {
  bool ok = true;
#pragma unroll 4
  for (int j = 0; j < n; ++j) ok &= fabs(row[j]) <= kMaxCell;
  if (!ok) return true;
  double s = 0.0;
#pragma unroll 4
  for (int j = 0; j < n; ++j) {
    s += static_cast<double>(row[j]);
    row[j] = static_cast<Real>(s);
  }
  return false;
}

// A running double sum as its stored prefix reads back: rounded to Real
// (the identity for double).
template <typename Real>
__device__ __forceinline__ double stored(double s) {
  return static_cast<double>(static_cast<Real>(s));
}

// Sum of v over the warp; every lane returns the same bits (each xor step
// adds the same pair on both partner lanes, and addition commutes).
__device__ __forceinline__ double warp_sum(double v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The f64 solve's stage-2 bracket and its halving count, shared by the
// fused stages of dim 2 (quadrature.cu::solve_stages_kernel) and dim 3
// (contract3.cu::solve_stages3_kernel) and by the bisections that take
// their count on the device (K1's `cvt_bisect_levels_widest`, the dim-3
// `bisect3_kernel`).

// cfg = (first_guess, sg0, sg1, min_var, max_var) and the reference's
// add-group anchor (quirks).
struct StageConfig {
  double fg, sg0, sg1, min_v, max_v;
  bool quirks;
};

// The bracket state of one (row, day), ops/solvers.py::
// bracket_state_batched's outputs.
struct Bracket {
  double lo, hi, res, prev_up;
  bool ustack, nan;
};

// The stage-2 slab (new_lower, new_upper] that the stage-1 result F1
// picks against `target`.
struct Slab2 {
  double lower, upper;
};
__device__ __forceinline__ Slab2 stage2_bounds(double F1, double target,
                                               const StageConfig& cfg) {
  return {F1 >= target ? cfg.sg0 : cfg.fg, F1 < target ? cfg.sg1 : cfg.fg};
}

// bracket_state_batched's selects, in its order, from F1, the stage-2
// slab I2 between (new_lower, new_upper) and the row's level.
__device__ __forceinline__ Bracket bracket(double F1, double I2,
                                           double target, double new_lower,
                                           double new_upper,
                                           const StageConfig& cfg) {
  Bracket b;
  b.res = new_lower == cfg.fg ? __dadd_rn(F1, I2) : __dsub_rn(F1, I2);
  b.prev_up = new_lower == cfg.sg0 ? cfg.sg0 : (cfg.quirks ? cfg.fg : cfg.sg1);
  b.lo = cfg.min_v;
  b.hi = cfg.max_v;
  if (b.res > target) {
    b.lo = cfg.min_v;
    b.hi = cfg.sg0;
  }
  if (b.res < target && new_upper == cfg.fg) {
    b.lo = cfg.sg0;
    b.hi = cfg.fg;
  }
  if (b.res < target && new_upper == cfg.sg1) {
    b.lo = cfg.sg1;
    b.hi = cfg.max_v;
  }
  if (b.res > target && new_upper == cfg.sg1) {
    b.lo = cfg.fg;
    b.hi = cfg.sg1;
  }
  b.ustack = !(b.hi == cfg.sg0 || b.hi == cfg.sg1);
  b.nan = b.res != b.res;
  return b;
}

// A width as the bits atomicMax orders: a non-negative double's bits
// order as unsigned integers do; a negative width (or -0) counts as 0 and
// a NaN as all ones, so a NaN wins the maximum as torch's max propagates
// it, and the count it gives is the host's for a NaN: 0.
__device__ __forceinline__ unsigned long long width_bits(double w) {
  if (w != w) return ~0ull;
  return w > 0.0 ? static_cast<unsigned long long>(__double_as_longlong(w))
                 : 0ull;
}

// max(hi - lo, 0) folded into *widest (a word of width_bits), after a
// cached read that skips the atomic when the word already holds as much:
// most (row, day) brackets share one of a few widths.
__device__ __forceinline__ void fold_width(unsigned long long* widest,
                                           double lo, double hi) {
  const unsigned long long bits = width_bits(__dsub_rn(hi, lo));
  if (bits > __ldcg(widest)) atomicMax(widest, bits);
}

// The while-loop's halving count from the widest bracket's bits, as the
// host's `halvings` counts it: halve while the width exceeds `tolerance`
// (every halving exact). A NaN width counts 0; the cap only stops an
// infinite width or a negative tolerance, where the host never stops
// (kMaxHalvings halvings take the largest double below any tolerance
// >= 0).
constexpr int kMaxHalvings = 2200;

__device__ __forceinline__ int device_halvings(unsigned long long bits,
                                               double tolerance) {
  double w = __longlong_as_double(static_cast<long long>(bits));
  int k = 0;
  while (w > tolerance && k < kMaxHalvings) {
    w *= 0.5;
    ++k;
  }
  return k;
}

}  // namespace interval
