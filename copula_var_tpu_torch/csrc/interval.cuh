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
// barrier.

#pragma once

#include <cuda_runtime.h>

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
template <int kTop>
__device__ __forceinline__ void counts_le(const double* xs, int n,
                                          double dlo, double dup, int* lo,
                                          int* hi) {
  int a = 0, b = 0;
#pragma unroll
  for (int step = kTop; step > 0; step >>= 1) {
    if (a + step <= n && xs[a + step - 1] <= dlo) a += step;
    if (b + step <= n && xs[b + step - 1] <= dup) b += step;
  }
  *lo = a;
  *hi = b;
}

// Masked sum of one row: from its prefix sums `row` when it is not
// flagged, else from its cells `cells`, one by one (searches of
// counts_le<kTop>).
template <int kTop>
__device__ __forceinline__ double row_sum(const double* row,
                                          const double* cells, bool flagged,
                                          const double* xs, int n,
                                          double dlo, double dup) {
  if (dlo != dlo || dup != dup) return 0.0;
  int lo, hi;
  counts_le<kTop>(xs, n, dlo, dup, &lo, &hi);
  if (hi <= lo) return 0.0;
  if (!flagged) return lo > 0 ? row[hi - 1] - row[lo - 1] : row[hi - 1];
  double s = 0.0;
  for (int j = lo; j < hi; ++j) s += cells[j];
  return s;
}

// One thread turns row[0, n) into its inclusive prefix sum in place, in
// index order, unless the row holds a cell outside [-kMaxCell, kMaxCell]
// (NaN included): then the row is left as it was, to be summed cell by
// cell, and the thread returns true. The first pass only checks the
// cells; the second sums them.
__device__ __forceinline__ bool scan_row(double* row, int n) {
  bool ok = true;
#pragma unroll 4
  for (int j = 0; j < n; ++j) ok &= fabs(row[j]) <= kMaxCell;
  if (!ok) return true;
  double s = 0.0;
#pragma unroll 4
  for (int j = 0; j < n; ++j) {
    s += row[j];
    row[j] = s;
  }
  return false;
}

// One pass of one thread: row[0, n) becomes its inclusive prefix sum in
// place, in index order; returns true when the row holds a cell outside
// [-kMaxCell, kMaxCell] (NaN included). A flagged row's sums are of no
// use then, so its cells must be kept elsewhere (K4: the table).
__device__ __forceinline__ bool scan_row_once(double* row, int n) {
  bool ok = true;
  double s = 0.0;
#pragma unroll 4
  for (int j = 0; j < n; ++j) {
    const double c = row[j];
    ok &= fabs(c) <= kMaxCell;
    s += c;
    row[j] = s;
  }
  return !ok;
}

// Sum of v over the warp; every lane returns the same bits (each xor step
// adds the same pair on both partner lanes, and addition commutes).
__device__ __forceinline__ double warp_sum(double v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace interval
