// Hand-written Hopper (sm_90a) kernels of the two-asset (dim-2) VaR serving
// path, float64.
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
//     bracket, i.e. the global count the while-loop engine runs. The
//     while-loop's per-level all-zeros early break (which only fires when
//     every day's CDF is exactly 0) needs a grid-wide reduction and is
//     omitted, as in K1; the plain twin keeps it.
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
__host__ __device__ int table_block_rows(int n) {
  const size_t row = static_cast<size_t>(interval::row_pitch(n)) *
                     sizeof(double);
  const size_t fit = kMaxSharedBytes / row;
  return fit < static_cast<size_t>(kTableRows) ? static_cast<int>(fit)
                                               : kTableRows;
}

__host__ __device__ size_t table_shared_bytes(int n) {
  return static_cast<size_t>(table_block_rows(n)) * interval::row_pitch(n) *
         sizeof(double);
}

// bisect_levels: U (n, n | 1) prefix rows, x (n,), one flag byte per row
__host__ __device__ size_t bisect_shared_bytes(int n) {
  return (static_cast<size_t>(n) * (n | 1) + n) * sizeof(double) + n;
}

// U[r, j] = V[r, j] * sum_k wfc[r, k] * W1[k, j] for `rows` rows (v and wfc
// point at the first), written `pitch` apart into u.
__device__ void form_rows(const double* __restrict__ v,
                          const double* __restrict__ wfc,
                          const double* __restrict__ w1, double* u, int rows,
                          int n, int q, int pitch) {
  const int cells = rows * n;
  for (int idx = threadIdx.x; idx < cells; idx += blockDim.x) {
    const int i = idx / n;
    const int j = idx - i * n;
    double g = 0.0;
    for (int k = 0; k < q; ++k) g += wfc[i * q + k] * w1[k * n + j];
    u[i * pitch + j] = v[idx] * g;
  }
}

// U and the grid of this block's day into shared memory.
__device__ void load_day(const double* __restrict__ v,
                         const double* __restrict__ wfc,
                         const double* __restrict__ w1,
                         const double* __restrict__ x, double* u, double* xs,
                         int n, int q, int pitch) {
  form_rows(v, wfc, w1, u, n, n, q, pitch);
  for (int j = threadIdx.x; j < n; j += blockDim.x) xs[j] = x[j];
  __syncthreads();
}

__global__ void __launch_bounds__(kTableThreads)
sweep_table_kernel(const double* __restrict__ v,    // (T, rows, n)
                   const double* __restrict__ wfc,  // (T, rows, q)
                   const double* __restrict__ w1,   // (q, n)
                   double* __restrict__ p,          // (T, rows, pitch)
                   unsigned char* __restrict__ flag,  // (T, rows)
                   int n, int rows, int q, int pitch, int block_rows) {
  extern __shared__ double u[];  // (block_rows, pitch)
  const int r0 = blockIdx.y * block_rows;
  const int nr = min(block_rows, rows - r0);
  const size_t first = static_cast<size_t>(blockIdx.x) * rows + r0;  // (t, r0)
  form_rows(v + first * n, wfc + first * q, w1, u, nr, n, q, pitch);
  __syncthreads();
  if (threadIdx.x < nr)
    flag[first + threadIdx.x] =
        interval::scan_row(u + static_cast<size_t>(threadIdx.x) * pitch, n);
  __syncthreads();
  double* out = p + first * pitch;
  const int cells = nr * pitch;
  for (int idx = threadIdx.x; idx < cells; idx += blockDim.x)
    out[idx] = idx % pitch < n ? u[idx] : 0.0;  // pad cells: defined, unread
}

// kChunks groups of 32 rows at most (interval.cuh: rows of up to
// kShortRow or kMaxRow cells), searches from kTop
template <int kChunks, int kTop>
__global__ void __launch_bounds__(kSweepThreads)
prefix_sweep_kernel(const double* __restrict__ p,  // (T, rows, pitch)
                    const unsigned char* __restrict__ flag,  // (T, rows)
                    const double* __restrict__ x,        // (n,)
                    const double* __restrict__ bounds,   // (L, T, 2)
                    const double* __restrict__ weights,  // (L, 2)
                    double box_min, double* __restrict__ out,  // (L, T)
                    int T, int n, int row0, int rows, int L, int pitch) {
  __shared__ double xs[kChunks * 32];
  for (int j = threadIdx.x; j < n; j += blockDim.x) xs[j] = x[j];
  __syncthreads();
  const int task = blockIdx.x * kSweepWarps + (threadIdx.x >> 5);
  if (task >= L * T) return;  // whole warps: warp_sum's lanes all present
  const int lane = threadIdx.x & 31;
  const int t = task / L;
  const int l = task - t * L;
  const size_t o = static_cast<size_t>(l) * T + t;
  const double b_lo = bounds[2 * o], b_up = bounds[2 * o + 1];
  const double w_in = weights[2 * l], w_out = weights[2 * l + 1];
  const double* day = p + static_cast<size_t>(t) * rows * pitch;
  const unsigned char* fl = flag + static_cast<size_t>(t) * rows;
  double acc = 0.0;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int i = c * 32 + lane;  // the range's row i, grid point row0 + i
    if (c * 32 < rows && i < rows) {
      const double pv = __dmul_rn(xs[row0 + i], w_out);
      const double dup = __ddiv_rn(__dsub_rn(b_up, pv), w_in);
      const double d = __ddiv_rn(__dsub_rn(b_lo, pv), w_in);
      // NaN-propagating max, as jnp.maximum / torch.maximum
      const double dlo = (d > box_min || d != d) ? d : box_min;
      const double* row = day + static_cast<size_t>(i) * pitch;
      acc += interval::row_sum<kTop>(row, row, fl[i] != 0, xs, n, dlo, dup);
    }
  }
  acc = interval::warp_sum(acc);
  if (lane == 0) out[o] = acc;
}

__global__ void __launch_bounds__(kBisectThreads)
bisect_levels_kernel(const double* __restrict__ v,
                     const double* __restrict__ wfc,
                     const double* __restrict__ w1,
                     const double* __restrict__ x,
                     const double* __restrict__ lower,      // (L, T)
                     const double* __restrict__ upper,      // (L, T)
                     const double* __restrict__ prev_res,   // (L, T)
                     const double* __restrict__ prev_up,    // (L, T)
                     const unsigned char* __restrict__ ustack,  // (L, T)
                     const double* __restrict__ obj,        // (L,)
                     const double* __restrict__ weights,    // (L, 2)
                     double box_min, int n_iters,
                     double* __restrict__ roots,            // (L, T)
                     int T, int n, int q, int L) {
  extern __shared__ double smem[];
  const int t = blockIdx.x;
  const int pitch = n | 1;
  double* u = smem;                                 // (n, pitch)
  double* xs = u + static_cast<size_t>(n) * pitch;  // (n,)
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
    double lo = lower[o], up = upper[o], pr = prev_res[o], pu = prev_up[o];
    bool us = ustack[o] != 0;
    const double target = obj[l];
    const double w_in = weights[2 * l], w_out = weights[2 * l + 1];
    for (int it = 0; it < n_iters; ++it) {
      const double mid = (lo + up) / 2.0;
      const double b_lo = us ? lo : mid;
      const double b_up = us ? mid : up;
      double acc = 0.0;
      // i = lane, lane + 32, ...: unrolled, so the lookups overlap
#pragma unroll
      for (int c = 0; c < interval::kShortChunks; ++c) {
        const int i = c * 32 + lane;
        if (c * 32 < n && i < n) {
          const double p = __dmul_rn(xs[i], w_out);
          const double dup = __ddiv_rn(__dsub_rn(b_up, p), w_in);
          const double d = __ddiv_rn(__dsub_rn(b_lo, p), w_in);
          // NaN-propagating max, as jnp.maximum / torch.maximum
          const double dlo = (d > box_min || d != d) ? d : box_min;
          const double* row = u + static_cast<size_t>(i) * pitch;
          acc += interval::row_sum<interval::kShortTop>(
              row, row, flag[i] != 0, xs, n, dlo, dup);
        }
      }
      const double sl = interval::warp_sum(acc);
      const double res = (b_lo == pu) ? pr + sl : pr - sl;
      const bool below = res < target;
      if (below) lo = mid; else up = mid;
      pr = res;
      pu = mid;
      us = below;
    }
    if (lane == 0) roots[o] = (lo + up) / 2.0;
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

}  // namespace

extern "C" const char* cvt_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// v, wfc, p and flag hold `rows` outer grid rows of every day
extern "C" int cvt_sweep_table(const double* v, const double* wfc,
                               const double* w1, double* p,
                               unsigned char* flag, int T, int n, int rows,
                               int q, int pitch, void* stream) {
  if (n > interval::kMaxRow || pitch != interval::row_pitch(n) ||
      rows <= 0 || rows > n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int block_rows = table_block_rows(n);
  const size_t bytes = table_shared_bytes(n);
  cudaError_t e = prepare(sweep_table_kernel, bytes, T, n, q, 1);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (T == 0) return 0;
  const dim3 grid(T, (rows + block_rows - 1) / block_rows);
  sweep_table_kernel<<<grid, kTableThreads, bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      v, wfc, w1, p, flag, n, rows, q, pitch, block_rows);
  return static_cast<int>(cudaGetLastError());
}

// p and flag hold the outer grid rows [row0, row0 + rows) of every day;
// out gets their partial sums
extern "C" int cvt_masked_sweep(const double* p, const unsigned char* flag,
                                const double* x, const double* bounds,
                                const double* weights, double box_min,
                                double* out, int T, int n, int row0, int rows,
                                int L, int pitch, void* stream) {
  if (n <= 0 || n > interval::kMaxRow || T < 0 || L < 0 ||
      row0 < 0 || rows <= 0 || row0 + rows > n ||
      pitch != interval::row_pitch(n) ||
      static_cast<long long>(L) * T > INT_MAX - kSweepWarps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (T == 0 || L == 0) return 0;
  const int grid = (L * T + kSweepWarps - 1) / kSweepWarps;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // rows of up to 192 cells: the short form (six unrolled chunks, eight
  // search steps); longer rows: the long form (same sums and counts)
  if (n <= interval::kShortRow) {
    prefix_sweep_kernel<interval::kShortChunks, interval::kShortTop>
        <<<grid, kSweepThreads, 0, s>>>(p, flag, x, bounds, weights, box_min,
                                        out, T, n, row0, rows, L, pitch);
  } else {
    prefix_sweep_kernel<interval::kMaxChunks, interval::kMaxTop>
        <<<grid, kSweepThreads, 0, s>>>(p, flag, x, bounds, weights, box_min,
                                        out, T, n, row0, rows, L, pitch);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cvt_bisect_levels(const double* v, const double* wfc,
                                 const double* w1, const double* x,
                                 const double* lower, const double* upper,
                                 const double* prev_res,
                                 const double* prev_up,
                                 const unsigned char* ustack,
                                 const double* obj, const double* weights,
                                 double box_min, int n_iters, double* roots,
                                 int T, int n, int q, int L, void* stream) {
  if (n > interval::kShortRow || n_iters < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t bytes = bisect_shared_bytes(n);
  cudaError_t e = prepare(bisect_levels_kernel, bytes, T, n, q, L);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (T == 0 || L == 0) return 0;
  bisect_levels_kernel<<<T, kBisectThreads, bytes,
                         static_cast<cudaStream_t>(stream)>>>(
      v, wfc, w1, x, lower, upper, prev_res, prev_up, ustack, obj, weights,
      box_min, n_iters, roots, T, n, q, L);
  return static_cast<int>(cudaGetLastError());
}
