// Hand-written Hopper (sm_90a) kernels of the VaR serving path, float64.
//
//   masked_sweep   replaces copula_var_tpu/ops/pallas_quadrature.py
//                  ::_sweep_block_kernel (K2, B days per program) and
//                  ::_day_kernel (K3, one day per program): one masked
//                  state-sandwich sweep, (L, T) slab integrals for L bound
//                  rows. It also serves the stage-1 and stage-2 sweeps that
//                  pallas_solver.py::_full_solve computes as XLA einsums.
//   bisect_levels  replaces copula_var_tpu/ops/pallas_solver.py
//                  ::_solve_kernel (K1): the fixed-count bisection for L
//                  rows (confidence levels or portfolios) of one day.
//
// Both build the resident per-day operand U[i, j] = V[i, j] * sum_k
// wfc[i, k] * W1[k, j] in dynamic shared memory with `load_day` (the W1
// product the TPU kernel computes in its body), one block per day.
//
// masked_sweep: each bound row is one masked pass over U (`slab`), n*n
// compares and adds out of shared memory between two block barriers. One
// day is n*n*8 bytes (80 KB at n = 100) read from HBM once per launch; at
// the flagship T = 500 a launch streams 40 MB, ~12 us at 3.35 TB/s, so the
// sweep is latency- and occupancy-bound (500 blocks of 128 threads, two
// 82 KB blocks per SM). Its redesign is later work.
//
// bisect_levels: each row of U (odd pitch n | 1 in shared memory, so one
// thread per row scans without bank conflicts) is turned in place into its
// inclusive prefix sum over j (interval.cuh), so a row's masked sum is two
// binary searches on x and one subtraction. Warps then take bound rows l (l =
// warp, warp + warps, ...) and run all n_iters halvings of their row on
// their own: lanes stride over i, a fixed-order shuffle reduction gives
// every lane the slab's same bits, and no block barrier sits inside the
// halving loop. Per halving a row costs n row lookups (~2 log2 n shared
// loads and two f64 divisions each) instead of an n*n pass; the kernel is
// bound by those lookups' latency and the divisions, not by HBM (42 MB
// per launch at the flagship).
//
// Semantics kept from the f64 `xla` engine (copula_var_tpu/backtest.py):
//   * mask x_j > max((b_lo - x_i w_out) / w_in, box_min) and
//     x_j <= (b_up - x_i w_out) / w_in; the two dynamic bounds are formed
//     with __dmul_rn / __dsub_rn / __ddiv_rn so no FMA contraction moves a
//     bound by an ulp: the mask equals the CPU's bit for bit (the interval
//     rule reads the same mask off the ordered grid);
//   * only masked-in cells contribute, so a NaN cell poisons exactly the
//     slabs that include it (the fused Pallas path NaNs the whole day);
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

#include <cuda_runtime.h>

#include "interval.cuh"

namespace {

constexpr int kThreads = 128;  // masked_sweep
constexpr int kWarps = kThreads / 32;
constexpr int kBisectThreads = 512;  // bisect_levels: 16 warps take rows
constexpr int kBisectWarps = kBisectThreads / 32;
constexpr size_t kMaxSharedBytes = 232448;  // 227 KB opt-in per block

__host__ __device__ size_t day_shared_bytes(int n) {
  return (static_cast<size_t>(n) * n + 3 * static_cast<size_t>(n) + kWarps) *
         sizeof(double);
}

// bisect_levels: U (n, n | 1) prefix rows, x (n,), one flag byte per row
__host__ __device__ size_t bisect_shared_bytes(int n) {
  return (static_cast<size_t>(n) * (n | 1) + n) * sizeof(double) + n;
}

struct DayShared {
  double* u;    // (n, n) resident masked-sum operand
  double* x;    // (n,) grid
  double* dlo;  // (n,) per-row dynamic lower bound
  double* dup;  // (n,) per-row dynamic upper bound
  double* red;  // (kWarps,) per-warp partial sums
};

__device__ DayShared carve(double* smem, int n) {
  DayShared s;
  s.u = smem;
  s.x = s.u + static_cast<size_t>(n) * n;
  s.dlo = s.x + n;
  s.dup = s.dlo + n;
  s.red = s.dup + n;
  return s;
}

// U[i, j] = V[i, j] * sum_k wfc[i, k] * W1[k, j] (rows `pitch` apart)
// and the grid, for this block's day, into shared memory.
__device__ void load_day(const double* __restrict__ v,
                         const double* __restrict__ wfc,
                         const double* __restrict__ w1,
                         const double* __restrict__ x, double* u, double* xs,
                         int n, int q, int pitch) {
  const int nn = n * n;
  for (int idx = threadIdx.x; idx < nn; idx += blockDim.x) {
    const int i = idx / n;
    const int j = idx - i * n;
    double g = 0.0;
    for (int k = 0; k < q; ++k) g += wfc[i * q + k] * w1[k * n + j];
    u[i * pitch + j] = v[idx] * g;
  }
  for (int j = threadIdx.x; j < n; j += blockDim.x) xs[j] = x[j];
  __syncthreads();
}

// Masked sum of U over the half-space slab [b_lo, b_up]; every thread
// returns the same total. Callers may call it back to back: the next
// call's first barrier orders its writes after this call's reads.
__device__ double slab(const DayShared& s, int n, double b_lo, double b_up,
                       double w_in, double w_out, double box_min) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const double p = __dmul_rn(s.x[i], w_out);
    s.dup[i] = __ddiv_rn(__dsub_rn(b_up, p), w_in);
    const double lo = __ddiv_rn(__dsub_rn(b_lo, p), w_in);
    // NaN-propagating max, as jnp.maximum / torch.maximum
    s.dlo[i] = (lo > box_min || lo != lo) ? lo : box_min;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  double acc = 0.0;
  for (int i = warp; i < n; i += kWarps) {
    const double lo = s.dlo[i];
    const double up = s.dup[i];
    const double* row = s.u + static_cast<size_t>(i) * n;
    for (int j = lane; j < n; j += 32) {
      const double xj = s.x[j];
      if (xj > lo && xj <= up) acc += row[j];
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) s.red[warp] = acc;
  __syncthreads();
  double total = 0.0;
  for (int w = 0; w < kWarps; ++w) total += s.red[w];
  return total;
}

__global__ void __launch_bounds__(kThreads)
masked_sweep_kernel(const double* __restrict__ v,
                    const double* __restrict__ wfc,
                    const double* __restrict__ w1,
                    const double* __restrict__ x,
                    const double* __restrict__ bounds,   // (L, T, 2)
                    const double* __restrict__ weights,  // (L, 2)
                    double box_min, double* __restrict__ out,  // (L, T)
                    int T, int n, int q, int L) {
  extern __shared__ double smem[];
  const int t = blockIdx.x;
  const DayShared s = carve(smem, n);
  load_day(v + static_cast<size_t>(t) * n * n,
           wfc + static_cast<size_t>(t) * n * q, w1, x, s.u, s.x, n, q, n);
  for (int l = 0; l < L; ++l) {
    const size_t o = static_cast<size_t>(l) * T + t;
    const double r = slab(s, n, bounds[2 * o], bounds[2 * o + 1],
                          weights[2 * l], weights[2 * l + 1], box_min);
    if (threadIdx.x == 0) out[o] = r;
  }
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
      for (int c = 0; c < interval::kMaxChunks; ++c) {
        const int i = c * 32 + lane;
        if (c * 32 < n && i < n) {
          const double p = __dmul_rn(xs[i], w_out);
          const double dup = __ddiv_rn(__dsub_rn(b_up, p), w_in);
          const double d = __ddiv_rn(__dsub_rn(b_lo, p), w_in);
          // NaN-propagating max, as jnp.maximum / torch.maximum
          const double dlo = (d > box_min || d != d) ? d : box_min;
          const double* row = u + static_cast<size_t>(i) * pitch;
          acc += interval::row_sum(row, row, flag[i] != 0, xs, n, dlo, dup);
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

// The largest grid both day kernels take (a day's n*n f64 resident in
// one block's shared memory), and no more than the prefix scan's rows.
extern "C" int cvt_max_grid_points() {
  int n = 1;
  while (n + 1 <= interval::kMaxRow &&
         day_shared_bytes(n + 1) <= kMaxSharedBytes &&
         bisect_shared_bytes(n + 1) <= kMaxSharedBytes)
    ++n;
  return n;
}

extern "C" int cvt_masked_sweep(const double* v, const double* wfc,
                                const double* w1, const double* x,
                                const double* bounds, const double* weights,
                                double box_min, double* out, int T, int n,
                                int q, int L, void* stream) {
  const size_t bytes = day_shared_bytes(n);
  cudaError_t e = prepare(masked_sweep_kernel, bytes, T, n, q, L);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (T == 0 || L == 0) return 0;
  masked_sweep_kernel<<<T, kThreads, bytes,
                        static_cast<cudaStream_t>(stream)>>>(
      v, wfc, w1, x, bounds, weights, box_min, out, T, n, q, L);
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
  if (n > interval::kMaxRow || n_iters < 0) {
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
