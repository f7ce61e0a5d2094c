// The E-step's f-param search for Hopper (sm_90a): one whole L-BFGS search
// on the scalar logA in one launch, in float32 or float64.
//
// Replaces: gaussian_processes_tpu/models/fit.py:331-337, the optax zoom
// L-BFGS (gaussian_processes_tpu/optim/lbfgs.py::lbfgs_minimize, optax's
// scale_by_lbfgs and zoom_linesearch) that JAX runs on _fparam_objective
// inside its compiled E-step, under lax.fori_loop and lax.while_loop.  It is
// not a Pallas kernel: XLA compiles that loop into the E-step's program, so
// the search never leaves the device.  The port's host route
// (optim/lbfgs.py::lbfgs_minimize on models/fit.py::_fparam_objective through
// autograd) stays as this kernel's plain version (ops/fparam_search.py).
//
// Inputs: r, lambda_m, lambda_var (nt,), an optional weight w (nt,) (rows
// with w <= 0 are padding: they enter no sum), and logA0 (one value on the
// device).  Outputs: the best logA, the best value, and the number of
// objective evaluations added to a running 64-bit counter.  One evaluation
// at logA is, with A = exp(logA) and the sums over the rows with w > 0,
//   z      = A lambda_m + (0.5 A) A lambda_var
//   lambda0 = log sum(w r) - logsumexp(z)
//   f      = exp(z + lambda0)
//   value  = -((A sum(w r lambda_m) + lambda0 sum(w r)) - sum(w f))
//   grad   = (sum(w f g) - A sum(w r lambda_m)) + sum(p g) (sum(w r) - sum(w f))
// with g = A lambda_m + A^2 lambda_var = dz/dlogA and p = exp(z - logsumexp(z))
// = softmax(z): the full chain that autograd takes through lambda0_given_logA
// (dlambda0/dlogA = -sum(p g)), not the envelope shortcut, since in float32
// sum(w r) - sum(w f) is rounding noise, not zero.  logsumexp is torch's:
// the max is taken first (NaN wins) and an infinite max shifts by 0, so an
// overflowing exp(z) gives a NaN or +inf value, which the zoom backtracks
// from as the plain route's does.
//
// The state machine is a transcription at d = 1 of the port's _drive_lbfgs
// and _zoom_linesearch (optim/lbfgs.py): optax's memory of 15 pairs in its
// index order, the capped first step, best-iterate tracking, the frozen
// iterate on a non-finite update, the gtol/ftol/ftol_rel gates (0 at the
// f-param site), the zoom's interval search, its cubic/quadratic/bisection
// trial, the safe step and the approximate-Wolfe decrease error, with the
// same constants and the same order of operations; the file is compiled with
// -fmad=false so that no multiply-add is contracted and each scalar rounds as
// the plain route's does.  torch.maximum/minimum/clamp keep NaN, so their
// counterparts here do too.
//
// Layout: one block of THREADS (256) threads, which carry the 1024 threads
// of the reduction tree that the kernel's first version (commit f0bea62)
// ran on as one block of 1024, so that every sum is taken in the same order
// and rounds to the same bits.  Real thread t plays the virtual threads
// v = t + THREADS k, k < VPT (4); virtual thread v sums its rows v,
// v + 1024, v + 2048, ... in that order, into its own accumulator.  Virtual
// warp w + WARPS k (of 32) lies in real warp w, lane for lane, so each
// virtual warp's xor butterfly runs on real lanes: the first log2(VPT)
// levels (offsets 16, 8) halve the accumulators a lane holds (the lane
// sends the half its partner keeps), the rest are the butterfly; every node
// adds the upper lane's value to the lower lane's, as lane 0's butterfly
// did.  The first version then ran warp 0's butterfly over the 32
// virtual-warp sums; its levels that pair virtual warps of one real warp
// (offsets 16 and 8) run inside that warp, lane 0 writes the warp's
// partial, and after the one barrier of a reduction every thread adds the
// 8 partials as the last 3 levels did, in registers.  The partials
// alternate between two buffers.  With -fmad=false, the same
// expf/logf, and the max of pass 1 in one max.NaN (it can differ from the
// first version's only in the sign of a zero max, which no result sees),
// each logA, value and evaluation count is bit for bit that version's
// (tests/test_torch_cuda.py holds it on the card,
// tests/test_torch_fparam_search.py the tree in numpy).
//
// Every thread runs the same scalar state machine on the same values, so
// control flow is uniform and every thread meets every barrier; with 8
// warps in place of 32, each SM sub-partition issues each scalar
// instruction twice, not 8 times.  The L-BFGS memory (15 pairs) lives in
// every thread's registers, in the two-loop recursion's order (oldest
// first) and rotated with static indices, so no barrier guards it.
// __launch_bounds__(THREADS, 1) leaves up to 255 registers a thread: ptxas
// reports 117-125 (float32) and 238-240 (float64), no spill and no stack
// frame (chip_smoke.py prints its lines and fails on a spill).  An
// evaluation is three passes over the rows, each ending in a block
// reduction: the max of z, the sum of exp(z - max), then sum(w f),
// sum(w f g) and sum(p g) in one.  lambda_m, lambda_var (and w) are copied
// once into dynamic shared memory when they fit, padded with zeros to a
// multiple of 1024 rows (3160 float32 rows take 32 KB, 48 KB with a
// weight; float64 twice that; up to 227 KB with the opt-in attribute),
// else read from global memory, where L2 keeps them.  A pass takes each
// full block of 1024 rows without a branch, so the loads and arithmetic of
// a thread's 4 rows interleave, and guards only the last block's rows.
//
// What bounds it: the bytes the search must read (r, lambda_m, lambda_var
// once) take 0.011 us at nt 3160 in float32 at 3.35 TB/s, and the
// arithmetic the function needs (13 operations a row an evaluation, each
// row's work counted once as chip_smoke.py's FPARAM_ROW_FLOPS derives it)
// 0.045 us for phase 4's last search (74 evaluations) at 67 TFLOP/s, but
// neither is the limit: one block runs on one of the 132 SMs, and the
// evaluations are a serial chain.  On an NVIDIA H100 80GB HBM3 at 700 W
// (PERF.md) an evaluation at nt 3160 takes 2.32 us in float32 (4,590 SM
// cycles: the row passes 2,598, issue-bound on the SM's four schedulers,
// the three reductions 1,124 and the search's scalar logic 867, both
// latency chains), against 4.43 us for the block of 1024; at nt 32, one
// row a lane of one warp, 1.36 us (2,738 cycles, of which the reductions
// 1,097 and the scalar logic 869), against 2.78 us.
// The design keeps that chain on one SM with no launch, no host round trip
// and no synchronisation between evaluations.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VTHREADS = 1024;   // the reduction tree's threads
constexpr int VPT = VTHREADS / THREADS;   // virtual threads a thread plays
constexpr int WARPS = THREADS / 32;
constexpr int LOG_VPT = 2;
static_assert((1 << LOG_VPT) == VPT && VPT * THREADS == VTHREADS && WARPS > 1,
              "LOG_VPT is log2(VTHREADS / THREADS), and a block has 2+ warps");
constexpr unsigned FULL = 0xffffffffu;
constexpr int MEM = 15;               // optax's memory_size at the f-param site
// dynamic shared memory for the data: what a block may opt in to (232,448
// bytes) less room for the static shared memory (the partials)
constexpr size_t SMEM_DATA_MAX = 232448 - 4096;
constexpr int ERR_ARGS = -1;
constexpr int PART_SIZE = 2 * 3 * WARPS;   // two buffers of 3 x WARPS partials

// rows in shared memory: nt padded to a multiple of VTHREADS
__host__ __device__ __forceinline__ int padded_rows(int nt) {
  return (nt + VTHREADS - 1) / VTHREADS * VTHREADS;
}
__host__ __device__ __forceinline__ size_t data_bytes(int nt, bool weighted,
                                                      size_t dtype_bytes) {
  return static_cast<size_t>(padded_rows(nt)) * (weighted ? 3 : 2) *
         dtype_bytes;
}

// optax scale_by_zoom_linesearch defaults (optim/lbfgs.py)
constexpr double SLOPE_RTOL = 1e-4;
constexpr double CURV_RTOL = 0.9;
constexpr double APPROX_DEC_RTOL = 1e-6;
constexpr double INCREASE_FACTOR = 2.0;
constexpr double INTERVAL_THRESHOLD = 1e-5;

__device__ __forceinline__ float t_inf(float) { return CUDART_INF_F; }
__device__ __forceinline__ double t_inf(double) { return CUDART_INF; }
__device__ __forceinline__ float t_nan(float) { return CUDART_NAN_F; }
__device__ __forceinline__ double t_nan(double) { return CUDART_NAN; }
__device__ __forceinline__ float t_exp(float x) { return expf(x); }
__device__ __forceinline__ double t_exp(double x) { return exp(x); }
__device__ __forceinline__ float t_log(float x) { return logf(x); }
__device__ __forceinline__ double t_log(double x) { return log(x); }
__device__ __forceinline__ float t_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double t_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float t_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double t_abs(double x) { return fabs(x); }

template <typename T>
__device__ __forceinline__ bool is_nan(T x) { return x != x; }
template <typename T>
__device__ __forceinline__ bool is_finite(T x) {
  return t_abs(x) < t_inf(x);    // false for inf and NaN
}
template <typename T>
__device__ __forceinline__ bool is_inf(T x) { return t_abs(x) == t_inf(x); }
// torch.maximum / torch.minimum: a NaN operand gives NaN
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (is_nan(a) || is_nan(b)) ? t_nan(a) : (a > b ? a : b);
}
template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) {
  return (is_nan(a) || is_nan(b)) ? t_nan(a) : (a < b ? a : b);
}
// torch.clamp(x, min=0): NaN stays NaN
template <typename T>
__device__ __forceinline__ T clamp_min0(T x) { return x < T(0) ? T(0) : x; }

// The max of z over the rows and its reduction: nan_max, in float32 one
// instruction (max.NaN gives the canonical NaN for a NaN operand, as
// nan_max does; of +0 and -0 it may keep the other, and the sign of a zero
// max changes neither z - shift nor log(s) + shift).
template <typename T>
__device__ __forceinline__ T row_max(T a, T b) { return nan_max(a, b); }
template <>
__device__ __forceinline__ float row_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

template <bool MAX, typename T>
__device__ __forceinline__ T combine(T a, T b) {
  return MAX ? row_max(a, b) : a + b;
}

// N values reduced over the 1024 virtual threads (sums, or NaN-propagating
// maxima) in the order of the 1024-thread block's; v[k][n] is virtual thread
// threadIdx.x + THREADS k's partial.  Every thread returns with the
// results.  `part` holds 3 x WARPS partials; the caller alternates two
// buffers, so the one barrier here also tells the next call's writers that
// every thread has read the buffer before.
template <bool MAX, typename T, int N>
__device__ __forceinline__ void block_reduce(T (&v)[VPT][N], T (&res)[N],
                                             T* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // each virtual warp's butterfly: the levels at offsets 16, 8, ... halve
  // the accumulators a lane holds; the lower lane's value comes first
#pragma unroll
  for (int s = 0; s < LOG_VPT; ++s) {
    const int off = 16 >> s;
    const int half = VPT >> (s + 1);
    const bool upper = (lane & off) != 0;
#pragma unroll
    for (int j = 0; j < half; ++j) {
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const T lo = v[j][n], hi = v[j + half][n];
        const T o = __shfl_xor_sync(FULL, upper ? lo : hi, off);
        v[j][n] = upper ? combine<MAX>(o, hi) : combine<MAX>(lo, o);
      }
    }
  }
#pragma unroll
  for (int off = 16 >> LOG_VPT; off > 0; off >>= 1) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const T o = __shfl_xor_sync(FULL, v[0][n], off);
      v[0][n] = combine<MAX>(v[0][n], o);
    }
  }
  // Lane L of warp w now holds virtual warp w + WARPS k, k = L / WARPS
  // (WARPS lanes a virtual warp).  Warp 0's pass over the 32 virtual-warp
  // partials took lane 0's butterfly: at offset off it added partial j +
  // off to partial j.  Its levels down to off = WARPS pair virtual warps of
  // one warp, WARPS * (off / WARPS) = off lanes apart, so they run here, the
  // lower lane's value first; the last log2(WARPS) levels pair the warps.
#pragma unroll
  for (int off = 16; off >= WARPS; off >>= 1) {
#pragma unroll
    for (int n = 0; n < N; ++n)
      v[0][n] = combine<MAX>(v[0][n], __shfl_xor_sync(FULL, v[0][n], off));
  }
  if (lane == 0) {
#pragma unroll
    for (int n = 0; n < N; ++n) part[n * WARPS + warp] = v[0][n];
  }
  __syncthreads();
  // every thread: the warps' levels, in registers
#pragma unroll
  for (int n = 0; n < N; ++n) {
    T t[WARPS];
#pragma unroll
    for (int j = 0; j < WARPS; ++j) t[j] = part[n * WARPS + j];
#pragma unroll
    for (int off = WARPS / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int j = 0; j < off; ++j) t[j] = combine<MAX>(t[j], t[j + off]);
    }
    res[n] = t[0];
  }
}

// W: rows with a weight (w <= 0: padding).  S: lambda_m, lambda_var (and
// w) in shared memory, padded with zeros to a multiple of 1024 rows, so
// that every load of a warp that has a row is in bounds and only the sums
// are predicated; else in global memory, each load guarded.
template <typename T, bool W, bool S>
struct Rows {
  const T* lm;
  const T* lv;
  const T* w;
  int nt;
  T rl;            // sum(w r lambda_m)
  T R;             // sum(w r)
  T logR;
  T* part;         // two buffers of 3 x WARPS reduction partials
  int buf;         // the buffer the next reduction writes

  // f(k, counts, lambda_m, lambda_var, w) for the rows of this thread's
  // virtual threads threadIdx.x + THREADS k, each's in ascending order.
  // The blocks of 1024 rows that nt fills take no branch, so the loads and
  // the arithmetic of the VPT rows interleave; the last block's rows are
  // guarded.
  template <typename F>
  __device__ __forceinline__ void for_rows(F&& f) const {
    const int lane = threadIdx.x & 31;
    int b = 0;
    for (; b + VTHREADS <= nt; b += VTHREADS) {
#pragma unroll
      for (int k = 0; k < VPT; ++k) {
        const int i = b + THREADS * k + threadIdx.x;
        const T wi = W ? w[i] : T(1);
        f(k, !W || wi > T(0), lm[i], lv[i], wi);
      }
    }
    if (b < nt) {
#pragma unroll
      for (int k = 0; k < VPT; ++k) {
        const int i0 = b + THREADS * k + threadIdx.x - lane;
        if (i0 >= nt) break;   // the warp has no row left
        const int i = i0 + lane;
        const bool in = i < nt;
        T lmi = T(0), lvi = T(0), wi = T(1);
        if (S || in) {
          lmi = lm[i];
          lvi = lv[i];
          if (W) wi = w[i];
        }
        f(k, in && (!W || wi > T(0)), lmi, lvi, wi);
      }
    }
  }
  template <bool MAX, int N>
  __device__ __forceinline__ void reduce(T (&v)[VPT][N], T (&res)[N]) {
    block_reduce<MAX>(v, res, part + buf * (3 * WARPS));
    buf ^= 1;
  }
};

// The profiled objective and its derivative in logA (see the header).
template <typename T, bool W, bool S>
__device__ __forceinline__ void evaluate(Rows<T, W, S>& d, T logA, T& value,
                                         T& grad) {
  const T A = t_exp(logA);
  const T hA2 = (T(0.5) * A) * A;
  const T A2 = A * A;
  const T ninf = -t_inf(A);
  // pass 1: the max of z over the rows that count
  T m[VPT][1];
#pragma unroll
  for (int k = 0; k < VPT; ++k) m[k][0] = ninf;
  d.for_rows([&](int k, bool ok, T lmi, T lvi, T) {
    const T mz = row_max(m[k][0], A * lmi + hA2 * lvi);
    m[k][0] = ok ? mz : m[k][0];
  });
  T mx[1];
  d.template reduce<true>(m, mx);
  const T shift = is_inf(mx[0]) ? T(0) : mx[0];
  // pass 2: logsumexp(z) = log sum(exp(z - shift)) + shift
  T s[VPT][1];
#pragma unroll
  for (int k = 0; k < VPT; ++k) s[k][0] = T(0);
  d.for_rows([&](int k, bool ok, T lmi, T lvi, T) {
    const T e = s[k][0] + t_exp((A * lmi + hA2 * lvi) - shift);
    s[k][0] = ok ? e : s[k][0];
  });
  T sum[1];
  d.template reduce<false>(s, sum);
  const T lse = t_log(sum[0]) + shift;
  const T lam0 = d.logR - lse;
  // pass 3: sum(w f), sum(w f g), sum(p g)
  T acc[VPT][3];
#pragma unroll
  for (int k = 0; k < VPT; ++k) acc[k][0] = acc[k][1] = acc[k][2] = T(0);
  d.for_rows([&](int k, bool ok, T lmi, T lvi, T wi) {
    const T z = A * lmi + hA2 * lvi;
    const T g = A * lmi + A2 * lvi;
    const T wf = t_exp(z + lam0) * wi;
    const T a0 = acc[k][0] + wf;
    const T a1 = acc[k][1] + wf * g;
    const T a2 = acc[k][2] + t_exp(z - lse) * g;
    acc[k][0] = ok ? a0 : acc[k][0];
    acc[k][1] = ok ? a1 : acc[k][1];
    acc[k][2] = ok ? a2 : acc[k][2];
  });
  T tot[3];
  d.template reduce<false>(acc, tot);
  const T Arl = A * d.rl;
  value = -((Arl + lam0 * d.R) - tot[0]);
  grad = (tot[1] - Arl) + tot[2] * (d.R - tot[0]);
}

template <typename T>
__device__ __forceinline__ T decrease_error(T stepsize, T value_step,
                                            T slope_step, T value_init,
                                            T slope_init) {
  T de = (value_step - value_init) - (T(SLOPE_RTOL) * stepsize) * slope_init;
  T approx = slope_step - T(2 * SLOPE_RTOL - 1.0) * slope_init;
  const T delta_values =
      (value_step - value_init) - T(APPROX_DEC_RTOL) * t_abs(value_init);
  approx = nan_max(approx, delta_values);
  de = clamp_min0(nan_min(approx, de));
  return is_nan(de) ? t_inf(de) : de;
}

template <typename T>
__device__ __forceinline__ T curvature_error(T slope_step, T slope_init) {
  const T ce = clamp_min0(t_abs(slope_step) - T(CURV_RTOL) * t_abs(slope_init));
  return is_nan(ce) ? t_inf(ce) : ce;
}

template <typename T>
__device__ __forceinline__ T cubicmin(T a, T fa, T fpa, T b, T fb, T c,
                                      T fc) {
  const T C = fpa;
  const T db = b - a;
  const T dc = c - a;
  const T denom = ((db * dc) * (db * dc)) * (db - dc);
  const T v0 = (fb - fa) - C * db;
  const T v1 = (fc - fa) - C * dc;
  const T A = ((dc * dc) * v0 + (-(db * db)) * v1) / denom;
  const T B = ((-((dc * dc) * dc)) * v0 + ((db * db) * db) * v1) / denom;
  const T radical = B * B - (T(3) * A) * C;
  return a + (-B + t_sqrt(radical)) / (T(3) * A);
}

template <typename T>
__device__ __forceinline__ T quadmin(T a, T fa, T fpa, T b, T fb) {
  const T db = b - a;
  const T B = ((fb - fa) - fpa * db) / (db * db);
  return a - fpa / (T(2) * B);
}

template <typename T, bool W, bool S>
struct Search {
  Rows<T, W, S> rows;
  unsigned long long evals;

  __device__ void vg(T x, T& v, T& g) {
    evaluate(rows, x, v, g);
    ++evals;
  }

  // _zoom_linesearch at d = 1: (stepsize, value, grad) of the accepted point
  __device__ void zoom(T params, T updates, T value, T grad, int max_ls,
                       T& out_step, T& out_value, T& out_grad) {
    const T inf = t_inf(value);
    const T slope_init = updates * grad;
    int count = 0;
    T stepsize = T(0), zvalue = value, zgrad = grad, zslope = slope_init;
    T de = inf;
    bool interval_found = false, done = false, failed = false;
    T low = T(0), value_low = value, slope_low = slope_init;
    T high = T(0), value_high = value, slope_high = slope_init;
    T cubic_ref = T(0), value_cubic_ref = value;
    T safe_stepsize = T(0), safe_value = value, safe_grad = grad;
    while (!(done || failed)) {
      if (!interval_found) {
        // search_interval
        const T new_step = count == 0 ? T(1) : T(INCREASE_FACTOR) * stepsize;
        T v, g;
        vg(params + new_step * updates, v, g);
        const T slope = g * updates;
        const T d_e = decrease_error(new_step, v, slope, value, slope_init);
        const T c_e = curvature_error(slope, slope_init);
        const T new_error = nan_max(d_e, c_e);
        const bool safe_decrease = d_e <= T(0);
        const bool set_high = (d_e > T(0)) || ((v >= zvalue) && (count > 0));
        const bool set_low = (slope >= T(0)) && !set_high;
        if (set_low) {
          low = new_step; value_low = v; slope_low = slope;
          high = stepsize; value_high = zvalue; slope_high = zslope;
        } else {
          low = stepsize; value_low = zvalue; slope_low = zslope;
          high = new_step; value_high = v; slope_high = slope;
        }
        done = new_error <= T(0);
        interval_found = set_high || set_low || done;
        failed = (count + 1 >= max_ls) && !done;
        count += 1;
        stepsize = new_step; zvalue = v; zgrad = g; zslope = slope;
        de = d_e;
        cubic_ref = low; value_cubic_ref = value_low;
        if (safe_decrease) {
          safe_stepsize = new_step; safe_value = v; safe_grad = g;
        }
      } else {
        // zoom_into_interval
        const T delta = t_abs(high - low);
        const T left = nan_min(high, low);
        const T right = nan_max(high, low);
        const T cubic_chk = T(0.2) * delta;
        const T quad_chk = T(0.1) * delta;
        const bool too_small_int = delta <= T(INTERVAL_THRESHOLD);
        const T middle_cubic = cubicmin(low, value_low, slope_low, high,
                                        value_high, cubic_ref,
                                        value_cubic_ref);
        const bool use_cubic = (middle_cubic > left + cubic_chk) &&
                               (middle_cubic < right - cubic_chk);
        const T middle_quad = quadmin(low, value_low, slope_low, high,
                                      value_high);
        const bool use_quad = !use_cubic &&
                              (middle_quad > left + quad_chk) &&
                              (middle_quad < right - quad_chk);
        const T middle = use_cubic ? middle_cubic
                         : use_quad ? middle_quad
                                    : (low + high) / T(2);
        T v, g;
        vg(params + middle * updates, v, g);
        const T slope = g * updates;
        const T d_e = decrease_error(middle, v, slope, value, slope_init);
        const T c_e = curvature_error(slope, slope_init);
        const T new_error = nan_max(d_e, c_e);
        if ((d_e <= T(0)) && (v < safe_value)) {
          safe_stepsize = middle; safe_value = v; safe_grad = g;
        }
        const bool now_done = new_error <= T(0);
        const bool set_high_to_middle = (d_e > T(0)) || (v >= value_low);
        const bool set_high_to_low =
            (slope * (high - low) >= T(0)) && !set_high_to_middle;
        T nh = high, nvh = value_high, nsh = slope_high;
        if (set_high_to_middle) { nh = middle; nvh = v; nsh = slope; }
        if (set_high_to_low) { nh = low; nvh = value_low; nsh = slope_low; }
        T nl = low, nvl = value_low, nsl = slope_low;
        if (!set_high_to_middle) { nl = middle; nvl = v; nsl = slope; }
        if (set_high_to_middle || set_high_to_low) {
          cubic_ref = high; value_cubic_ref = value_high;
        } else {
          cubic_ref = low; value_cubic_ref = value_low;
        }
        const bool presumably_failed =
            (count + 1 >= max_ls) || (too_small_int && safe_stepsize > T(0));
        count += 1;
        stepsize = middle; zvalue = v; zgrad = g; zslope = slope;
        de = d_e;
        done = now_done;
        failed = presumably_failed && !now_done;
        low = nl; value_low = nvl; slope_low = nsl;
        high = nh; value_high = nvh; slope_high = nsh;
      }
      if (failed && (safe_stepsize > T(0) || is_inf(de))) {
        // try_safe_step
        stepsize = safe_stepsize; zvalue = safe_value; zgrad = safe_grad;
      }
    }
    out_step = stepsize;
    out_value = zvalue;
    out_grad = zgrad;
  }
};

template <typename T, bool W, bool S>
__global__ void __launch_bounds__(THREADS, 1)
fparam_lbfgs_kernel(const T* __restrict__ r, const T* __restrict__ lm,
                    const T* __restrict__ lv, const T* __restrict__ w, int nt,
                    const T* __restrict__ logA0, T* __restrict__ logA_out,
                    T* __restrict__ value_out,
                    unsigned long long* __restrict__ evals, int num_steps,
                    int max_ls, T gtol, T ftol, T ftol_rel) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(16) T part[PART_SIZE];
  const int tid = threadIdx.x;

  Search<T, W, S> srch;
  srch.evals = 0;
  Rows<T, W, S>& d = srch.rows;
  d.nt = nt;
  d.part = part;
  d.buf = 0;
  if (S) {
    const int nt_pad = padded_rows(nt);
    T* lm_s = reinterpret_cast<T*>(smem_raw);
    T* lv_s = lm_s + nt_pad;
    T* w_s = W ? lv_s + nt_pad : nullptr;
    for (int i = tid; i < nt_pad; i += THREADS) {
      const bool in = i < nt;
      lm_s[i] = in ? lm[i] : T(0);
      lv_s[i] = in ? lv[i] : T(0);
      if (W) w_s[i] = in ? w[i] : T(0);
    }
    __syncthreads();
    d.lm = lm_s; d.lv = lv_s; d.w = w_s;
  } else {
    d.lm = lm; d.lv = lv; d.w = w;
  }
  // the constants: sum(w r lambda_m) and sum(w r) (r * w first, as
  // poisson_ell and lambda0_given_logA weight r)
  T c[VPT][2];
#pragma unroll
  for (int k = 0; k < VPT; ++k) c[k][0] = c[k][1] = T(0);
  for (int base = tid; base < nt; base += VTHREADS) {
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int i = base + THREADS * k;
      if (i < nt && (!W || w[i] > T(0))) {
        const T rw = r[i] * (W ? w[i] : T(1));
        c[k][0] += rw * lm[i];
        c[k][1] += rw;
      }
    }
  }
  T cs[2];
  d.template reduce<false>(c, cs);
  d.rl = cs[0];
  d.R = cs[1];
  d.logR = t_log(cs[1]);

  const T inf = t_inf(cs[0]);
  const bool early = gtol > T(0) || ftol > T(0) || ftol_rel > T(0);
  // the L-BFGS state (_LbfgsState at d = 1); the memory in the two-loop
  // recursion's order: [MEM - 1] is the newest pair, [0] the oldest
  int count = 0;
  T s_params = T(0), s_updates = T(0), s_value = inf, s_grad = T(0);
  T dp[MEM], du[MEM], rho[MEM];
#pragma unroll
  for (int p = 0; p < MEM; ++p) dp[p] = du[p] = rho[p] = T(0);
  T x = logA0[0];
  T x_best = x, f_best = inf, f_prev = inf;
  bool was_frozen = false, done = false;

  for (int step = 0; step < num_steps; ++step) {
    T value, grad;
    if (is_finite(s_value)) {
      value = s_value; grad = s_grad;
    } else {
      srch.vg(x, value, grad);
    }
    const T value_for_best = was_frozen ? inf : value;
    if (is_finite(value_for_best) && value_for_best < f_best) {
      x_best = x; f_best = value_for_best;
    }
    if (early) {
      bool conv = false;
      if (gtol > T(0))
        conv = conv || (is_finite(value) && t_abs(grad) <= gtol);
      if (ftol > T(0) || ftol_rel > T(0)) {
        const T thresh = ftol + ftol_rel * t_abs(value);
        conv = conv || (t_abs(value - f_prev) < thresh);
      }
      done = done || (conv && !was_frozen);
      f_prev = was_frozen ? inf : value;
      if (done) {
        // identity step, the value and gradient stored
        s_value = value; s_grad = grad;
        was_frozen = false;
        continue;
      }
    }
    // _scale_by_lbfgs: the memory update and the two-loop recursion.  The
    // pair goes to slot (count - 1) % MEM, which the recursion reads last
    // from the top (memory_idx = count % MEM comes first): shifting the
    // ring down by one and writing the top is the same order.
    T diff_params = x - s_params;
    T diff_updates = grad - s_updates;
    const T vdot = diff_updates * diff_params;
    T weight = vdot == T(0) ? T(0) : T(1) / vdot;
    if (count == 0) {
      diff_params = T(0); diff_updates = T(0); weight = T(0);
    }
#pragma unroll
    for (int p = 0; p + 1 < MEM; ++p) {
      dp[p] = dp[p + 1]; du[p] = du[p + 1]; rho[p] = rho[p + 1];
    }
    dp[MEM - 1] = diff_params;
    du[MEM - 1] = diff_updates;
    rho[MEM - 1] = weight;
    T identity_scale;
    if (count > 0) {
      const T numerator = diff_updates * diff_params;
      const T denominator = diff_updates * diff_updates;
      identity_scale = denominator > T(0) ? numerator / denominator : T(1);
    } else {
      // a capped reciprocal of the gradient norm (NaN stays NaN)
      const T s = T(1) / t_sqrt(grad * grad);
      identity_scale = s > T(1) ? T(1) : s;
    }
    T vec = grad;
    T alphas[MEM];
#pragma unroll
    for (int pos = MEM - 1; pos >= 0; --pos) {
      const T alpha = rho[pos] * (dp[pos] * vec);
      vec = vec + (-alpha) * du[pos];
      alphas[pos] = alpha;
    }
    vec = identity_scale * vec;
#pragma unroll
    for (int pos = 0; pos < MEM; ++pos) {
      const T beta = rho[pos] * (du[pos] * vec);
      vec = vec + (alphas[pos] - beta) * dp[pos];
    }
    count += 1;
    s_params = x;
    s_updates = grad;
    const T direction = -vec;
    T lr, ls_value, ls_grad;
    srch.zoom(x, direction, value, grad, max_ls, lr, ls_value, ls_grad);
    s_value = ls_value;
    s_grad = ls_grad;
    const T x_new = x + lr * direction;
    was_frozen = !is_finite(x_new);   // freeze on a non-finite update
    if (!was_frozen) x = x_new;
  }
  T value_f;
  if (is_finite(s_value)) {
    value_f = s_value;
  } else {
    T g;
    srch.vg(x, value_f, g);
  }
  if (was_frozen) value_f = inf;
  if (is_finite(value_f) && value_f < f_best) {
    x_best = x; f_best = value_f;
  }
  if (tid == 0) {
    *logA_out = x_best;
    *value_out = f_best;
    atomicAdd(evals, srch.evals);
  }
}

template <typename T, bool W, bool S>
int launch_with(const T* r, const T* lm, const T* lv, const T* w, int nt,
                const T* logA0, T* logA_out, T* value_out,
                unsigned long long* evals, int num_steps, int max_ls,
                double gtol, double ftol, double ftol_rel,
                cudaStream_t stream) {
  const int dyn = S ? static_cast<int>(data_bytes(nt, W, sizeof(T))) : 0;
  // past 48 KB with the static partials, only with the opt-in attribute
  if (dyn + PART_SIZE * sizeof(T) > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fparam_lbfgs_kernel<T, W, S>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  fparam_lbfgs_kernel<T, W, S><<<1, THREADS, dyn, stream>>>(
      r, lm, lv, w, nt, logA0, logA_out, value_out, evals, num_steps, max_ls,
      static_cast<T>(gtol), static_cast<T>(ftol), static_cast<T>(ftol_rel));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool W>
int launch_rows(const T* r, const T* lm, const T* lv, const T* w, int nt,
                const T* logA0, T* logA_out, T* value_out,
                unsigned long long* evals, int num_steps, int max_ls,
                double gtol, double ftol, double ftol_rel,
                cudaStream_t stream) {
  return data_bytes(nt, W, sizeof(T)) <= SMEM_DATA_MAX
             ? launch_with<T, W, true>(r, lm, lv, w, nt, logA0, logA_out,
                                       value_out, evals, num_steps, max_ls,
                                       gtol, ftol, ftol_rel, stream)
             : launch_with<T, W, false>(r, lm, lv, w, nt, logA0, logA_out,
                                        value_out, evals, num_steps, max_ls,
                                        gtol, ftol, ftol_rel, stream);
}

template <typename T>
int launch(const T* r, const T* lm, const T* lv, const T* w, int nt,
           const T* logA0, T* logA_out, T* value_out,
           unsigned long long* evals, int num_steps, int max_ls, double gtol,
           double ftol, double ftol_rel, void* stream) {
  if (nt < 1 || num_steps < 0 || max_ls < 0) return ERR_ARGS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return w != nullptr
             ? launch_rows<T, true>(r, lm, lv, w, nt, logA0, logA_out,
                                    value_out, evals, num_steps, max_ls, gtol,
                                    ftol, ftol_rel, s)
             : launch_rows<T, false>(r, lm, lv, w, nt, logA0, logA_out,
                                     value_out, evals, num_steps, max_ls,
                                     gtol, ftol, ftol_rel, s);
}

}  // namespace

extern "C" int fparam_lbfgs_f32(const float* r, const float* lm,
                                const float* lv, const float* w, int nt,
                                const float* logA0, float* logA_out,
                                float* value_out, unsigned long long* evals,
                                int num_steps, int max_ls, double gtol,
                                double ftol, double ftol_rel, void* stream) {
  return launch(r, lm, lv, w, nt, logA0, logA_out, value_out, evals,
                num_steps, max_ls, gtol, ftol, ftol_rel, stream);
}

extern "C" int fparam_lbfgs_f64(const double* r, const double* lm,
                                const double* lv, const double* w, int nt,
                                const double* logA0, double* logA_out,
                                double* value_out, unsigned long long* evals,
                                int num_steps, int max_ls, double gtol,
                                double ftol, double ftol_rel, void* stream) {
  return launch(r, lm, lv, w, nt, logA0, logA_out, value_out, evals,
                num_steps, max_ls, gtol, ftol, ftol_rel, stream);
}

extern "C" int fparam_lbfgs_smem_bytes(int nt, int weighted, int dtype_bytes) {
  const size_t bytes = data_bytes(nt, weighted != 0, dtype_bytes);
  return bytes <= SMEM_DATA_MAX ? static_cast<int>(bytes) : 0;
}

extern "C" const char* fparam_lbfgs_error_string(int code) {
  if (code == ERR_ARGS)
    return "nt < 1, num_steps < 0 or max_linesearch_steps < 0";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
