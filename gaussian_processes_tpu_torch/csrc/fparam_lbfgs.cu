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
// Layout: one block of 1024 threads.  Every thread runs the same scalar
// state machine on the same values (each reduction's result is broadcast
// through shared memory), so control flow is uniform and every thread meets
// every barrier; thread 0 alone writes the memory ring (shared memory) and
// the outputs.  An evaluation is three passes over the rows, each ending in
// a block reduction (warp shuffles, then warp 0 over the 32 warp partials):
// the max of z, the sum of exp(z - max), then sum(w f), sum(w f g) and
// sum(p g) in one.  lambda_m, lambda_var (and w) are copied once into
// dynamic shared memory when they fit (3160 float32 rows are 25 KB, 38 KB
// with a weight; float64 twice that; up to 227 KB with the opt-in
// attribute), else read from global memory, where L2 keeps them.
//
// What bounds it: the bytes the search must read (r, lambda_m, lambda_var
// once) take 0.011 us at nt 3160 in float32 at 3.35 TB/s, and the
// arithmetic the function needs (13 operations a row an evaluation, each
// row's work counted once as chip_smoke.py's FPARAM_ROW_FLOPS derives it;
// ~108 evaluations a search, the bench fit's mean) 0.066 us at 67 TFLOP/s,
// but neither is the limit.
// The limit is the serial chain: each evaluation is three dependent block
// reductions (each two barriers) with the scalar state machine between
// them, about 6 us an evaluation at this width (H100 80GB HBM3 at 700 W,
// PERF.md), so a search sits three orders of magnitude above its bound.
// The design keeps that chain on one SM with no launch, no host round trip
// and no synchronisation between evaluations; the data stays in shared
// memory, so each pass is a few loads a thread.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;   // 32: warp 0 reduces one partial a lane
constexpr int MEM = 15;               // optax's memory_size at the f-param site
// dynamic shared memory for the data: what a block may opt in to (232,448
// bytes) less room for the static shared memory below
constexpr size_t SMEM_DATA_MAX = 232448 - 4096;
constexpr int ERR_ARGS = -1;

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

// N values reduced over the block (sums, or NaN-propagating maxima); every
// thread returns with the block's results.  Two barriers: the partials
// array is free again once all threads passed the second one, and `out` is
// rewritten only after the next call's first barrier, when every thread has
// read it.
template <bool MAX, typename T, int N>
__device__ __forceinline__ void block_reduce(T (&v)[N], T* part, T* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const T o = __shfl_xor_sync(0xffffffffu, v[n], off);
      v[n] = MAX ? nan_max(v[n], o) : v[n] + o;
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int n = 0; n < N; ++n) part[warp * N + n] = v[n];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int n = 0; n < N; ++n) v[n] = part[lane * N + n];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const T o = __shfl_xor_sync(0xffffffffu, v[n], off);
        v[n] = MAX ? nan_max(v[n], o) : v[n] + o;
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int n = 0; n < N; ++n) out[n] = v[n];
    }
  }
  __syncthreads();
#pragma unroll
  for (int n = 0; n < N; ++n) v[n] = out[n];
}

template <typename T>
struct Rows {
  const T* lm;
  const T* lv;
  const T* w;      // nullptr: every row counts
  int nt;
  T rl;            // sum(w r lambda_m)
  T R;             // sum(w r)
  T logR;
  T* part;         // WARPS * 3 reduction partials
  T* out;          // 3 reduction results
};

// The profiled objective and its derivative in logA (see the header).
template <typename T>
__device__ void evaluate(const Rows<T>& d, T logA, T& value, T& grad) {
  const T A = t_exp(logA);
  const T hA2 = (T(0.5) * A) * A;
  const T A2 = A * A;
  const T ninf = -t_inf(A);
  // pass 1: the max of z over the rows that count
  T m[1] = {ninf};
  for (int i = threadIdx.x; i < d.nt; i += THREADS) {
    if (d.w != nullptr && !(d.w[i] > T(0))) continue;
    m[0] = nan_max(m[0], A * d.lm[i] + hA2 * d.lv[i]);
  }
  block_reduce<true>(m, d.part, d.out);
  const T shift = is_inf(m[0]) ? T(0) : m[0];
  // pass 2: logsumexp(z) = log sum(exp(z - shift)) + shift
  T s[1] = {T(0)};
  for (int i = threadIdx.x; i < d.nt; i += THREADS) {
    if (d.w != nullptr && !(d.w[i] > T(0))) continue;
    s[0] += t_exp((A * d.lm[i] + hA2 * d.lv[i]) - shift);
  }
  block_reduce<false>(s, d.part, d.out);
  const T lse = t_log(s[0]) + shift;
  const T lam0 = d.logR - lse;
  // pass 3: sum(w f), sum(w f g), sum(p g)
  T acc[3] = {T(0), T(0), T(0)};
  for (int i = threadIdx.x; i < d.nt; i += THREADS) {
    const T wi = d.w != nullptr ? d.w[i] : T(1);
    if (!(wi > T(0))) continue;
    const T z = A * d.lm[i] + hA2 * d.lv[i];
    const T g = A * d.lm[i] + A2 * d.lv[i];
    const T wf = t_exp(z + lam0) * wi;
    acc[0] += wf;
    acc[1] += wf * g;
    acc[2] += t_exp(z - lse) * g;
  }
  block_reduce<false>(acc, d.part, d.out);
  const T Arl = A * d.rl;
  value = -((Arl + lam0 * d.R) - acc[0]);
  grad = (acc[1] - Arl) + acc[2] * (d.R - acc[0]);
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

template <typename T>
struct Ring {
  T dp[MEM];
  T du[MEM];
  T rho[MEM];
};

template <typename T>
struct Search {
  Rows<T> rows;
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

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
fparam_lbfgs_kernel(const T* __restrict__ r, const T* __restrict__ lm,
                    const T* __restrict__ lv, const T* __restrict__ w, int nt,
                    const T* __restrict__ logA0, T* __restrict__ logA_out,
                    T* __restrict__ value_out,
                    unsigned long long* __restrict__ evals, int num_steps,
                    int max_ls, T gtol, T ftol, T ftol_rel, int in_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T part[WARPS * 3];
  __shared__ T out[3];
  __shared__ Ring<T> ring;
  const int tid = threadIdx.x;

  Search<T> S;
  S.evals = 0;
  Rows<T>& d = S.rows;
  d.nt = nt;
  d.part = part;
  d.out = out;
  if (in_smem) {
    T* lm_s = reinterpret_cast<T*>(smem_raw);
    T* lv_s = lm_s + nt;
    T* w_s = w != nullptr ? lv_s + nt : nullptr;
    for (int i = tid; i < nt; i += THREADS) {
      lm_s[i] = lm[i];
      lv_s[i] = lv[i];
      if (w != nullptr) w_s[i] = w[i];
    }
    d.lm = lm_s; d.lv = lv_s; d.w = w_s;
  } else {
    d.lm = lm; d.lv = lv; d.w = w;
  }
  if (tid < MEM) {
    ring.dp[tid] = T(0); ring.du[tid] = T(0); ring.rho[tid] = T(0);
  }
  // the constants: sum(w r lambda_m) and sum(w r) (r * w first, as
  // poisson_ell and lambda0_given_logA weight r)
  T c[2] = {T(0), T(0)};
  for (int i = tid; i < nt; i += THREADS) {
    const T wi = w != nullptr ? w[i] : T(1);
    if (!(wi > T(0))) continue;
    const T rw = r[i] * wi;
    c[0] += rw * lm[i];
    c[1] += rw;
  }
  block_reduce<false>(c, part, out);   // its barriers also publish the copy
  d.rl = c[0];
  d.R = c[1];
  d.logR = t_log(c[1]);

  const T inf = t_inf(c[0]);
  const bool early = gtol > T(0) || ftol > T(0) || ftol_rel > T(0);
  // the L-BFGS state (_LbfgsState at d = 1)
  int count = 0;
  T s_params = T(0), s_updates = T(0), s_value = inf, s_grad = T(0);
  T x = logA0[0];
  T x_best = x, f_best = inf, f_prev = inf;
  bool was_frozen = false, done = false;

  for (int step = 0; step < num_steps; ++step) {
    T value, grad;
    if (is_finite(s_value)) {
      value = s_value; grad = s_grad;
    } else {
      S.vg(x, value, grad);
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
    // _scale_by_lbfgs: the memory update and the two-loop recursion
    const int memory_idx = count % MEM;
    const int prev_idx = (count + MEM - 1) % MEM;
    T diff_params = x - s_params;
    T diff_updates = grad - s_updates;
    const T vdot = diff_updates * diff_params;
    T weight = vdot == T(0) ? T(0) : T(1) / vdot;
    if (count == 0) {
      diff_params = T(0); diff_updates = T(0); weight = T(0);
    }
    __syncthreads();   // every thread has read the ring of the last step
    if (tid == 0) {
      ring.dp[prev_idx] = diff_params;
      ring.du[prev_idx] = diff_updates;
      ring.rho[prev_idx] = weight;
    }
    __syncthreads();
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
      const int idx = (memory_idx + pos) % MEM;
      const T alpha = ring.rho[idx] * (ring.dp[idx] * vec);
      vec = vec + (-alpha) * ring.du[idx];
      alphas[pos] = alpha;
    }
    vec = identity_scale * vec;
#pragma unroll
    for (int pos = 0; pos < MEM; ++pos) {
      const int idx = (memory_idx + pos) % MEM;
      const T beta = ring.rho[idx] * (ring.du[idx] * vec);
      vec = vec + (alphas[pos] - beta) * ring.dp[idx];
    }
    count += 1;
    s_params = x;
    s_updates = grad;
    const T direction = -vec;
    T lr, ls_value, ls_grad;
    S.zoom(x, direction, value, grad, max_ls, lr, ls_value, ls_grad);
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
    S.vg(x, value_f, g);
  }
  if (was_frozen) value_f = inf;
  if (is_finite(value_f) && value_f < f_best) {
    x_best = x; f_best = value_f;
  }
  if (tid == 0) {
    *logA_out = x_best;
    *value_out = f_best;
    atomicAdd(evals, S.evals);
  }
}

template <typename T>
int launch(const T* r, const T* lm, const T* lv, const T* w, int nt,
           const T* logA0, T* logA_out, T* value_out,
           unsigned long long* evals, int num_steps, int max_ls, double gtol,
           double ftol, double ftol_rel, void* stream) {
  if (nt < 1 || num_steps < 0 || max_ls < 0) return ERR_ARGS;
  const size_t bytes = static_cast<size_t>(nt) * (w != nullptr ? 3 : 2) *
                       sizeof(T);
  const int in_smem = bytes <= SMEM_DATA_MAX;
  const int dyn = in_smem ? static_cast<int>(bytes) : 0;
  if (dyn > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fparam_lbfgs_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        dyn);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  fparam_lbfgs_kernel<T><<<1, THREADS, dyn, static_cast<cudaStream_t>(
      stream)>>>(r, lm, lv, w, nt, logA0, logA_out, value_out, evals,
                 num_steps, max_ls, static_cast<T>(gtol),
                 static_cast<T>(ftol), static_cast<T>(ftol_rel), in_smem);
  return static_cast<int>(cudaGetLastError());
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
  const size_t bytes = static_cast<size_t>(nt) * (weighted ? 3 : 2) *
                       dtype_bytes;
  return bytes <= SMEM_DATA_MAX ? static_cast<int>(bytes) : 0;
}

extern "C" const char* fparam_lbfgs_error_string(int code) {
  if (code == ERR_ARGS)
    return "nt < 1, num_steps < 0 or max_linesearch_steps < 0";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
