// Device code shared by the two solve kernels, fused_admm.cu (one solve) and
// fused_admm_batch.cu (a batch of solves): the function codes and statuses
// of pogs_tpu_torch.types, the adaptive-rho constants of solver/admm.py, a
// warp sum, and the prox library of prox/scalar.py and prox/vector.py (the
// 16 base functions under the (a, b, c, d, e) transform), in precise math in
// the working type.  Both libraries hash this header (ops/_build.py), so an
// edit to it rebuilds both.

#pragma once

#include <cfloat>
#include <cuda_runtime.h>

namespace pogs {

// Function codes; the values of pogs_tpu_torch.types.Function.
enum Fn {
  ABS = 0, EXP = 1, HUBER = 2, IDENTITY = 3, INDBOX01 = 4, INDEQ0 = 5,
  INDGE0 = 6, INDLE0 = 7, LOGISTIC = 8, MAXNEG0 = 9, MAXPOS0 = 10,
  NEGENTR = 11, NEGLOG = 12, RECIPR = 13, SQUARE = 14, ZERO = 15,
};

// Statuses; the values of pogs_tpu_torch.types.Status.
constexpr int kSuccess = 0, kMaxIter = 3, kNanFound = 4;

// Adaptive-rho constants (solver/admm.py; pogs.cpp:94-110).
constexpr double K_DELTA_MIN = 1.05;
constexpr double K_GAMMA = 1.01;
constexpr double K_TAU = 0.8;
constexpr double K_KAPPA = 0.9;
constexpr int K_SPEC_FREQ = 50;
constexpr double K_SPEC_CHANGE_MIN = 0.67;
constexpr double K_SPEC_CHANGE_MAX = 1.5;
constexpr double K_SPEC_IMB_THRESH = 10.0;
constexpr double K_SPEC_MIN_DELTA = 0.05;

template <typename T> struct Lim;
template <> struct Lim<float> {
  static __device__ float tiny() { return FLT_MIN; }
  static __device__ float rho_min() { return 1e-2f; }
  static __device__ float rho_max() { return 1e2f; }
};
template <> struct Lim<double> {
  static __device__ double tiny() { return DBL_MIN; }
  static __device__ double rho_min() { return 1e-4; }
  static __device__ double rho_max() { return 1e4; }
};

// Precise math in the working type (no fast-math intrinsics).
__device__ __forceinline__ float m_exp(float x) { return expf(x); }
__device__ __forceinline__ double m_exp(double x) { return exp(x); }
__device__ __forceinline__ float m_log(float x) { return logf(x); }
__device__ __forceinline__ double m_log(double x) { return log(x); }
__device__ __forceinline__ float m_log1p(float x) { return log1pf(x); }
__device__ __forceinline__ double m_log1p(double x) { return log1p(x); }
__device__ __forceinline__ float m_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double m_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float m_tanh(float x) { return tanhf(x); }
__device__ __forceinline__ double m_tanh(double x) { return tanh(x); }
__device__ __forceinline__ float m_cbrt(float x) { return cbrtf(x); }
__device__ __forceinline__ double m_cbrt(double x) { return cbrt(x); }
__device__ __forceinline__ float m_acos(float x) { return acosf(x); }
__device__ __forceinline__ double m_acos(double x) { return acos(x); }
__device__ __forceinline__ float m_cos(float x) { return cosf(x); }
__device__ __forceinline__ double m_cos(double x) { return cos(x); }
__device__ __forceinline__ float m_fabs(float x) { return fabsf(x); }
__device__ __forceinline__ double m_fabs(double x) { return ::fabs(x); }
__device__ __forceinline__ bool m_finite(float x) { return isfinite(x); }
__device__ __forceinline__ bool m_finite(double x) { return isfinite(x); }

template <typename T> __device__ __forceinline__ T tmax(T a, T b) { return a > b ? a : b; }
template <typename T> __device__ __forceinline__ T tmin(T a, T b) { return a < b ? a : b; }
template <typename T> __device__ __forceinline__ T tclip(T x, T lo, T hi) {
  return tmin(tmax(x, lo), hi);
}
template <typename T> __device__ __forceinline__ T tsign(T x) {
  return x > T(0) ? T(1) : (x < T(0) ? T(-1) : T(0));
}

// ---------------------------------------------------------------------------
// Special functions (prox/tools.py): fixed iteration counts, tiny guards.
// ---------------------------------------------------------------------------

template <typename T> __device__ T lambertw_exp(T x) {
  const T one = T(1);
  T w = x > one ? x - m_log(tmax(x, one)) : m_exp(tmin(x, one));
  const T tiny = Lim<T>::tiny();
  for (int i = 0; i < 20; ++i) {
    w = tmax(w, tiny);
    T f = w + m_log(w) - x;
    w = w - f * w / (w + one);
  }
  return tmax(w, tiny);
}

template <typename T> __device__ T cubic_solve(T p, T q, T r) {
  const T third = T(1.0 / 3.0);
  T s = p * third;
  T s2 = s * s;
  T a = q * third - s2;
  T b = s * s2 - s * q * T(0.5) + r * T(0.5);
  T disc = a * a * a + b * b;
  T A_card = m_cbrt(m_sqrt(tmax(disc, T(0))) - b);
  T t_card = A_card == T(0) ? T(0) : A_card - a / A_card;
  T na = tmax(-a, Lim<T>::tiny());
  T sq_na = m_sqrt(na);
  T cos_arg = tclip(-b / (na * sq_na), T(-1), T(1));
  T t_trig = T(2) * sq_na * m_cos(m_acos(cos_arg) * third);
  return (disc >= T(0) ? t_card : t_trig) - s;
}

template <typename T> __device__ __forceinline__ T sigmoid(T x) {
  return T(0.5) * (m_tanh(T(0.5) * x) + T(1));
}

template <typename T> __device__ T prox_logistic(T v, T rho) {
  T lo = v - T(1) / rho;
  T hi = v;
  T x = v < T(-2.5) ? v
        : (v > T(2.5) + T(1) / rho ? v - T(1) / rho
                                   : (rho * v - T(0.5)) / (T(0.2) + rho));
  auto newton = [&]() {
    T sig = sigmoid(x);
    T f = sig + rho * (x - v);
    T g = sig * (T(1) - sig) + rho;
    if (f < T(0)) lo = x; else hi = x;
    x = tmin(tmax(x - f / g, lo), hi);
  };
  for (int i = 0; i < 5; ++i) newton();
  for (int i = 0; i < 30; ++i) {
    T mid = T(0.5) * (lo + hi);
    if (sigmoid(mid) + rho * (mid - v) < T(0)) lo = mid; else hi = mid;
  }
  x = T(0.5) * (lo + hi);
  for (int i = 0; i < 2; ++i) newton();
  return x;
}

// prox of the base function h with penalty rho (prox/scalar.py::PROX).
template <typename T> __device__ T prox_base(int h, T v, T rho) {
  switch (h) {
    case ABS: {
      T k = T(1) / rho;
      return tmax(v - k, T(0)) + tmin(v + k, T(0));
    }
    case EXP: return v - lambertw_exp(v - m_log(rho));
    case HUBER:
      return m_fabs(v) < T(1) + T(1) / rho ? v * rho / (T(1) + rho)
                                         : v - tsign(v) / rho;
    case IDENTITY: return v - T(1) / rho;
    case INDBOX01: return tclip(v, T(0), T(1));
    case INDEQ0: return T(0);
    case INDGE0: return tmax(v, T(0));
    case INDLE0: return tmin(v, T(0));
    case LOGISTIC: return prox_logistic(v, rho);
    case MAXNEG0:
      return v + T(1) / rho <= T(0) ? v + T(1) / rho : tmax(v, T(0));
    case MAXPOS0:
      return v >= T(1) / rho ? v - T(1) / rho : tmin(v, T(0));
    case NEGENTR:
      return lambertw_exp(rho * v - T(1) + m_log(rho)) / rho;
    case NEGLOG: return T(0.5) * (v + m_sqrt(v * v + T(4) / rho));
    case RECIPR: return cubic_solve(-v, T(0), -T(1) / rho);
    case SQUARE: return rho * v / (T(1) + rho);
    case ZERO: return v;
    default: return v;
  }
}

// h(x) (prox/scalar.py::FUNC).
template <typename T> __device__ T func_base(int h, T x) {
  switch (h) {
    case ABS: return m_fabs(x);
    case EXP: return m_exp(x);
    case HUBER: {
      T ax = m_fabs(x);
      return ax < T(1) ? T(0.5) * ax * ax : ax - T(0.5);
    }
    case IDENTITY: return x;
    case INDBOX01: return T(0);
    case INDEQ0: return T(0);
    case INDGE0: return T(0);
    case INDLE0: return T(0);
    case LOGISTIC: return tmax(x, T(0)) + m_log1p(m_exp(-m_fabs(x)));
    case MAXNEG0: return tmax(-x, T(0));
    case MAXPOS0: return tmax(x, T(0));
    case NEGENTR:
      return x <= T(0) ? T(0) : x * m_log(tmax(x, Lim<T>::tiny()));
    case NEGLOG: return -m_log(tmax(x, T(0)));
    case RECIPR: return T(1) / tmax(x, T(0));
    case SQUARE: return T(0.5) * x * x;
    case ZERO: return T(0);
    default: return T(0);
  }
}

// prox of c h(a x - b) + d x + (e/2) x^2 (prox/vector.py::prox_eval).
template <typename T>
__device__ T prox_full(int h, T a, T b, T c, T d, T e, T v, T rho) {
  if (a == T(0)) return (v * rho - d) / (e + rho);
  T vt = a * (v * rho - d) / (e + rho) - b;
  T rt = (e + rho) / (c * a * a);
  return (prox_base(h, vt, rt) + b) / a;
}

// Sum over the 32 lanes of a warp; the result is valid in every lane.  The
// butterfly order is fixed, so the sum is the same on every run.
template <typename T> __device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One step of the adaptive rho schedule (pogs.cpp:401-466; the plain
// version is solver/admm.py::rho_schedule) after iteration k: the spectral
// step every K_SPEC_FREQ iterations, the balancing step otherwise.  Updates
// rho, delta, xi, kd and ku in place and returns the factor that rescales z~.
// Where `step` is given it receives the step taken: kRhoKeep, kRhoUp (rho
// delta, z~ over delta), kRhoDown (rho / delta, z~ times delta) or
// kRhoSpectral.
enum RhoStep { kRhoKeep = 0, kRhoUp = 1, kRhoDown = 2, kRhoSpectral = 3 };

template <typename T>
__device__ T rho_schedule_step(int k, T nrm_r, T nrm_s, T eps_pri, T eps_dua, T& rho, T& delta,
                               T& xi, T& kd, T& ku, int* step = nullptr) {
  const T one = T(1);
  const T rho_min = Lim<T>::rho_min(), rho_max = Lim<T>::rho_max();
  const T pri_n = nrm_r / eps_pri;
  const T dua_n = nrm_s / eps_dua;
  const bool spec_slot = k > 0 && k % K_SPEC_FREQ == 0 && eps_pri > T(0) && eps_dua > T(0);
  const T safe_dua = dua_n == T(0) ? one : dua_n;
  const T imb = pri_n / safe_dua;
  const T thresh = T(K_SPEC_IMB_THRESH);
  const bool spec_cond = pri_n > T(0) && dua_n > T(0) && (imb > thresh || imb < one / thresh);
  const T ratio = tclip(m_sqrt(imb), T(K_SPEC_CHANGE_MIN), T(K_SPEC_CHANGE_MAX));
  const T rho_spec = tclip(rho * ratio, rho_min, rho_max);
  const bool spec_apply =
      spec_slot && spec_cond && m_fabs(rho_spec - rho) / rho > T(K_SPEC_MIN_DELTA);

  const T kf = T(k);
  const bool bal_slot = !spec_slot;
  const bool s_small = nrm_s < xi * eps_dua;
  const bool r_small = nrm_r < xi * eps_pri;
  const bool bal_up = bal_slot && s_small && !r_small && T(K_TAU) * kf > kd;
  const bool bal_dn = bal_slot && !s_small && r_small && T(K_TAU) * kf > ku && !bal_up;
  const bool bal_both = bal_slot && s_small && r_small && !bal_up && !bal_dn;
  const bool bal_else = bal_slot && !bal_up && !bal_dn && !bal_both;
  const bool up_apply = bal_up && rho < rho_max;
  const bool dn_apply = bal_dn && rho > rho_min;

  T zt_scale = one, rho_new = rho;
  if (spec_apply) { rho_new = rho_spec; zt_scale = rho / rho_spec; }
  else if (up_apply) { rho_new = rho * delta; zt_scale = one / delta; }
  else if (dn_apply) { rho_new = rho / delta; zt_scale = delta; }
  if (up_apply || dn_apply) delta = T(K_GAMMA) * delta;
  else if (bal_else) delta = T(K_DELTA_MIN);
  if (bal_both) xi = xi * T(K_KAPPA);
  if (up_apply) ku = kf;
  if (dn_apply) kd = kf;
  if (step)
    *step = spec_apply ? kRhoSpectral : up_apply ? kRhoUp : dn_apply ? kRhoDown : kRhoKeep;
  rho = rho_new;
  return zt_scale;
}

}  // namespace pogs
