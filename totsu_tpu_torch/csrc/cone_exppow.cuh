// Exponential- and power-cone projections of one 3-block per thread.
//
// The arithmetic of totsu_tpu/solver/cone.py _proj_exp_rst and
// _proj_pow_rst (and of their plain PyTorch ports in
// totsu_tpu_torch/solver/cone.py), for float and double: the same
// bracket, the same fixed trip counts (exp: 40 expansion trips, then 26 /
// 38 Newton-bisection trips; pow: 28 / 54), the same overflow-safe
// rescaling and the same order of the trivial cases (in the cone, in the
// polar, the negative quadrant or z = 0, the root). The JAX code
// evaluates every case and every branch lane-wise and selects; here a
// thread takes only the branch its block needs, so no exponential that
// the JAX code discards (e^{2 rho} at rho = 2^40) is formed. A loop ends
// early when a trip leaves its state unchanged: the trip is a function of
// the state alone, so the result is that of the full trip count.
//
// The accurate exp / log / sqrt are used (no __expf, no fast math): the
// bracket and sign tests depend on them. Shared by cone_proj.cu (the
// blocked projection of the host loop) and megakernel.cu.

#pragma once

#include <math.h>

namespace totsu_cone {

template <typename T>
struct Trips;
template <>
struct Trips<float> {
  static constexpr int kExp = 26, kPow = 28;
  static constexpr float kTiny = 1e-38f;
};
template <>
struct Trips<double> {
  static constexpr int kExp = 38, kPow = 54;
  static constexpr double kTiny = 1e-300;
};
constexpr int kExpExpandTrips = 40;

__device__ __forceinline__ float c_exp(float x) { return expf(x); }
__device__ __forceinline__ double c_exp(double x) { return exp(x); }
__device__ __forceinline__ float c_log(float x) { return logf(x); }
__device__ __forceinline__ double c_log(double x) { return log(x); }
__device__ __forceinline__ float c_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double c_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float c_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double c_abs(double x) { return fabs(x); }
// false for +-inf and NaN
template <typename T>
__device__ __forceinline__ bool c_finite(T x) { return c_abs(x) < T(INFINITY); }
template <typename T>
__device__ __forceinline__ bool c_inf(T x) { return c_abs(x) == T(INFINITY); }
template <typename T>
__device__ __forceinline__ T c_max(T a, T b) { return a > b ? a : b; }
template <typename T>
__device__ __forceinline__ T c_min(T a, T b) { return a < b ? a : b; }

// h(rho) of the exp root problem, rescaled by e^{-|rho|}(rho^2-rho+1) > 0
// (sign- and root-preserving, every term bounded), and its derivative
template <typename T>
__device__ __forceinline__ T exp_h(T rho, T r0, T s0, T t0, T* grad) {
  const T num1 = (rho - T(1)) * r0 + s0;  // coefficient of e^{rho}
  const T num2 = r0 - rho * s0;           // coefficient of e^{-rho}
  const T den = rho * (rho - T(1)) + T(1);
  const T e1 = c_exp(-c_abs(rho));
  const T e2 = c_exp(T(-2) * c_abs(rho));
  const bool pos = rho >= T(0);
  const T v = (pos ? num1 - num2 * e2 : num1 * e2 - num2) - t0 * den * e1;
  if (grad != nullptr) {
    const T denp = T(2) * rho - T(1);
    *grad = (pos ? r0 + (s0 + T(2) * num2) * e2
                 : (r0 + T(2) * num1) * e2 + s0) -
            t0 * (pos ? denp - den : denp + den) * e1;
  }
  return v;
}

// Projection of (r, s, t) onto the exponential cone
// cl{(r, s, t) : s e^{r/s} <= t, s > 0}, in place.
template <typename T>
__device__ void proj_exp(T& r, T& s, T& t) {
  const T r0 = r, s0 = s, t0 = t;
  const T kE = T(2.71828182845904523536);
  const T safe_s = s0 != T(0) ? s0 : T(1);
  const T safe_r = r0 != T(0) ? r0 : T(1);
  const bool in_cone = (s0 > T(0) && s0 * c_exp(r0 / safe_s) <= t0) ||
                       (s0 == T(0) && r0 <= T(0) && t0 >= T(0));
  if (in_cone) return;
  const bool in_polar = (r0 > T(0) && r0 * c_exp(s0 / safe_r) <= -kE * t0) ||
                        (r0 == T(0) && s0 <= T(0) && t0 <= T(0));
  if (in_polar) {
    r = s = t = T(0);
    return;
  }
  if (r0 <= T(0) && s0 <= T(0)) {
    s = T(0);
    t = c_max(t0, T(0));
    return;
  }
  // bracket from s(rho) > 0 and lambda(rho) > 0; at most one end is
  // infinite here (r0 > 0 or s0 > 0)
  const T inf = T(INFINITY);
  const T lo = c_max(r0 > T(0) ? T(1) - s0 / safe_r : -inf,
                     s0 < T(0) ? r0 / safe_s : -inf);
  const T hi = c_min(r0 < T(0) ? T(1) - s0 / safe_r : inf,
                     s0 > T(0) ? r0 / safe_s : inf);
  const bool lo_inf = c_inf(lo), hi_inf = c_inf(hi);
  T lo_f = c_finite(lo) ? lo : hi - T(1);
  T hi_f = c_finite(hi) ? hi : lo + T(1);
  for (int k = 0; k < kExpExpandTrips; ++k) {
    const T hi_n = (hi_inf && exp_h(hi_f, r0, s0, t0, (T*)nullptr) < T(0))
                       ? lo_f + T(2) * (hi_f - lo_f)
                       : hi_f;
    const T lo_n = (lo_inf && exp_h(lo_f, r0, s0, t0, (T*)nullptr) > T(0))
                       ? hi_n + T(2) * (lo_f - hi_n)
                       : lo_f;
    if (hi_n == hi_f && lo_n == lo_f) break;
    hi_f = hi_n;
    lo_f = lo_n;
  }
  // safeguarded Newton-bisection: the sign at rho shrinks the bracket;
  // the Newton point is taken when strictly inside it or equal to rho
  T rho = T(0.5) * (lo_f + hi_f);
  for (int k = 0; k < Trips<T>::kExp; ++k) {
    T g;
    const T v = exp_h(rho, r0, s0, t0, &g);
    const T lo_n = v < T(0) ? rho : lo_f;
    const T hi_n = v < T(0) ? hi_f : rho;
    const T nxt = rho - v / (g != T(0) ? g : T(1));
    const bool ok = c_finite(nxt) && g != T(0) &&
                    ((nxt > lo_n && nxt < hi_n) || nxt == rho);
    const T rho_n = ok ? nxt : T(0.5) * (lo_n + hi_n);
    if (rho_n == rho && lo_n == lo_f && hi_n == hi_f) break;
    lo_f = lo_n;
    hi_f = hi_n;
    rho = rho_n;
  }
  const T den = rho * (rho - T(1)) + T(1);
  const T sv = c_max(((rho - T(1)) * r0 + s0) / den, T(0));
  // t: the KKT form for rho >= 0, the boundary form s e^rho below
  const T tv = rho >= T(0) ? t0 + (r0 - rho * s0) * c_exp(-rho) / den
                           : sv * c_exp(rho);
  r = rho * sv;
  s = sv;
  t = c_max(tv, T(0));
}

// (w0 + sqrt(w0^2 + 4 c q)) / 2, by the conjugate form for w0 < 0; *root
// receives the square root
template <typename T>
__device__ __forceinline__ T half_quad(T w0, T coef, T q, T* root) {
  const T sq = c_sqrt(w0 * w0 + T(4) * coef * q);
  *root = sq;
  return w0 >= T(0) ? T(0.5) * (w0 + sq)
                    : T(2) * coef * q / c_max(sq - w0, Trips<T>::kTiny);
}

// x^a y^(1-a) for x, y >= 0 (0 when either is 0)
template <typename T>
__device__ __forceinline__ T pow_val(T x, T y, T a) {
  if (!(x > T(0) && y > T(0))) return T(0);
  const T tiny = Trips<T>::kTiny;
  return c_exp(a * c_log(c_max(x, tiny)) + (T(1) - a) * c_log(c_max(y, tiny)));
}

// Projection of (x, y, z) onto the power cone
// {(x, y, z) : x^a y^(1-a) >= |z|, x, y >= 0}, in place.
template <typename T>
__device__ void proj_pow(T& x, T& y, T& z, T a) {
  const T tiny = Trips<T>::kTiny;
  const T b = T(1) - a;
  const T scl = c_max(c_max(c_abs(x), c_abs(y)), c_max(c_abs(z), T(1e-30)));
  const T x0 = x / scl, y0 = y / scl, z0 = z / scl;
  const T az = c_abs(z0);
  if (x0 >= T(0) && y0 >= T(0) && pow_val(x0, y0, a) >= az) {
    x = x0 * scl;
    y = y0 * scl;
    z = z0 * scl;
    return;
  }
  if (x0 <= T(0) && y0 <= T(0) && pow_val(-x0 / a, -y0 / b, a) >= az) {
    x = y = z = T(0);
    return;
  }
  if (az == T(0)) {
    x = c_max(x0, T(0)) * scl;
    y = c_max(y0, T(0)) * scl;
    z = T(0);
    return;
  }
  // phi(r) = a log x(r) + (1-a) log y(r) - log r on (0, |z0|), decreasing
  T lo = T(0), hi = az, r = T(0.5) * az;
  for (int k = 0; k < Trips<T>::kPow; ++k) {
    const T q = r * (az - r);
    const T qp = az - T(2) * r;
    T sx, sy;
    const T xr = half_quad(x0, a, q, &sx);
    const T yr = half_quad(y0, b, q, &sy);
    const T v = a * c_log(c_max(xr, tiny)) + b * c_log(c_max(yr, tiny)) -
                c_log(c_max(r, tiny));
    const T g = a * a * qp / c_max(xr * sx, tiny) +
                b * b * qp / c_max(yr * sy, tiny) - T(1) / c_max(r, tiny);
    const T lo_n = v > T(0) ? r : lo;
    const T hi_n = v > T(0) ? hi : r;
    const T nxt = r - v / (g != T(0) ? g : T(1));
    const bool ok = c_finite(nxt) && g != T(0) &&
                    ((nxt > lo_n && nxt < hi_n) || nxt == r);
    const T r_n = ok ? nxt : T(0.5) * (lo_n + hi_n);
    if (r_n == r && lo_n == lo && hi_n == hi) break;
    lo = lo_n;
    hi = hi_n;
    r = r_n;
  }
  const T q = r * (az - r);
  T sx, sy;
  x = half_quad(x0, a, q, &sx) * scl;
  y = half_quad(y0, b, q, &sy) * scl;
  z = (z0 > T(0) ? r : -r) * scl;
}

// Projection of one block onto the cone (kind 0: exp, 1: pow with
// exponent a) or, with dual, onto its dual cone by the Moreau identity
// x + proj_K(-x).
template <typename T>
__device__ __forceinline__ void proj_block(T& v0, T& v1, T& v2, int kind,
                                           T a, bool dual) {
  T p0 = dual ? -v0 : v0, p1 = dual ? -v1 : v1, p2 = dual ? -v2 : v2;
  if (kind == 0)
    proj_exp(p0, p1, p2);
  else
    proj_pow(p0, p1, p2, a);
  if (dual) {
    p0 = v0 + p0;
    p1 = v1 + p1;
    p2 = v2 + p2;
  }
  v0 = p0;
  v1 = p1;
  v2 = p2;
}

}  // namespace totsu_cone
