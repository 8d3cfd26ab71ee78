// Exponential- and power-cone projections of one 3-block, in two forms:
// by a group of L lanes of one warp (the lane-parallel form, below, which
// kernel B runs at L = 32) and by one thread (namespace per_thread, which
// the megakernel runs).
//
// The projections of totsu_tpu/solver/cone.py _proj_exp_rst and
// _proj_pow_rst (and of their plain PyTorch ports in
// totsu_tpu_torch/solver/cone.py), for float and double: the same trivial
// cases in the same order (in the cone, in the polar, the negative
// quadrant or z = 0), the same bracket, the same overflow-safe rescaling
// and the same safeguarded Newton step. In the lane-parallel form every
// lane of a group computes the trivial tests redundantly, so a group
// takes one branch, and blocks in different branches never share a
// group. Only its root finder differs from the serial one of the
// per-thread form, whose trips are each a dependent evaluation
// (exp: up to 40 bracket-expansion trips, then up to 26 / 38
// Newton-bisection trips; pow: up to 28 / 54):
//
//  * Bracket expansion (exp, one end infinite): lane k evaluates h at
//    end +- 2^k, the points the serial doubling visits, L of them per
//    round; the lowest lane whose sign shows the root (a ballot) gives the
//    bracket [2^(K-1), 2^K] from the end. One round for L = 32 unless the
//    root lies past 2^31.
//  * Newton-multisection trips: lane 0 evaluates f and f' at the iterate,
//    lanes 1..L-1 evaluate f at L-1 interior points of the bracket; the
//    lowest point whose sign puts the root at or below it (a ballot) cuts
//    the bracket L times narrower, then lane 0's Newton step is taken as
//    the serial hybrid takes it (strictly inside the bracket, or equal to
//    the iterate), else the midpoint. A trip is one evaluation deep and
//    shrinks the bracket at least L times, so a root at a bracket end
//    (where the Newton step leaves the bracket) costs log_L of the bits,
//    not one trip per bit. exp places the points evenly in value (its
//    brackets span at most a factor of two after the expansion); pow
//    evenly in the bit pattern of the non-negative floats, because its
//    roots in (0, |z0|) run down to 1e-21 |z0| and beyond.
//  * The trips end at a fixed point of the state (lo, hi, r), which every
//    lane holds bit for bit (the points are formed from the state by
//    formula, f and f' of the iterate come from lane 0 by shuffle), within
//    the serial trip counts.
//
// The longest chain, measured on the smoke's test blocks by the torch
// model of this code (ops/kernels/cone_proj.py _lane_model, at L = 32):
// exp 8 (f32) and 14 (f64) sequential evaluations, pow 7 and 14, against
// the serial 26, 39, 28 and 54 trips. The CPU tests hold the model under
// CHAIN_BOUND there (f32 10, f64 16).
//
// Ties resolve to the lowest lane, nothing is atomic, so a repeat is
// bitwise equal. The accurate exp / log / sqrt are used (no __expf, no
// fast math): the bracket and sign tests depend on them; the multisection
// points are formed without contraction, so the model takes the same
// points.

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
// a + b * c rounded twice, never contracted into an FMA
__device__ __forceinline__ float c_axpy(float a, float b, float c) {
  return __fadd_rn(a, __fmul_rn(b, c));
}
__device__ __forceinline__ double c_axpy(double a, double b, double c) {
  return __dadd_rn(a, __dmul_rn(b, c));
}
// false for +-inf and NaN
template <typename T>
__device__ __forceinline__ bool c_finite(T x) { return c_abs(x) < T(INFINITY); }
template <typename T>
__device__ __forceinline__ bool c_inf(T x) { return c_abs(x) == T(INFINITY); }
template <typename T>
__device__ __forceinline__ T c_max(T a, T b) { return a > b ? a : b; }
template <typename T>
__device__ __forceinline__ T c_min(T a, T b) { return a < b ? a : b; }
// 2^k, exactly
template <typename T>
__device__ __forceinline__ T pow2(int k) {
  return static_cast<T>(ldexp(1.0, k));
}

// L lanes of one warp that project one block together: lane is 0..L-1,
// base the group's first lane in the warp
template <int L>
struct Group {
  static_assert(L == 2 || L == 4 || L == 8 || L == 16 || L == 32,
                "a group is a power of two of lanes within a warp");
  unsigned mask;
  int base, lane;
  __device__ explicit Group(int warp_lane)
      : mask(L == 32 ? 0xffffffffu
                     : ((1u << (L & 31)) - 1u) << (warp_lane & ~(L - 1))),
        base(warp_lane & ~(L - 1)),
        lane(warp_lane & (L - 1)) {}
  // the lowest lane of the group whose pred holds, L if none
  __device__ int first(bool pred) const {
    const unsigned b = __ballot_sync(mask, pred) >> base;
    return b != 0u ? __ffs(b) - 1 : L;
  }
  // lane 0's value, in every lane of the group
  template <typename T>
  __device__ T from0(T v) const {
    return __shfl_sync(mask, v, 0, L);
  }
};

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

// (w0 + sqrt(w0^2 + 4 c q)) / 2, by the conjugate form for w0 < 0; *root
// receives the square root
template <typename T>
__device__ __forceinline__ T half_quad(T w0, T coef, T q, T* root) {
  const T sq = c_sqrt(w0 * w0 + T(4) * coef * q);
  *root = sq;
  return w0 >= T(0) ? T(0.5) * (w0 + sq)
                    : T(2) * coef * q / c_max(sq - w0, Trips<T>::kTiny);
}

// phi(r) = a log x(r) + (1-a) log y(r) - log r of the pow root problem,
// decreasing on (0, |z0|), and its derivative
template <typename T>
__device__ __forceinline__ T pow_phi(T r, T x0, T y0, T az, T a, T* grad) {
  const T tiny = Trips<T>::kTiny;
  const T b = T(1) - a;
  const T q = r * (az - r);
  T sx, sy;
  const T xr = half_quad(x0, a, q, &sx);
  const T yr = half_quad(y0, b, q, &sy);
  const T v = a * c_log(c_max(xr, tiny)) + b * c_log(c_max(yr, tiny)) -
              c_log(c_max(r, tiny));
  if (grad != nullptr) {
    const T qp = az - T(2) * r;
    *grad = a * a * qp / c_max(xr * sx, tiny) +
            b * b * qp / c_max(yr * sy, tiny) - T(1) / c_max(r, tiny);
  }
  return v;
}

// x^a y^(1-a) for x, y >= 0 (0 when either is 0)
template <typename T>
__device__ __forceinline__ T pow_val(T x, T y, T a) {
  if (!(x > T(0) && y > T(0))) return T(0);
  const T tiny = Trips<T>::kTiny;
  return c_exp(a * c_log(c_max(x, tiny)) + (T(1) - a) * c_log(c_max(y, tiny)));
}

// the bit pattern of a non-negative float as an integer that orders as
// the floats do
__device__ __forceinline__ int to_bits(float x) { return __float_as_int(x); }
__device__ __forceinline__ long long to_bits(double x) {
  return __double_as_longlong(x);
}
__device__ __forceinline__ float from_bits(int i) { return __int_as_float(i); }
__device__ __forceinline__ double from_bits(long long i) {
  return __longlong_as_double(i);
}

// Multisection point j (1..L-1) of the bracket [lo, hi]: evenly in value
// (exp) or in the bit pattern of non-negative floats (pow); floor
// division, so every lane forms the same point
template <typename T, int L>
__device__ __forceinline__ T sect_point(T lo, T hi, int j, bool in_bits) {
  if (!in_bits) return c_axpy(lo, hi - lo, T(j) / T(L));
  const auto ia = to_bits(lo);
  const auto d = to_bits(hi) - ia;
  return from_bits(ia + (d / L) * j + (d % L) * j / L);
}

// One Newton-multisection trip on the state (lo, hi, r) of a root of
// f(x, grad) (increasing, or decreasing with dec): lane 0 at the iterate
// r with f', lanes 1..L-1 at the interior points. Returns whether the
// state changed.
template <typename T, int L, class F>
__device__ __forceinline__ bool sect_trip(const Group<L>& g, T& lo, T& hi,
                                          T& r, bool dec, bool in_bits,
                                          F f) {
  const T x = g.lane == 0 ? r : sect_point<T, L>(lo, hi, g.lane, in_bits);
  T gx;
  const T vx = f(x, &gx);
  // the lowest point at or above the root (L if none); lane 0 is the
  // iterate, not a point
  const bool above = dec ? vx > T(0) : vx < T(0);  // the root lies above x
  const int j = g.first(g.lane > 0 && !above);
  const T v = g.from0(vx), gr = g.from0(gx);
  const T lo1 = j > 1 ? sect_point<T, L>(lo, hi, j - 1, in_bits) : lo;
  const T hi1 = j < L ? sect_point<T, L>(lo, hi, j, in_bits) : hi;
  // the serial hybrid's step on the narrowed bracket; the iterate's sign
  // counts only where the iterate lies in it
  const bool inside = r >= lo1 && r <= hi1;
  const bool up = dec ? v > T(0) : v < T(0);
  const T lo2 = inside && up ? r : lo1;
  const T hi2 = inside && !up ? r : hi1;
  const T nxt = r - v / (gr != T(0) ? gr : T(1));
  const bool ok = c_finite(nxt) && gr != T(0) &&
                  ((nxt > lo2 && nxt < hi2) || (nxt == r && inside));
  const T r2 = ok ? nxt : T(0.5) * (lo2 + hi2);
  const bool same = lo2 == lo && hi2 == hi && r2 == r;
  lo = lo2;
  hi = hi2;
  r = r2;
  return !same;
}

// Projection of (r, s, t) onto the exponential cone
// cl{(r, s, t) : s e^{r/s} <= t, s > 0}, in place, in every lane of g.
template <typename T, int L>
__device__ void proj_exp(const Group<L>& g, T& r, T& s, T& t) {
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
  auto h = [&](T rho, T* grad) { return exp_h(rho, r0, s0, t0, grad); };
  // bracket from s(rho) > 0 and lambda(rho) > 0; at most one end is
  // infinite here (r0 > 0 or s0 > 0)
  const T inf = T(INFINITY);
  T lo = c_max(r0 > T(0) ? T(1) - s0 / safe_r : -inf,
               s0 < T(0) ? r0 / safe_s : -inf);
  T hi = c_min(r0 < T(0) ? T(1) - s0 / safe_r : inf,
               s0 > T(0) ? r0 / safe_s : inf);
  const bool lo_inf = c_inf(lo), hi_inf = c_inf(hi);
  if (lo_inf || hi_inf) {
    // the serial doubling's points end +- 2^k, L per round; the lowest k
    // whose sign shows the root (k = 40 when none of 0..39 does)
    const T end = hi_inf ? lo : hi;
    int kk = kExpExpandTrips;
    for (int k0 = 0; k0 < kExpExpandTrips; k0 += L) {
      const int k = k0 + g.lane;
      bool stop = true;
      if (k < kExpExpandTrips) {
        const T p = hi_inf ? end + pow2<T>(k) : end - pow2<T>(k);
        const T v = h(p, nullptr);
        stop = hi_inf ? !(v < T(0)) : !(v > T(0));
      }
      const int j = g.first(stop);
      if (j < L) {
        kk = k0 + j;
        break;
      }
    }
    const T far = hi_inf ? end + pow2<T>(kk) : end - pow2<T>(kk);
    const T near =
        kk > 0 ? (hi_inf ? end + pow2<T>(kk - 1) : end - pow2<T>(kk - 1))
               : end;
    lo = hi_inf ? near : far;
    hi = hi_inf ? far : near;
  }
  T rho = T(0.5) * (lo + hi);
  for (int k = 0; k < Trips<T>::kExp; ++k)
    if (!sect_trip<T, L>(g, lo, hi, rho, false, false, h)) break;
  const T den = rho * (rho - T(1)) + T(1);
  const T sv = c_max(((rho - T(1)) * r0 + s0) / den, T(0));
  // t: the KKT form for rho >= 0, the boundary form s e^rho below
  const T tv = rho >= T(0) ? t0 + (r0 - rho * s0) * c_exp(-rho) / den
                           : sv * c_exp(rho);
  r = rho * sv;
  s = sv;
  t = c_max(tv, T(0));
}

// Projection of (x, y, z) onto the power cone
// {(x, y, z) : x^a y^(1-a) >= |z|, x, y >= 0}, in place, in every lane
// of g.
template <typename T, int L>
__device__ void proj_pow(const Group<L>& g, T& x, T& y, T& z, T a) {
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
  auto phi = [&](T r, T* grad) { return pow_phi(r, x0, y0, az, a, grad); };
  T lo = T(0), hi = az, r = T(0.5) * az;
  for (int k = 0; k < Trips<T>::kPow; ++k)
    if (!sect_trip<T, L>(g, lo, hi, r, true, true, phi)) break;
  const T q = r * (az - r);
  T sx, sy;
  x = half_quad(x0, a, q, &sx) * scl;
  y = half_quad(y0, b, q, &sy) * scl;
  z = (z0 > T(0) ? r : -r) * scl;
}

// Projection of one block onto the cone (kind 0: exp, 1: pow with
// exponent a) or, with dual, onto its dual cone by the Moreau identity
// x + proj_K(-x), by the L lanes of g, each holding the block; every lane
// receives the result.
template <typename T, int L>
__device__ __forceinline__ void proj_block(const Group<L>& g, T& v0, T& v1,
                                           T& v2, int kind, T a, bool dual) {
  T p0 = dual ? -v0 : v0, p1 = dual ? -v1 : v1, p2 = dual ? -v2 : v2;
  if (kind == 0)
    proj_exp<T, L>(g, p0, p1, p2);
  else
    proj_pow<T, L>(g, p0, p1, p2, a);
  if (dual) {
    p0 = v0 + p0;
    p1 = v1 + p1;
    p2 = v2 + p2;
  }
  v0 = p0;
  v1 = p1;
  v2 = p2;
}

// ---- the per-thread form: a thread per block, each root finder one
// thread's serial chain (the trips of the plain version: up to 40
// expansion trips, then up to 26 / 38 Newton-bisection trips; pow up to
// 28 / 54), each loop ending at its fixed point. The megakernel keeps it:
// its CTAs hold a few dozen 3-blocks, which the lane-parallel form puts on
// up to 16 warps, each running a whole trip per block; on the H100 that
// form was slower at every group size (PERF.md).
namespace per_thread {

// The exp projection of one 3-block by one thread, in place: the serial
// root finder (bracket doubling, then the Newton-bisection hybrid).
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

// The pow projection of one 3-block by one thread, in place: the serial
// Newton-bisection hybrid on (0, |z0|).
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

// proj_block's per-thread form: one block by one thread.
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

}  // namespace per_thread

// Clocks of `evals` dependent evaluations of the exp root function with
// its derivative (kind 0) or of the pow one (kind 1) in one thread: the
// latency of one evaluation, the unit of a root finder's chain.
template <typename T>
__device__ long long eval_chain_clocks(int kind, int evals, T* sink) {
  T x = T(0.3), gsum = T(0);
  const long long t0 = clock64();
  for (int i = 0; i < evals; ++i) {
    T gr;
    const T v = kind == 0 ? exp_h(x, T(1), T(2), T(3), &gr)
                          : pow_phi(x, T(-0.5), T(0.7), T(1), T(0.3), &gr);
    x = T(0.3) + v * T(1e-20);  // the next evaluation waits for this one
    gsum += gr;
  }
  const long long clocks = clock64() - t0;
  *sink = x + gsum;
  return clocks;
}

}  // namespace totsu_cone
