// Device code shared by the splat kernels (sm_90a): the walk's thresholds,
// the EWA power in the plain versions' rounding, the conservative cull of a
// table column against a pixel rectangle, the staged column record and the
// warp reduction of a column's nine gradient terms (all three kernel
// pairs); the culled 32-column group and the per-pair forward and backward
// arithmetic of a warp's walk (the binned and streaming pairs, whose walks
// differ in what they walk, a tile's duplicate list or the flagged chunks
// of the global depth order, and in the pixels of a lane).
//
// kernels.py hashes this header with every source, so an edit here rebuilds
// every library.
//
// The cull (the plain twin is splat_dense.py:cull_keeps): the pair is live
// at a pixel only where o exp(power) >= 1/255, i.e. where d' M d <= 2 ln(255
// o) for the conic M = [[A, B], [B, C]] and d = mean - pixel. The float32
// evaluation of the power errs by at most ~6 u ((|A| + |B|) dx^2 + (|C| +
// |B|) dy^2) (u = 2^-24: the rounding of dx, dy and of the seven operations)
// and expf and the product with o by a few ulps; the test therefore takes
// the deflated form M - 1e-5 diag(|A| + |B|, |C| + |B|) against 2 ln(255 o)
// + 1e-3 (the absolute slack also covers underflow and the float logf of
// 255 o), in double (its reciprocals by __drcp_rn), and finds the exact
// minimum of the quadratic over the rectangle (zero if the centre lies in
// it, else the least of the four edge minima). Columns it cannot decide are
// kept, as an unculled walk treats them: a non-finite mean, conic or
// opacity, a deflated form that is not positive definite, or magnitudes
// (|mean| >= 1e9, |conic| >= 1e18) at which the float32 power could
// overflow. Opacity <= 0 (padding) is dropped: alpha <= 0 at every pixel.
// The test culls on alpha < 1/255 alone, so it is conservative for every
// kernel that skips a pair at alpha < 1/255 (the dense kernels also at
// power > 1e-4, the binned ones also at power > 0).

#pragma once

#include <cuda_runtime.h>

namespace splat {

constexpr unsigned FULL = 0xffffffffu;
// the walk: a pair is skipped below alpha 1/255, alpha is capped at 0.99,
// and a pixel stops where log T would fall below log(1e-4)
constexpr float ALPHA_MIN = (float)(1.0 / 255.0);
constexpr float ALPHA_MAX = 0.99f;
constexpr float LOG_T_EPS = -9.210340371976184f;  // log(1e-4)
// the cull's margins (splat_dense.py holds the same)
constexpr double CULL_DEFLATE = 1e-5;
constexpr double CULL_TAU_SLACK = 1e-3;
constexpr double CULL_MAX_MEAN = 1e9;
constexpr double CULL_MAX_CONIC = 1e18;

// one staged column: (mx, my, A, B), (C, o, r, g), (b, column bits, -, -);
// a pair reads it with two or three broadcast 128-bit shared loads
struct __align__(16) Rec {
  float4 p, q, s;
};

// EWA power -0.5 (A dx^2 + C dy^2) - B dx dy, rounded op by op without FMA
// contraction in the plain version's order: with exp and log alike, the
// kernel and the plain version then take the same skip and stop decisions,
// so a pixel near the T threshold cannot flip between them.
__device__ __forceinline__ float ewa_power(float A, float B, float C, float dx,
                                          float dy) {
  const float q = __fadd_rn(__fmul_rn(__fmul_rn(A, dx), dx),
                            __fmul_rn(__fmul_rn(C, dy), dy));
  return __fsub_rn(__fmul_rn(-0.5f, q), __fmul_rn(__fmul_rn(B, dx), dy));
}

// min and max of finite doubles as one compare and a select (fmin/fmax
// also order NaN and signed zeros, at ~5 instructions each)
__device__ __forceinline__ double dmin(double x, double y) {
  return x < y ? x : y;
}

__device__ __forceinline__ double dmax(double x, double y) {
  return x > y ? x : y;
}

// min over Y in [lo, hi] of a X^2 + 2 b X Y + c Y^2 (c > 0, rc = 1 / c)
__device__ __forceinline__ double edge_min(double a, double b, double c,
                                           double rc, double X, double lo,
                                           double hi) {
  const double y = dmin(dmax(-b * X * rc, lo), hi);
  return a * X * X + 2.0 * b * X * y + c * y * y;
}

// False only where the column is skipped at every pixel of the rectangle
// [x0, x1] x [y0, y1] (pixel coordinates, x0 <= x1, y0 <= y1); see the
// header.
__device__ __forceinline__ bool rect_keeps(float fmx, float fmy, float fA,
                                           float fB, float fC, float fo,
                                           double x0, double x1, double y0,
                                           double y1) {
  if (!(isfinite(fmx) && isfinite(fmy) && isfinite(fA) && isfinite(fB) &&
        isfinite(fC) && isfinite(fo)))
    return true;
  if (fo <= 0.f) return false;
  const double mx = fmx, my = fmy, A = fA, B = fB, C = fC;
  if (fabs(mx) >= CULL_MAX_MEAN || fabs(my) >= CULL_MAX_MEAN ||
      fabs(A) >= CULL_MAX_CONIC || fabs(B) >= CULL_MAX_CONIC ||
      fabs(C) >= CULL_MAX_CONIC)
    return true;
  const double a = A - CULL_DEFLATE * (fabs(A) + fabs(B));
  const double c = C - CULL_DEFLATE * (fabs(C) + fabs(B));
  if (!(a > 0.0 && a * c - B * B > 0.0)) return true;
  const double tau = 2.0 * (double)logf(255.f * fo) + CULL_TAU_SLACK;
  if (tau < 0.0) return false;
  const double lx = mx - x1, hx = mx - x0, ly = my - y1, hy = my - y0;
  if (lx <= 0.0 && hx >= 0.0 && ly <= 0.0 && hy >= 0.0) return true;
  // every operand is finite here (the tests above keep the rest)
  const double ra = __drcp_rn(a), rc = __drcp_rn(c);
  const double m = dmin(dmin(edge_min(a, B, c, rc, lx, ly, hy),
                             edge_min(a, B, c, rc, hx, ly, hy)),
                        dmin(edge_min(c, B, a, ra, ly, lx, hx),
                             edge_min(c, B, a, ra, hy, lx, hx)));
  return m <= tau;
}

// Sums v[0..8] over the warp's lanes and adds the nine sums to the
// column's gradient rows dgc[k * stride] with one global atomicAdd each (a
// fire-and-forget RED in L2). Rows 0-7: a reduce-scatter over lane bits 4,
// 3, 2 leaves row lane >> 2 summed over eight lanes, two more shuffles over
// the whole warp; row 8: a butterfly. 14 shuffles instead of 9 x 5. (A
// shared accumulator costs more on this card: a float atomicAdd to shared
// memory compiles to a compare-and-swap loop, ATOMS.CAST.SPIN.)
__device__ __forceinline__ void warp_sum_into(float (&v)[9],
                                              float* __restrict__ dgc,
                                              int stride, int lane) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool up = lane & 16;
    const float send = up ? v[j] : v[j + 4];
    const float keep = up ? v[j + 4] : v[j];
    v[j] = keep + __shfl_xor_sync(FULL, send, 16);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const bool up = lane & 8;
    const float send = up ? v[j] : v[j + 2];
    const float keep = up ? v[j + 2] : v[j];
    v[j] = keep + __shfl_xor_sync(FULL, send, 8);
  }
  {
    const bool up = lane & 4;
    const float send = up ? v[0] : v[1];
    const float keep = up ? v[1] : v[0];
    v[0] = keep + __shfl_xor_sync(FULL, send, 4);
  }
  v[0] += __shfl_xor_sync(FULL, v[0], 2);
  v[0] += __shfl_xor_sync(FULL, v[0], 1);
  float s8 = v[8];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s8 += __shfl_xor_sync(FULL, s8, off);
  if ((lane & 3) == 0 && v[0] != 0.f)
    atomicAdd(&dgc[(size_t)(lane >> 2) * stride], v[0]);
  if (lane == 1 && s8 != 0.f) atomicAdd(&dgc[(size_t)8 * stride], s8);
}

// ---- the warp walk (the binned and streaming kernels) ----

// A warp's pixel rectangle x0, x1, y0, y1.
struct Rect {
  int x0, x1, y0, y1;
};

// Loads columns j0 + lane (j0 + lane < j1) of the table ``tab`` (rows 0-8,
// row stride ``stride``), culls each against the warp's rectangle and
// stores the kept ones, in depth order, as records recs[0, n) (rec.s.y:
// the column); returns n. Brackets its stores with __syncwarp, so the
// previous group's records are consumed and the new ones visible.
__device__ __forceinline__ int warp_group(Rec* recs,
                                          const float* __restrict__ tab,
                                          long long stride, int j0, int j1,
                                          const Rect& r) {
  const int lane = threadIdx.x & 31, j = j0 + lane;
  float v[9];
  bool keep = false;
  if (j < j1) {
#pragma unroll
    for (int k = 0; k < 9; ++k) v[k] = tab[(size_t)k * stride + j];
    keep = rect_keeps(v[0], v[1], v[2], v[3], v[4], v[5], r.x0, r.x1, r.y0,
                      r.y1);
  }
  const unsigned ballot = __ballot_sync(FULL, keep);
  __syncwarp();
  if (keep) {
    Rec& rec = recs[__popc(ballot & ((1u << lane) - 1u))];
    rec.p = make_float4(v[0], v[1], v[2], v[3]);
    rec.q = make_float4(v[4], v[5], v[6], v[7]);
    rec.s = make_float4(v[8], __int_as_float(j), 0.f, 0.f);
  }
  __syncwarp();
  return __popc(ballot);
}

// A pair's alpha and log(1 - alpha) and whether the walk skips it (power >
// 0 or alpha < 1/255).
struct Pair {
  float a, l;
  bool skip;
};

__device__ __forceinline__ Pair pair_of(const Rec& rec, float px, float py) {
  const float dx = __fsub_rn(rec.p.x, px);
  const float dy = __fsub_rn(rec.p.y, py);
  const float power = ewa_power(rec.p.z, rec.p.w, rec.q.x, dx, dy);
  Pair q;
  q.a = fminf(ALPHA_MAX, __fmul_rn(rec.q.y, expf(power)));
  q.skip = power > 0.f || q.a < ALPHA_MIN;
  q.l = log1pf(-q.a);
  return q;
}

// Blends a pair into the pixel's colour and log T, in the plain version's
// order; false where it stops the pixel (log T would fall below log 1e-4).
__device__ __forceinline__ bool blend(const Pair& q, const Rec& rec,
                                      float& log_t, float& cr, float& cg,
                                      float& cb) {
  if (q.skip) return true;
  const float incl = __fadd_rn(log_t, q.l);
  if (incl < LOG_T_EPS) return false;
  const float w = __fmul_rn(q.a, expf(log_t));
  cr = __fadd_rn(cr, __fmul_rn(w, rec.q.z));
  cg = __fadd_rn(cg, __fmul_rn(w, rec.q.w));
  cb = __fadd_rn(cb, __fmul_rn(w, rec.s.x));
  log_t = incl;
  return true;
}

// A pixel of the backward: its cotangent g, tot = sum_c g (out - bg
// T_final) and T_final (g . bg), and the walk's state.
struct GradPixel {
  float g0, g1, g2, s_tot, tb;
  float log_t, u_incl;  // log T after the last contributing pair; the
                        // inclusive prefix of w (g . c)
  bool stopped;
};

// The backward's step over one record at one pixel (the forward's skip
// and stop decisions, then dL/dalpha = (g . c) T_before - (s_i + T_final
// (g . bg)) / max(1 - alpha, 1e-6) with s_i = tot - the inclusive prefix,
// through alpha only where alpha < 0.99): the pair's nine gradient terms
// into v (zeroed by the caller); true where the pair contributes. Only
// values that feed the gradient alone take fast intrinsics (T before the
// pair, the division).
__device__ __forceinline__ bool pair_grad(const Rec& rec, float px, float py,
                                          GradPixel& s, float (&v)[9]) {
  if (s.stopped) return false;
  const float4 a4 = rec.p, b4 = rec.q;
  const float A = a4.z, B = a4.w, C = b4.x;
  const float dx = __fsub_rn(a4.x, px);
  const float dy = __fsub_rn(a4.y, py);
  const float power = ewa_power(A, B, C, dx, dy);
  const float e = expf(power);
  const float a = fminf(ALPHA_MAX, __fmul_rn(b4.y, e));
  if (power > 0.f || a < ALPHA_MIN) return false;
  const float incl = __fadd_rn(s.log_t, log1pf(-a));
  if (incl < LOG_T_EPS) {
    s.stopped = true;
    return false;
  }
  const float t_before = __expf(s.log_t);
  const float w = a * t_before;
  const float cgv = s.g0 * b4.z + s.g1 * b4.w + s.g2 * rec.s.x;
  s.u_incl += w * cgv;
  const float dalpha =
      cgv * t_before -
      __fdividef((s.s_tot - s.u_incl) + s.tb, fmaxf(1.f - a, 1e-6f));
  v[6] = s.g0 * w;
  v[7] = s.g1 * w;
  v[8] = s.g2 * w;
  if (a < ALPHA_MAX) {
    const float dpow = dalpha * a;
    v[0] = -dpow * (A * dx + B * dy);
    v[1] = -dpow * (C * dy + B * dx);
    v[2] = -0.5f * dpow * dx * dx;
    v[3] = -dpow * dx * dy;
    v[4] = -0.5f * dpow * dy * dy;
    v[5] = dalpha * e;
  }
  s.log_t = incl;
  return true;
}

// The backward's pixel of a (render) image plane: its cotangent, tot and
// T_final (g . bg) at flat index q of an image of hw pixels; all zero for
// a lane outside its tile.
__device__ __forceinline__ GradPixel grad_pixel(
    bool inside, size_t r, size_t hw, size_t q, const float* __restrict__ bg,
    const float* __restrict__ logt, const float* __restrict__ tot,
    const float* __restrict__ gout) {
  GradPixel s;
  s.g0 = s.g1 = s.g2 = s.s_tot = s.tb = 0.f;
  s.log_t = s.u_incl = 0.f;
  s.stopped = !inside;
  if (inside) {
    const float* go = gout + r * 3 * hw + q;
    s.g0 = go[0];
    s.g1 = go[hw];
    s.g2 = go[2 * hw];
    s.s_tot = tot[r * hw + q];
    // background share of dL/dalpha: T_final (bg . g)
    s.tb = expf(logt[r * hw + q]) * (bg[0] * s.g0 + bg[1] * s.g1 +
                                     bg[2] * s.g2);
  }
  return s;
}

// Writes a forward pixel: out = colour + bg T_final, and log T_final.
__device__ __forceinline__ void write_pixel(size_t r, size_t hw, size_t q,
                                            const float* __restrict__ bg,
                                            float cr, float cg, float cb,
                                            float log_t,
                                            float* __restrict__ out,
                                            float* __restrict__ logt) {
  const float t = expf(log_t);
  float* o = out + r * 3 * hw + q;
  o[0] = __fadd_rn(cr, __fmul_rn(bg[0], t));
  o[hw] = __fadd_rn(cg, __fmul_rn(bg[1], t));
  o[2 * hw] = __fadd_rn(cb, __fmul_rn(bg[2], t));
  logt[r * hw + q] = log_t;
}

}  // namespace splat
