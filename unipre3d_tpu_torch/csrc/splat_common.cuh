// Device code shared by the dense and binned splat kernels (sm_90a):
// the EWA power in the plain versions' rounding, the conservative cull of a
// table column against a pixel rectangle, the staged column record and the
// warp reduction of a column's nine gradient terms.
//
// kernels.py hashes this header with every source, so an edit here rebuilds
// both libraries.
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

}  // namespace splat
