// Selective state-space scan (S6 / Mamba): forward and analytic backward
// (sm_90a).
//
// Replaces unipre3d_tpu/ops/scan.py:36 selective_scan, which the JAX package
// writes as a chunked jax.lax.associative_scan (its TPU-shaped stand-in for
// the reference's sequential CUDA selective_scan_fn). The function, float32
// throughout, channel-last [B, L, D] with N = 16 state lanes innermost:
//
//   dt_t = softplus(delta_t + bias)            (bias, softplus optional)
//   h_t  = exp(dt_t * A) * h_{t-1} + dt_t * B_t * u_t
//   y_t  = (<C_t, h_t> + D * u_t) * silu(z_t)  (D, the gate optional)
//
// Design: one thread per (b, d, n), the 16 state lanes of a (b, d) in one
// half-warp; a CTA of 256 threads walks 16 consecutive channels of one batch
// row. The walk over t is sequential, the state in a register;
// <C_t, h_t> is a 16-lane shuffle sum. Steps go in groups of 16: lane k of
// each half-warp loads step t0 + k's u, delta, z (and dy) and computes its
// softplus, gate and their derivatives once, and the walk takes them from
// that lane by a shuffle, so the transcendental work per (b, t, d) is done
// once and not by all 16 lanes; B_t and C_t of the group (one row per step,
// shared by the CTA through L1) are loaded before the group's arithmetic,
// so each thread keeps 32 loads in flight across the dependent recurrence.
//
// Forward (selective_scan_fwd_kernel): writes y only; nothing of shape
// [B, L, D, N] leaves the registers. Lane k of a half-warp keeps step
// t0 + k's <C, h> and writes its y after the group.
//
// Backward (selective_scan_bwd_kernel), given dy:
//   g_t   = dy_t * silu(z_t)            gradient reaching <C_t,h_t> + D u_t
//   dz_t  = dy_t * (<C_t,h_t> + D u_t) * silu'(z_t)
//   dh_t  = g_t * C_t + exp(dt_{t+1} A) * dh_{t+1}      (reverse recurrence)
//   dC_t += g_t * h_t        dB_t += dh_t * dt_t * u_t     (summed over d)
//   du_t  = g_t * D + sum_n dh_t * dt_t * B_t
//   ddt_t = sum_n dh_t * (h_{t-1} * A * exp(dt_t A) + u_t * B_t)
//   dA   += dh_t * h_{t-1} * dt_t * exp(dt_t A)           (summed over b, t)
//   ddelta_t = ddt_t * sigmoid(delta_t + bias); dbias, dD summed over b, t.
// The thread first walks forward and stores its state at the start of every
// segment of SEG = 16 steps (chk, [B, n_seg, D, N]: 1/16 of the full state
// history; 51.5 MB at PCM's stage-0 shape, 32 x 524 x 768, against 824 MB
// for every h_t). It then takes the segments last to first: recomputes the
// segment's states and decays into registers from its checkpoint and walks
// it in reverse; lane k keeps step t0 + k's sums over n and writes its
// du, ddelta, dz after the segment. dB and dC, sums over d, are reduced
// across the two half-warps of a warp by a shuffle and across the CTA's
// eight warps through a shared buffer per segment (plain stores and one
// summing pass, no atomics), and written as one partial per CTA
// ([B, L, D/16, N]); dA, dD and dbias are summed over t in registers and
// written as one partial per batch row. The wrapper (ops/scan.py:scan_bwd)
// sums the partials.
//
// What bounds it on the H100: the function moves u, delta, z, y (forward)
// or u, delta, z, dy, du, ddelta, dz (backward) of B*L*D floats each, and
// takes B*L*D*N exponentials. At Mamba3D's shape (32 x 129 x 768) that is
// ~51 MB forward (15 us at 3.35 TB/s) and 50.7 M exps (12 us on the SFUs).
// The kernel as written is bound by its sequential walk's latency and by
// the per-lane exponential of every (b, t, d, n); making it fast (chunked
// scans over t, bf16 inputs) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int N = 16;        // state lanes per (b, d): a half-warp
constexpr int DBLK = 16;     // channels per CTA
constexpr int THREADS = N * DBLK;
constexpr int WARPS = THREADS / 32;
constexpr int SEG = 16;      // steps per group: one per lane of a half-warp
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// step k's value held by lane k of this half-warp
__device__ __forceinline__ float from_lane(float v, int k) {
  return __shfl_sync(FULL, v, k, N);
}

// jax.nn.softplus: logaddexp(x, 0)
__device__ __forceinline__ float softplus_f(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.f / (1.f + expf(-x));
}

struct Ctx {
  int n, d;
  size_t row;  // offset of (b, t = 0, d) in [B, L, D]
  size_t bn;   // offset of (b, t = 0, n) in [B, L, N]
};

__device__ __forceinline__ Ctx ctx_of(int L, int D) {
  Ctx c;
  c.n = threadIdx.x & (N - 1);
  c.d = blockIdx.x * DBLK + (threadIdx.x >> 4);
  c.row = (size_t)blockIdx.y * L * D + c.d;
  c.bn = (size_t)blockIdx.y * L * N + c.n;
  return c;
}

// The per-(b, t, d) scalars of step t0 + n, which lane n of each half-warp
// computes once for the group (instead of all 16 lanes at every step).
struct Own {
  bool on;      // t0 + n < L
  size_t i;     // its offset in [B, L, D]
  float u, x, dt, gate;  // x = delta + bias; gate = silu(z), or 1
};

__device__ __forceinline__ Own own_of(const Ctx& c, int t0, int L, int D,
                                      const float* __restrict__ u,
                                      const float* __restrict__ delta,
                                      const float* __restrict__ z, float bb,
                                      int softplus) {
  Own o;
  const int t = t0 + c.n;
  o.on = t < L;
  o.i = c.row + (size_t)t * D;
  o.u = 0.f;
  o.x = 0.f;
  o.gate = 1.f;
  if (o.on) {
    o.u = u[o.i];
    o.x = delta[o.i] + bb;
    if (z) {
      const float zt = z[o.i];
      o.gate = zt * sigmoid_f(zt);
    }
  }
  o.dt = softplus ? softplus_f(o.x) : o.x;
  return o;
}

__global__ void __launch_bounds__(THREADS)
selective_scan_fwd_kernel(const float* __restrict__ u,
                          const float* __restrict__ delta,
                          const float* __restrict__ A,
                          const float* __restrict__ Bm,
                          const float* __restrict__ Cm,
                          const float* __restrict__ Dv,
                          const float* __restrict__ z,
                          const float* __restrict__ bias,
                          float* __restrict__ y, int L, int D, int softplus) {
  const Ctx c = ctx_of(L, D);
  const float a = A[(size_t)c.d * N + c.n];
  const float dskip = Dv ? Dv[c.d] : 0.f;
  const float bb = bias ? bias[c.d] : 0.f;
  float h = 0.f;
  for (int t0 = 0; t0 < L; t0 += SEG) {
    const Own o = own_of(c, t0, L, D, u, delta, z, bb, softplus);
    const float dtu = o.dt * o.u;
    float bv[SEG], cv[SEG];
#pragma unroll
    for (int k = 0; k < SEG; ++k) {
      const bool in = t0 + k < L;
      bv[k] = in ? Bm[c.bn + (size_t)(t0 + k) * N] : 0.f;
      cv[k] = in ? Cm[c.bn + (size_t)(t0 + k) * N] : 0.f;
    }
    float s_own = 0.f;
#pragma unroll
    for (int k = 0; k < SEG; ++k) {
      if (t0 + k < L) {  // uniform over the CTA: the shuffles are safe
        h = expf(from_lane(o.dt, k) * a) * h + from_lane(dtu, k) * bv[k];
        const float s = half_warp_sum(cv[k] * h);
        if (c.n == k) s_own = s;
      }
    }
    if (o.on) y[o.i] = (s_own + dskip * o.u) * o.gate;
  }
}

__global__ void __launch_bounds__(THREADS)
selective_scan_bwd_kernel(const float* __restrict__ u,
                          const float* __restrict__ delta,
                          const float* __restrict__ A,
                          const float* __restrict__ Bm,
                          const float* __restrict__ Cm,
                          const float* __restrict__ Dv,
                          const float* __restrict__ z,
                          const float* __restrict__ bias,
                          const float* __restrict__ dy,
                          float* __restrict__ du, float* __restrict__ ddelta,
                          float* __restrict__ dz,
                          float* __restrict__ dA_part,
                          float* __restrict__ dB_part,
                          float* __restrict__ dC_part,
                          float* __restrict__ dD_part,
                          float* __restrict__ dbias_part,
                          float* __restrict__ chk, int L, int D,
                          int softplus) {
  __shared__ float sB[SEG][WARPS][N];
  __shared__ float sC[SEG][WARPS][N];
  const Ctx c = ctx_of(L, D);
  const int warp = threadIdx.x >> 5;
  const int upper = threadIdx.x & 16;  // the warp's second half-warp
  const float a = A[(size_t)c.d * N + c.n];
  const float dskip = Dv ? Dv[c.d] : 0.f;
  const float bb = bias ? bias[c.d] : 0.f;
  const int n_seg = (L + SEG - 1) / SEG;
  const int nblk = D / DBLK;
  // chk[b, s, d, n]: the state before segment s
  float* my_chk =
      chk + (((size_t)blockIdx.y * n_seg) * D + c.d) * N + c.n;

  // 1. forward walk: checkpoints
  float h = 0.f;
  for (int s = 0; s < n_seg; ++s) {
    const int t0 = s * SEG;
    my_chk[(size_t)s * D * N] = h;
    const Own o = own_of(c, t0, L, D, u, delta, z, bb, softplus);
    const float dtu = o.dt * o.u;
#pragma unroll
    for (int k = 0; k < SEG; ++k) {
      if (t0 + k < L) {
        const float bk = Bm[c.bn + (size_t)(t0 + k) * N];
        h = expf(from_lane(o.dt, k) * a) * h + from_lane(dtu, k) * bk;
      }
    }
  }

  // 2. reverse walk, segment by segment
  float dh_next = 0.f;  // exp(dt_{t+1} A) * dh_{t+1}
  float dA_acc = 0.f, dD_acc = 0.f, dbias_acc = 0.f;
  for (int s = n_seg - 1; s >= 0; --s) {
    const int t0 = s * SEG;
    const Own o = own_of(c, t0, L, D, u, delta, z, bb, softplus);
    const float dtu = o.dt * o.u;
    const float g_out = o.on ? dy[o.i] : 0.f;
    const float g = g_out * o.gate;  // gradient reaching <C, h> + D u
    float hs[SEG], eas[SEG], bs[SEG], cs[SEG];
    float hp = my_chk[(size_t)s * D * N];
    const float h_start = hp;
#pragma unroll
    for (int k = 0; k < SEG; ++k) {
      const bool in = t0 + k < L;
      bs[k] = in ? Bm[c.bn + (size_t)(t0 + k) * N] : 0.f;
      cs[k] = in ? Cm[c.bn + (size_t)(t0 + k) * N] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < SEG; ++k) {
      eas[k] = 1.f;
      if (t0 + k < L) {
        eas[k] = expf(from_lane(o.dt, k) * a);
        hp = eas[k] * hp + from_lane(dtu, k) * bs[k];
      }
      hs[k] = hp;
    }
    float s_own = 0.f, ddt_own = 0.f, dus_own = 0.f;
#pragma unroll
    for (int k = SEG - 1; k >= 0; --k) {
      float pb = 0.f, pc = 0.f;
      if (t0 + k < L) {  // uniform over the CTA
        const float dt = from_lane(o.dt, k);
        const float uk = from_lane(o.u, k);
        const float gk = from_lane(g, k);
        const float ht = hs[k];
        const float hprev = k > 0 ? hs[k - 1] : h_start;
        const float dh = gk * cs[k] + dh_next;
        const float ddA = dh * hprev;  // d exp(dt A)
        dA_acc += ddA * dt * eas[k];
        pc = gk * ht;
        pb = dh * dt * uk;
        const float ddt = half_warp_sum(ddA * a * eas[k] + dh * uk * bs[k]);
        const float dus = half_warp_sum(dh * dt * bs[k]);
        float sc = 0.f;
        if (z) sc = half_warp_sum(cs[k] * ht);
        dh_next = eas[k] * dh;
        if (c.n == k) {
          s_own = sc;
          ddt_own = ddt;
          dus_own = dus;
        }
      }
      // combine the warp's two half-warps (two channels), then stage
      pb += __shfl_xor_sync(FULL, pb, 16);
      pc += __shfl_xor_sync(FULL, pc, 16);
      if (!upper) {
        sB[k][warp][c.n] = pb;
        sC[k][warp][c.n] = pc;
      }
    }
    if (o.on) {  // lane n: step t0 + n's per-channel gradients
      if (z) {
        const float zt = z[o.i];
        const float sg = sigmoid_f(zt);
        const float dsilu = sg * (1.f + zt * (1.f - sg));
        dz[o.i] = g_out * (s_own + dskip * o.u) * dsilu;
      }
      const float dd = softplus ? ddt_own * sigmoid_f(o.x) : ddt_own;
      du[o.i] = dus_own + g * dskip;
      ddelta[o.i] = dd;
      dD_acc += g * o.u;
      dbias_acc += dd;
    }
    __syncthreads();
    {  // one (step, n) per thread: sum the CTA's eight warps
      const int k = threadIdx.x >> 4, n = threadIdx.x & (N - 1);
      const int t = t0 + k;
      if (t < L) {
        float sb = 0.f, sc = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
          sb += sB[k][w][n];
          sc += sC[k][w][n];
        }
        const size_t off =
            (((size_t)blockIdx.y * L + t) * nblk + blockIdx.x) * N + n;
        dB_part[off] = sb;
        dC_part[off] = sc;
      }
    }
    __syncthreads();
  }
  dA_part[((size_t)blockIdx.y * D + c.d) * N + c.n] = dA_acc;
  dD_acc = half_warp_sum(dD_acc);
  dbias_acc = half_warp_sum(dbias_acc);
  if (c.n == 0) {
    dD_part[(size_t)blockIdx.y * D + c.d] = dD_acc;
    dbias_part[(size_t)blockIdx.y * D + c.d] = dbias_acc;
  }
}

bool shape_ok(int Bsz, int L, int D) {
  return Bsz > 0 && Bsz <= 65535 && L > 0 && D > 0 && D % DBLK == 0;
}

}  // namespace

extern "C" {

// y [B, L, D]; D, z, bias may be null. Returns cudaGetLastError() after the
// launch.
int selective_scan_fwd(const float* u, const float* delta, const float* A,
                       const float* Bm, const float* Cm, const float* Dv,
                       const float* z, const float* bias, float* y, int Bsz,
                       int L, int D, int softplus, void* stream) {
  if (!shape_ok(Bsz, L, D)) return (int)cudaErrorInvalidValue;
  const dim3 grid(D / DBLK, Bsz);
  selective_scan_fwd_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      u, delta, A, Bm, Cm, Dv, z, bias, y, L, D, softplus);
  return (int)cudaGetLastError();
}

// du, ddelta, dz [B, L, D] (dz null iff z is); dA_part [B, D, N];
// dB_part, dC_part [B, L, D/16, N]; dD_part, dbias_part [B, D];
// chk [B, ceil(L/16), D, N] scratch.
int selective_scan_bwd(const float* u, const float* delta, const float* A,
                       const float* Bm, const float* Cm, const float* Dv,
                       const float* z, const float* bias, const float* dy,
                       float* du, float* ddelta, float* dz, float* dA_part,
                       float* dB_part, float* dC_part, float* dD_part,
                       float* dbias_part, float* chk, int Bsz, int L, int D,
                       int softplus, void* stream) {
  if (!shape_ok(Bsz, L, D)) return (int)cudaErrorInvalidValue;
  const dim3 grid(D / DBLK, Bsz);
  selective_scan_bwd_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      u, delta, A, Bm, Cm, Dv, z, bias, dy, du, ddelta, dz, dA_part, dB_part,
      dC_part, dD_part, dbias_part, chk, L, D, softplus);
  return (int)cudaGetLastError();
}

}  // extern "C"
