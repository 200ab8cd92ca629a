// Selective state-space scan (S6 / Mamba): forward and analytic backward
// (sm_90a).
//
// Replaces unipre3d_tpu/ops/scan.py:36 selective_scan, which the JAX package
// writes as a chunked jax.lax.associative_scan (its TPU-shaped stand-in for
// the reference's sequential CUDA selective_scan_fn). The function, in
// float32, channel-last [B, L, D] with N = 16 state lanes a channel:
//
//   dt_t = softplus(delta_t + bias)            (bias, softplus optional)
//   h_t  = exp(dt_t * A) * h_{t-1} + dt_t * B_t * u_t
//   y_t  = (<C_t, h_t> + D * u_t) * silu(z_t)  (D, the gate optional)
//
// Operands. u, delta, z (and dy) [B, L, D] and B, C [B, L, N] are each read
// in place as float32 or bfloat16, with their own batch and time strides
// (the last dimension contiguous), and converted to float32 in registers,
// as JAX's astype(float32) does: the mixer's bf16 projections and its
// strided views of x_proj's and in_proj's outputs need no copy. The
// gradients du, ddelta, dz, dB, dC are written contiguous in the dtype of
// their input (__float2bfloat16_rn rounds as .to(torch.bfloat16) does);
// y, dA, dD, dbias are float32. The dtype is a flag read at run time, not
// a template parameter: one instantiation, a build of seconds.
//
// Design. The walk over t is sequential within a thread; the parallelism is
// over (b, d) and over the 16 states of a channel, split between a few
// threads that each keep theirs in registers: no shuffle per state lane and
// step. exp(dt a) is one ex2.approx of dt * (a log2 e), the factor computed
// once a thread; its relative error (~2^-22) is far inside the tolerances
// held (1e-5 forward, 1e-4 per gradient). The softplus, gate and their
// derivatives are computed once per (b, t, d), a block of steps at a time
// (independent work, not in the walk's chain). Operands are loaded raw a
// block of steps ahead, every address clamped into the tensor (masked when
// converted), so that a whole block of loads is in flight at once.
//
// Forward (selective_scan_fwd_kernel): FT = 2 threads a channel, 8 states
// each; a CTA of 128 threads walks 64 channels of one batch row in tiles of
// TILE = 16 steps. The next tile's operands are loaded into registers while
// the current one is walked, then converted with their softplus and gate
// into a double-buffered shared tile (one barrier a tile); B_t and C_t are
// broadcast float4 reads of that tile. <C_t, h_t> is a register sum and one
// shuffle. When the caller will take the gradient it also writes the state
// before every SEG = 8 steps (chk [B, ceil(L/8), D, N]: 8 bytes a (b, t, d),
// and no exponential; 26.7 MB at Mamba3D's shape, 32 x 129 x 768, 103.8 MB
// at PCM's stage 0, 32 x 524 x 768).
//
// Backward (selective_scan_bwd_kernel), given dy:
//   g_t   = dy_t * silu(z_t)            gradient reaching <C_t,h_t> + D u_t
//   dz_t  = dy_t * (<C_t,h_t> + D u_t) * silu'(z_t)
//   dh_t  = g_t * C_t + exp(dt_{t+1} A) * dh_{t+1}      (reverse recurrence)
//   q_t   = dh_t * h_{t-1} * exp(dt_t A)                 per state lane
//   dC_t += g_t * h_t        dB_t += dh_t * dt_t * u_t     (summed over d)
//   X_t   = sum_n dh_t B_t   Y_t = sum_n A q_t
//   du_t  = g_t * D + dt_t * X_t        ddt_t = Y_t + u_t * X_t
//   dA   += q_t * dt_t                                  (summed over b, t)
//   ddelta_t = ddt_t * sigmoid(delta_t + bias); dbias, dD summed over b, t.
// BT = 2 threads a channel, 8 states each; a CTA of 128 threads, 64
// channels. The segments of SEG steps go last to first. A segment's
// per-step scalars (dt, dt u, g) and its sums over the thread's states (X,
// Y, <C, h>) stay in registers; the loop over states is outside: for each
// state the thread recomputes the segment's states from the forward's chk
// (one exponential a lane-step, the decays kept), then walks dh back
// through it, carrying e * dh into the segment before through shared
// memory. dB_t[n] and dC_t[n] are summed over the warp's 16 channels by a
// transpose-reduce (recursive halving: 15 shuffles for 16 sums, two a
// lane-step), over the CTA's warps in shared memory, and written as one
// partial a CTA ([B, L, nblk, 2N]); X, Y, <C, h> over the channel's two
// threads by one exchange a step. dA, dD, dbias are summed over t and
// written a partial per batch row. A second small kernel
// (selective_scan_reduce_kernel) sums the partials in a fixed order and
// writes dB, dC (in their inputs' dtype), dA, dD, dbias: no float atomics,
// so two runs give the same bits.
//
// What bounds it on the H100: the function moves u, delta, z, y (forward)
// or u, delta, z, dy, du, ddelta, dz (backward) once each, B and C, and
// takes B*L*D*N exponentials; at Mamba3D's shape 50.7 M exponentials are
// 12 us on the SFUs, and float32 operands 15 us (forward) or 27 us
// (backward) at 3.35 TB/s. What holds the kernels above that is the walk's
// latency: there are B*D*FT/32 = 1,536 forward warps at Mamba3D's shape
// (11.6 an SM), each walking 129 dependent steps: a batch of 2 (one CTA on
// each of 24 SMs) takes 61-63% of the batch of 32's time, and replacing
// every special-function op saves only 10-13% (tools/time_scan_kernels.py
// --batch, PERF.md). Splitting the time axis over warps (a chunked scan)
// is the next lever.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int N = 16;          // state lanes a channel
constexpr int SEG = 8;         // the states kept every SEG steps; a backward segment
constexpr int TILE = 16;       // forward: steps a tile
// forward: FT threads a channel, FNS states each, CTAs of FTHREADS
constexpr int FT = 2, FNS = N / FT, FTHREADS = 128, FCH = FTHREADS / FT;
// backward: BT threads a channel, BNS states each, CTAs of BTHREADS
constexpr int BT = 2, BNS = N / BT, BTHREADS = 128, BCH = BTHREADS / BT;
constexpr int BWARPS = BTHREADS / 32;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

static_assert(TILE % SEG == 0 && TILE % FT == 0 && SEG % BT == 0 &&
                  SEG == 8 && BT == 2 && FNS % 4 == 0,
              "the layouts below assume these sizes");

// One [B, L, W] operand, float32 or bfloat16, with its batch and time
// strides in elements; the last dimension is contiguous. Loads fetch the raw
// bits (a bfloat16 zero-extended) and ``val`` converts them later, so that a
// batch of loads is in flight before any result is used.
struct Operand {
  const void* p;
  long long sb, st;
  int bf16;

  __device__ __forceinline__ long long off(int b, int t, int i) const {
    return b * sb + t * st + i;
  }
  __device__ __forceinline__ uint32_t raw(int b, int t, int i) const {
    const long long o = off(b, t, i);
    return bf16 ? (uint32_t)__ldg(static_cast<const unsigned short*>(p) + o)
                : __ldg(static_cast<const unsigned int*>(p) + o);
  }
  __device__ __forceinline__ float val(uint32_t r) const {
    return __uint_as_float(bf16 ? r << 16 : r);
  }
  // ask L2 for the line holding element (b, t, i)
  __device__ __forceinline__ void prefetch(int b, int t, int i) const {
    const char* a = static_cast<const char*>(p) + off(b, t, i) * (bf16 ? 2 : 4);
    asm volatile("prefetch.global.L2 [%0];" ::"l"(a));
  }
};

__device__ __forceinline__ void store(void* p, size_t i, float v, int bf16) {
  if (bf16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(p)[i] = v;
}

__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// jax.nn.softplus: logaddexp(x, 0)
__device__ __forceinline__ float softplus_f(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.f / (1.f + expf(-x));
}

struct Args {
  Operand u, delta, z, Bm, Cm, dy;  // z.p may be null; dy backward only
  const float* A;     // [D, N]
  const float* Dv;    // [D] or null
  const float* bias;  // [D] or null
  float* y;           // forward: [B, L, D]
  float* chk;         // [B, nseg, D, N]: forward writes (if not null), backward reads
  void* du;           // backward, contiguous [B, L, D] in u's dtype
  void* ddelta;       // in delta's dtype
  void* dz;           // in z's dtype; null iff z is
  float* part;        // [B, L, nblk, 2N]: dB then dC, summed over a CTA's channels
  float* dA_part;     // [B, D, N]
  float* dD_part;     // [B, D]
  float* dbias_part;  // [B, D]
  int L, D, softplus;
};

// A block of STEPS B and C rows of one batch row (2 x STEPS x N values),
// raw: thread tid takes 2 STEPS N / THREADS of them, the first half of B.
// Steps past L read step L - 1 (masked when converted).
template <int THREADS, int STEPS>
__device__ __forceinline__ void load_bc(const Args& p, int b, int t0,
                                        uint32_t (&v)[2 * STEPS * N / THREADS]) {
  constexpr int K = 2 * STEPS * N / THREADS;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int idx = (threadIdx.x + THREADS * j) % (STEPS * N);
    const int t = min(t0 + idx / N, p.L - 1);
    v[j] = (j < K / 2 ? p.Bm : p.Cm).raw(b, t, idx % N);
  }
}

// value j of load_bc's block, 0 past L; its step k and state n
template <int THREADS, int STEPS>
__device__ __forceinline__ float bc_val(const Args& p, int t0, int j,
                                        uint32_t r, int& k, int& n) {
  constexpr int K = 2 * STEPS * N / THREADS;
  const int idx = (threadIdx.x + THREADS * j) % (STEPS * N);
  k = idx / N;
  n = idx % N;
  return t0 + k < p.L ? (j < K / 2 ? p.Bm : p.Cm).val(r) : 0.f;
}

// Forward: FT = 4 threads a channel (b, d), each with FNS = 4 of its states
// in registers (n = 4 sub + j); a CTA walks FCH = 32 channels of one batch
// row in tiles of TILE steps.
__global__ void __launch_bounds__(FTHREADS)
selective_scan_fwd_kernel(const Args p) {
  constexpr int KS = TILE / FT;  // steps of a tile this thread stages
  constexpr int KBC = 2 * TILE * N / FTHREADS;
  // a tile's per-step scalars of each channel, and its B, C rows
  __shared__ float sDt[2][TILE][FCH], sU[2][TILE][FCH], sGate[2][TILE][FCH];
  __shared__ __align__(16) float sBC[2][2][TILE][N];  // [buffer][B, C][k][n]
  const int tid = threadIdx.x, c = tid / FT, sub = tid % FT, b = blockIdx.y;
  const int d = blockIdx.x * FCH + c;
  const bool on = d < p.D;
  const int L = p.L, D = p.D, dc = min(d, D - 1);
  float a2[FNS], h[FNS];
#pragma unroll
  for (int j = 0; j < FNS; ++j) {
    a2[j] = on ? p.A[(size_t)d * N + sub * FNS + j] * LOG2E : 0.f;
    h[j] = 0.f;
  }
  const float dskip = on && p.Dv ? p.Dv[d] : 0.f;
  const float bb = on && p.bias ? p.bias[d] : 0.f;
  const bool gated = p.z.p != nullptr;
  const int ntile = (L + TILE - 1) / TILE, nchk = (L + SEG - 1) / SEG;

  // the next tile's operands, raw: loaded while the current tile is walked
  uint32_t ru[KS], rx[KS], rz[KS], rbc[KBC];
  auto load = [&](int t0) {
#pragma unroll
    for (int i = 0; i < KS; ++i) {
      const int t = min(t0 + sub * KS + i, L - 1);
      ru[i] = p.u.raw(b, t, dc);
      rx[i] = p.delta.raw(b, t, dc);
      rz[i] = gated ? p.z.raw(b, t, dc) : 0u;
    }
    load_bc<FTHREADS, TILE>(p, b, t0, rbc);
  };
  // converted, with each step's softplus and gate, into shared memory: the
  // FT threads of a channel stage KS steps each
  auto stage = [&](int t0, int buf) {
#pragma unroll
    for (int i = 0; i < KS; ++i) {
      const int k = sub * KS + i;
      const bool in = on && t0 + k < L;
      const float x = p.delta.val(rx[i]) + bb;
      float gate = 1.f;
      if (gated) {
        const float zt = p.z.val(rz[i]);
        gate = zt * sigmoid_f(zt);
      }
      sDt[buf][k][c] = in ? (p.softplus ? softplus_f(x) : x) : 0.f;
      sU[buf][k][c] = in ? p.u.val(ru[i]) : 0.f;
      sGate[buf][k][c] = gate;
    }
#pragma unroll
    for (int j = 0; j < KBC; ++j) {
      int k, n;
      const float v = bc_val<FTHREADS, TILE>(p, t0, j, rbc[j], k, n);
      sBC[buf][j < KBC / 2 ? 0 : 1][k][n] = v;
    }
  };
  load(0);
  stage(0, 0);
  __syncthreads();

  for (int s = 0; s < ntile; ++s) {
    const int t0 = s * TILE, buf = s & 1;
    if (s + 1 < ntile) load(t0 + TILE);
    float* yrow = p.y + ((size_t)b * L + t0) * D + d;
    for (int k0 = 0; k0 < TILE && t0 + k0 < L; k0 += SEG) {
      if (p.chk && on) {  // the state before step t0 + k0
        float4* cp = reinterpret_cast<float4*>(
            p.chk + (((size_t)b * nchk + (t0 + k0) / SEG) * D + d) * N +
            sub * FNS);
#pragma unroll
        for (int q = 0; q < FNS / 4; ++q)
          cp[q] = make_float4(h[4 * q], h[4 * q + 1], h[4 * q + 2],
                              h[4 * q + 3]);
      }
      const int k1 = min(k0 + SEG, L - t0);
#pragma unroll 4
      for (int k = k0; k < k1; ++k) {
        const float dt = sDt[buf][k][c], ut = sU[buf][k][c];
        const float dtu = dt * ut;
        float acc = 0.f;
#pragma unroll
        for (int q = 0; q < FNS / 4; ++q) {
          const float4 bv =
              reinterpret_cast<const float4*>(sBC[buf][0][k])[sub * FNS / 4 + q];
          const float4 cv =
              reinterpret_cast<const float4*>(sBC[buf][1][k])[sub * FNS / 4 + q];
          float* hq = h + 4 * q;
          const float* aq = a2 + 4 * q;
          hq[0] = ex2(dt * aq[0]) * hq[0] + dtu * bv.x;
          hq[1] = ex2(dt * aq[1]) * hq[1] + dtu * bv.y;
          hq[2] = ex2(dt * aq[2]) * hq[2] + dtu * bv.z;
          hq[3] = ex2(dt * aq[3]) * hq[3] + dtu * bv.w;
          acc += (cv.x * hq[0] + cv.y * hq[1]) + (cv.z * hq[2] + cv.w * hq[3]);
        }
#pragma unroll
        for (int o = 1; o < FT; o <<= 1) acc += __shfl_xor_sync(FULL, acc, o);
        if (on && sub == 0)
          yrow[(size_t)k * D] = (acc + dskip * ut) * sGate[buf][k][c];
      }
    }
    if (s + 1 < ntile) stage(t0 + TILE, buf ^ 1);
    __syncthreads();
  }
}

// Entry (lane >> 1) of (pb[0..7], g[0..7] * hs[0..7]) summed over the 16
// lanes of the warp with this lane's parity (its channels' thread of the
// same states), returned to the lane: recursive halving, each level sends
// the half the lane does not keep (8 + 4 + 2 + 1 shuffles).
__device__ __forceinline__ float transpose_sum(const float (&pb)[SEG],
                                               const float (&g)[SEG],
                                               const float (&hs)[SEG],
                                               int lane) {
  float w[SEG];
  const bool up = lane & 16;
#pragma unroll
  for (int i = 0; i < SEG; ++i) {
    const float pc = g[i] * hs[i];
    const float keep = up ? pc : pb[i], send = up ? pb[i] : pc;
    w[i] = keep + __shfl_xor_sync(FULL, send, 16);
  }
#pragma unroll
  for (int o = SEG / 2; o > 0; o >>= 1) {
    const bool hi = lane & (2 * o);
#pragma unroll
    for (int i = 0; i < o; ++i) {
      const float keep = hi ? w[i + o] : w[i], send = hi ? w[i] : w[i + o];
      w[i] = keep + __shfl_xor_sync(FULL, send, 2 * o);
    }
  }
  return w[0];
}

// Backward: BT = 2 threads a channel, each with BNS = 8 of its states (n =
// sub + 2 j); a CTA walks BCH = 64 channels of one batch row, in segments of
// SEG steps from last to first.
__global__ void __launch_bounds__(BTHREADS)
selective_scan_bwd_kernel(const Args p) {
  constexpr int KS = SEG / BT;  // steps of a segment this thread stages
  constexpr int KBC = 2 * SEG * N / BTHREADS;
  __shared__ __align__(16) float sB[N][SEG];  // the segment's B, [n][k]
  __shared__ __align__(16) float sC[N][SEG];
  __shared__ float sA[N][BCH];    // each channel's A
  __shared__ float sH0[N][BCH];   // each channel's states before the segment
  __shared__ float sDh[N][BCH];   // e * dh carried into the segment before
  __shared__ float sDA[N][BCH];   // dA summed over the segments walked
  // per step of the segment and channel: dt, dt u, g, u, d softplus / dx,
  // dy silu'(z)
  __shared__ float sDt[SEG][BCH], sDtu[SEG][BCH], sG[SEG][BCH];
  __shared__ float sU[SEG][BCH], sSig[SEG][BCH], sDz[SEG][BCH];
  __shared__ float sRed[BWARPS][2 * SEG][N];  // the warps' dB, dC sums
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = tid / BT, sub = tid % BT;
  const int b = blockIdx.y, nblk = gridDim.x, d0 = blockIdx.x * BCH;
  const int d = d0 + c;
  const bool on = d < p.D;
  const int L = p.L, D = p.D, dc = min(d, D - 1);
  const int nseg = (L + SEG - 1) / SEG;
  const float dskip = on && p.Dv ? p.Dv[d] : 0.f;
  const float bb = on && p.bias ? p.bias[d] : 0.f;
  const bool gated = p.z.p != nullptr;
#pragma unroll
  for (int j = 0; j < BNS; ++j) {
    const int n = sub + BT * j;
    sA[n][c] = on ? p.A[(size_t)d * N + n] : 0.f;
    sDh[n][c] = 0.f;
    sDA[n][c] = 0.f;
  }
  float dD_acc = 0.f, dbias_acc = 0.f;

  for (int s = nseg - 1; s >= 0; --s) {
    const int t0 = s * SEG;
    // the segment's operands, raw, every load in flight before any use;
    // steps past L and channels past D read valid neighbours, masked below
    uint32_t ru[KS], rx[KS], rz[KS], ry[KS], rbc[KBC];
#pragma unroll
    for (int i = 0; i < KS; ++i) {
      const int t = min(t0 + sub * KS + i, L - 1);
      ru[i] = p.u.raw(b, t, dc);
      rx[i] = p.delta.raw(b, t, dc);
      rz[i] = gated ? p.z.raw(b, t, dc) : 0u;
      ry[i] = p.dy.raw(b, t, dc);
    }
    load_bc<BTHREADS, SEG>(p, b, t0, rbc);
    // the CTA's kept states before the segment: BCH x N floats as float4s
    constexpr int KH = BCH * N / 4 / BTHREADS;
    float4 h0v[KH];
#pragma unroll
    for (int q = 0; q < KH; ++q) {
      const int idx = tid + BTHREADS * q, cc = idx / (N / 4);
      h0v[q] = reinterpret_cast<const float4*>(
          p.chk + (((size_t)b * nseg + s) * D + min(d0 + cc, D - 1)) * N)
          [idx % (N / 4)];
    }
    // the segment before, into L2 (4-7% of the backward's time at the
    // main-path shapes, PERF.md)
    if (s > 0 && lane < SEG) {
      const int t = t0 - SEG + lane;
      const int df = min(d0 + warp * 32 / BT, D - 1);  // the warp's channels
      const int dl = min(df + 32 / BT - 1, D - 1);
      p.u.prefetch(b, t, df);
      p.u.prefetch(b, t, dl);
      p.delta.prefetch(b, t, df);
      p.delta.prefetch(b, t, dl);
      p.dy.prefetch(b, t, df);
      p.dy.prefetch(b, t, dl);
      if (gated) {
        p.z.prefetch(b, t, df);
        p.z.prefetch(b, t, dl);
      }
      p.Bm.prefetch(b, t, 0);
      p.Cm.prefetch(b, t, 0);
      if (2 * lane < D - df) {  // the warp's states: two channels a line
        const char* cp = reinterpret_cast<const char*>(
            p.chk + (((size_t)b * nseg + s - 1) * D + df) * N);
        asm volatile("prefetch.global.L2 [%0];" ::"l"(cp + lane * 128));
      }
    }
    // the per-step scalars (each of the channel's BT threads stages KS
    // steps); steps past L and channels past D give dt = 0 (a decay of 1),
    // dt u = 0 and g = 0: they add nothing
#pragma unroll
    for (int i = 0; i < KS; ++i) {
      const int k = sub * KS + i;
      const bool in = on && t0 + k < L;
      const float x = p.delta.val(rx[i]) + bb;
      const float ut = in ? p.u.val(ru[i]) : 0.f;
      const float dyt = in ? p.dy.val(ry[i]) : 0.f;
      float gate = 1.f, dsilu = 0.f;
      if (gated) {
        const float zt = p.z.val(rz[i]);
        const float sg = sigmoid_f(zt);
        gate = zt * sg;
        dsilu = sg * (1.f + zt * (1.f - sg));
      }
      const float dt = in ? (p.softplus ? softplus_f(x) : x) : 0.f;
      sDt[k][c] = dt;
      sDtu[k][c] = dt * ut;
      sG[k][c] = dyt * gate;
      sU[k][c] = ut;
      sSig[k][c] = p.softplus ? sigmoid_f(x) : 1.f;
      sDz[k][c] = dyt * dsilu;
    }
#pragma unroll
    for (int j = 0; j < KBC; ++j) {
      int k, n;
      const float v = bc_val<BTHREADS, SEG>(p, t0, j, rbc[j], k, n);
      (j < KBC / 2 ? sB : sC)[n][k] = v;
    }
#pragma unroll
    for (int q = 0; q < KH; ++q) {
      const int idx = tid + BTHREADS * q, cc = idx / (N / 4);
      const int n = 4 * (idx % (N / 4));
      const bool live = d0 + cc < D;
      sH0[n][cc] = live ? h0v[q].x : 0.f;
      sH0[n + 1][cc] = live ? h0v[q].y : 0.f;
      sH0[n + 2][cc] = live ? h0v[q].z : 0.f;
      sH0[n + 3][cc] = live ? h0v[q].w : 0.f;
    }
    __syncthreads();

    float dt[SEG], dtu[SEG], g[SEG], X[SEG], Y[SEG], sc[SEG];
#pragma unroll
    for (int k = 0; k < SEG; ++k) {
      dt[k] = sDt[k][c];
      dtu[k] = sDtu[k][c];
      g[k] = sG[k][c];
      X[k] = Y[k] = sc[k] = 0.f;
    }
#pragma unroll 1
    for (int j = 0; j < BNS; ++j) {
      const int n = sub + BT * j;
      const float an = sA[n][c];
      const float a2 = an * LOG2E;
      float Bn[SEG], Cn[SEG];
#pragma unroll
      for (int q = 0; q < SEG / 4; ++q) {
        const float4 bv = reinterpret_cast<const float4*>(sB[n])[q];
        const float4 cv = reinterpret_cast<const float4*>(sC[n])[q];
        Bn[4 * q] = bv.x, Bn[4 * q + 1] = bv.y, Bn[4 * q + 2] = bv.z,
        Bn[4 * q + 3] = bv.w;
        Cn[4 * q] = cv.x, Cn[4 * q + 1] = cv.y, Cn[4 * q + 2] = cv.z,
        Cn[4 * q + 3] = cv.w;
      }
      // recompute the segment's states, keeping the decays
      const float h0 = sH0[n][c];
      float e[SEG], hs[SEG];
      float h = h0;
#pragma unroll
      for (int k = 0; k < SEG; ++k) {
        e[k] = ex2(dt[k] * a2);
        h = e[k] * h + dtu[k] * Bn[k];
        hs[k] = h;
        sc[k] += Cn[k] * h;
      }
      // walk dh back through the segment
      float dhn = sDh[n][c], dA_n = 0.f;
      float pb[SEG];
#pragma unroll
      for (int k = SEG - 1; k >= 0; --k) {
        const float dh = g[k] * Cn[k] + dhn;
        const float q = dh * (k > 0 ? hs[k - 1] : h0) * e[k];
        Y[k] += an * q;
        dA_n += dt[k] * q;
        X[k] += dh * Bn[k];
        pb[k] = dh * dtu[k];
        dhn = e[k] * dh;
      }
      sDh[n][c] = dhn;
      sDA[n][c] += dA_n;
      // dB, dC of state n over the warp's 16 channels: lane ends with entry
      // lane >> 1 (dB of step lane >> 1, or dC of step (lane >> 1) - SEG)
      sRed[warp][lane >> 1][n] = transpose_sum(pb, g, hs, lane);
    }

    // X, Y, <C, h> summed over the channel's two threads: thread sub keeps
    // the steps sub * KS .. sub * KS + KS - 1 and writes their gradients
#pragma unroll
    for (int i = 0; i < KS; ++i) {
      const int lo = i, hi = i + KS;
      const float xs = __shfl_xor_sync(FULL, sub ? X[lo] : X[hi], 1);
      const float ys = __shfl_xor_sync(FULL, sub ? Y[lo] : Y[hi], 1);
      const float ss = __shfl_xor_sync(FULL, sub ? sc[lo] : sc[hi], 1);
      const float Xk = (sub ? X[hi] : X[lo]) + xs;
      const float Yk = (sub ? Y[hi] : Y[lo]) + ys;
      const float Sk = (sub ? sc[hi] : sc[lo]) + ss;
      const int k = sub * KS + i, t = t0 + k;
      if (on && t < L) {
        const float ut = sU[k][c], gk = sG[k][c];
        const float dd = (Yk + ut * Xk) * sSig[k][c];
        const size_t o = ((size_t)b * L + t) * D + d;
        store(p.du, o, gk * dskip + sDt[k][c] * Xk, p.u.bf16);
        store(p.ddelta, o, dd, p.delta.bf16);
        if (gated) store(p.dz, o, sDz[k][c] * (Sk + dskip * ut), p.z.bf16);
        dD_acc += gk * ut;
        dbias_acc += dd;
      }
    }
    __syncthreads();
    // dB, dC of the segment summed over the CTA's warps: one partial a CTA
#pragma unroll
    for (int q = 0; q < 2 * SEG * N / BTHREADS; ++q) {
      const int idx = tid + BTHREADS * q;
      const int l = idx / N, n = idx % N;  // l: dB of step l, dC of l - SEG
      const int t = t0 + l % SEG;
      if (t < L) {
        float v = 0.f;
#pragma unroll
        for (int w = 0; w < BWARPS; ++w) v += sRed[w][l][n];
        p.part[(((size_t)b * L + t) * nblk + blockIdx.x) * (2 * N) +
               (l / SEG) * N + n] = v;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < BNS; ++j) {
    const int n = sub + BT * j;
    if (on) p.dA_part[((size_t)b * D + d) * N + n] = sDA[n][c];
  }
  dD_acc += __shfl_xor_sync(FULL, dD_acc, 1);
  dbias_acc += __shfl_xor_sync(FULL, dbias_acc, 1);
  if (on && sub == 0) {
    p.dD_part[(size_t)b * D + d] = dD_acc;
    p.dbias_part[(size_t)b * D + d] = dbias_acc;
  }
}

// Sums the backward's partials in a fixed order: dB, dC over the CTAs of a
// batch row (written in their inputs' dtype), dA, dD, dbias over the batch.
__global__ void selective_scan_reduce_kernel(const Args p, void* dB, void* dC,
                                             float* dA, float* dD,
                                             float* dbias, int Bsz, int nblk) {
  const long long n_bc = (long long)Bsz * p.L * 2 * N;
  const long long n_a = (long long)p.D * N;
  const long long total = n_bc + n_a + 2LL * p.D;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    if (i < n_bc) {
      const long long bt = i / (2 * N);
      const int j = (int)(i % (2 * N));
      const float* src = p.part + bt * nblk * (2 * N) + j;
      float v = 0.f;
      for (int c = 0; c < nblk; ++c) v += src[(size_t)c * 2 * N];
      const bool isC = j >= N;
      store(isC ? dC : dB, bt * N + (j % N), v, isC ? p.Cm.bf16 : p.Bm.bf16);
    } else if (i < n_bc + n_a) {
      const long long r = i - n_bc;
      float v = 0.f;
      for (int b = 0; b < Bsz; ++b) v += p.dA_part[(size_t)b * n_a + r];
      dA[r] = v;
    } else {
      const long long r = i - n_bc - n_a;
      const int dd = (int)(r % p.D);
      const bool is_bias = r >= p.D;
      float* out = is_bias ? dbias : dD;
      if (out) {
        const float* src = is_bias ? p.dbias_part : p.dD_part;
        float v = 0.f;
        for (int b = 0; b < Bsz; ++b) v += src[(size_t)b * p.D + dd];
        out[dd] = v;
      }
    }
  }
}

bool shape_ok(int Bsz, int L, int D) {
  return Bsz > 0 && Bsz <= 65535 && L > 0 && D > 0;
}

// strides: the batch and time strides of u, delta, z, B, C (, dy);
// bf16: bit i set when operand i of that order is bfloat16
Args make_args(const void* u, const void* delta, const float* A,
               const void* Bm, const void* Cm, const float* Dv, const void* z,
               const float* bias, const void* dy, const int* strides,
               int bf16, int L, int D, int softplus) {
  Args a = {};
  const void* ptr[6] = {u, delta, z, Bm, Cm, dy};
  Operand* op[6] = {&a.u, &a.delta, &a.z, &a.Bm, &a.Cm, &a.dy};
  for (int i = 0; i < 6; ++i) {
    op[i]->p = ptr[i];
    op[i]->sb = strides[2 * i];
    op[i]->st = strides[2 * i + 1];
    op[i]->bf16 = (bf16 >> i) & 1;
  }
  a.A = A;
  a.Dv = Dv;
  a.bias = bias;
  a.L = L;
  a.D = D;
  a.softplus = softplus;
  return a;
}

}  // namespace

extern "C" {

// Kernel interface version, read by tools/time_scan_kernels.py (version
// 1, a thread a state lane, had no such function).
int selective_scan_version() { return 2; }

// y [B, L, D] float32; chk [B, ceil(L/8), D, 16] float32 or null (written
// when not null); D, z, bias may be null. strides[10]: batch and time
// strides of u, delta, z, B, C; bf16 bits in that order. Returns
// cudaGetLastError() after the launch.
int selective_scan_fwd(const void* u, const void* delta, const float* A,
                       const void* Bm, const void* Cm, const float* Dv,
                       const void* z, const float* bias, float* y, float* chk,
                       const int* strides, int Bsz, int L, int D,
                       int softplus, int bf16, void* stream) {
  if (!shape_ok(Bsz, L, D)) return (int)cudaErrorInvalidValue;
  int st[12];
  for (int i = 0; i < 10; ++i) st[i] = strides[i];
  st[10] = st[11] = 0;
  Args a = make_args(u, delta, A, Bm, Cm, Dv, z, bias, nullptr, st, bf16, L,
                     D, softplus);
  a.y = y;
  a.chk = chk;
  const dim3 grid((D + FCH - 1) / FCH, Bsz);
  selective_scan_fwd_kernel<<<grid, FTHREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// du, ddelta, dz [B, L, D] contiguous in u's, delta's, z's dtype (dz null
// iff z is); dB, dC [B, L, 16] contiguous in B's, C's dtype; dA [D, 16],
// dD, dbias [D] float32 (null iff D, bias are); chk from the forward;
// work: float32 scratch of B*L*nblk*32 + B*D*16 + 2*B*D floats (nblk =
// ceil(D / 64)).
// strides[12]: batch and time strides of u, delta, z, B, C, dy; bf16 bits
// in that order. Two launches (the walk, the sums of its partials).
int selective_scan_bwd(const void* u, const void* delta, const float* A,
                       const void* Bm, const void* Cm, const float* Dv,
                       const void* z, const float* bias, const void* dy,
                       const float* chk, void* du, void* ddelta, void* dz,
                       float* dA, void* dB, void* dC, float* dD, float* dbias,
                       float* work, const int* strides, int Bsz, int L,
                       int D, int softplus, int bf16, void* stream) {
  if (!shape_ok(Bsz, L, D)) return (int)cudaErrorInvalidValue;
  Args a = make_args(u, delta, A, Bm, Cm, Dv, z, bias, dy, strides, bf16, L,
                     D, softplus);
  const int nblk = (D + BCH - 1) / BCH;
  a.chk = const_cast<float*>(chk);
  a.du = du;
  a.ddelta = ddelta;
  a.dz = dz;
  a.part = work;
  a.dA_part = work + (size_t)Bsz * L * nblk * 2 * N;
  a.dD_part = a.dA_part + (size_t)Bsz * D * N;
  a.dbias_part = a.dD_part + (size_t)Bsz * D;
  const dim3 grid(nblk, Bsz);
  selective_scan_bwd_kernel<<<grid, BTHREADS, 0, (cudaStream_t)stream>>>(a);
  const long long total =
      (long long)Bsz * L * 2 * N + (long long)D * N + 2LL * D;
  const int blocks = (int)((total + 255) / 256 < 132 * 8
                               ? (total + 255) / 256 : 132 * 8);
  selective_scan_reduce_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      a, dB, dC, dA, dD, dbias, Bsz, nblk);
  return (int)cudaGetLastError();
}

}  // extern "C"
