// Batched dense Gaussian splat: forward and analytic backward (sm_90a).
//
// Replaces the TPU kernels of unipre3d_tpu/ops/rasterizer/pallas_splat_dense.py:
//   dense_fwd_kernel <- _dense_fwd_kernel (called from _dense_fwd_impl)
//   dense_bwd_kernel <- _dense_bwd_kernel (called from _dense_bwd)
//
// Input is the per-render depth-sorted packed table data [R, 16, n_pad]
// (rows 0-8: mean x, mean y, conic A, B, C, opacity, r, g, b; padding
// columns have opacity 0). Every pixel composites every gaussian of its
// render front to back (dense: no per-tile culling), with the JAX kernel's
// semantics, not those of the CUDA 3DGS reference:
//   * a pair is skipped at power > 1e-4 or alpha < 1/255; alpha <= 0.99;
//   * a gaussian contributes iff T after it stays >= 1e-4; T is kept in log
//     space (prefix of log(1 - alpha)) and freezes at the stop;
//   * the table is walked in chunks of chunk_n (= min(n_pad, 512)) columns
//     and the frozen log T is carried from one chunk to the next: a pixel
//     that stopped inside one chunk starts the next chunk from its frozen T
//     and may take small-alpha gaussians there again (the JAX kernel's
//     chunk carry, pallas_splat_dense.py:187-189, 214);
//   * backward: the gradient flows through alpha only where the pair is not
//     skipped and alpha < 0.99, and 1 - alpha is clamped at 1e-6.
// The EWA power is evaluated from dx, dy directly; the TPU kernel expands
// it as a degree-2 polynomial only to put it on the MXU.
//
// Launch: one CTA of 256 threads per (16x16 pixel tile, render), one thread
// per pixel. Each CTA stages one chunk of the table (rows 0-8, at most 512
// columns = 18 KB) in shared memory at a time; every thread walks it front
// to back and leaves the chunk at its stop.
//
// What bounds it on the H100: per live (pixel, gaussian) pair the forward
// does about 22 FP32 operations and three transcendentals (exp of the
// power, log(1 - alpha), exp of the prefix), the backward about twice that;
// bytes are small (the table is read once per CTA from L2, each pixel's
// outputs written once). So both kernels are bound by the issue rate of the
// FP32 pipes and the SFU, not by memory; the early stop bounds the walk by
// the depth at which each pixel saturates. The design keeps the table in
// shared memory (broadcast reads, no bank conflicts: all threads of a warp
// read the same column), uses no per-pair global traffic, and stops each
// pixel as soon as it saturates.
//
// Backward reduction: the TPU accumulates per-gaussian rows across pixel
// blocks in a revisited output block on its sequential grid, which a GPU
// does not have. Here each warp reduces its 32 pixels' nine gradient terms
// per gaussian with shuffles (skipped when no lane of the warp touched the
// gaussian), lane 0 adds the sums into a [9, chunk] shared accumulator, and
// at the end of the chunk the CTA adds each non-zero accumulator to
// dgrad [R, 16, n_pad] with one global atomicAdd. Atomic order changes
// from run to run, so gradients agree with the plain version to float
// rounding of the sum order, not bit for bit.
//
// Backward suffix: instead of the TPU kernel's back-to-front walk with a
// suffix carry, each thread walks front to back with the same arithmetic as
// the forward (so it reproduces the forward's stop decisions exactly) and
// forms the suffix term as total - inclusive prefix, where the total
// sum_j w_j (g . c_j) + T_final (g . bg) equals g . out, the cotangent dotted
// with the forward's output. One pass, no per-chunk scratch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 16;
constexpr int TILE = 16;
constexpr int THREADS = TILE * TILE;
constexpr int MAX_CHUNK = 512;
constexpr float ALPHA_MIN = (float)(1.0 / 255.0);
constexpr float ALPHA_MAX = 0.99f;
constexpr float POWER_SKIP = 1e-4f;
constexpr float LOG_T_EPS = -9.210340371976184f;  // log(1e-4)
constexpr unsigned FULL = 0xffffffffu;

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

__device__ __forceinline__ void stage_chunk(float (*tab)[MAX_CHUNK],
                                            const float* __restrict__ g,
                                            int n_pad, int c0, int chunk_n) {
  for (int k = threadIdx.x; k < 9 * chunk_n; k += THREADS) {
    const int row = k / chunk_n, col = k - row * chunk_n;
    tab[row][col] = g[(size_t)row * n_pad + c0 + col];
  }
}

__global__ void __launch_bounds__(THREADS)
dense_fwd_kernel(const float* __restrict__ data, const float* __restrict__ bg,
                 float* __restrict__ out, float* __restrict__ tfin,
                 int n_pad, int chunk_n, int H, int W, int tiles_x) {
  __shared__ float tab[9][MAX_CHUNK];
  const int r = blockIdx.y;
  const int x = (blockIdx.x % tiles_x) * TILE + (int)(threadIdx.x % TILE);
  const int y = (blockIdx.x / tiles_x) * TILE + (int)(threadIdx.x / TILE);
  const bool inside = x < W && y < H;
  const float px = (float)x, py = (float)y;
  const float* g = data + (size_t)r * ROWS * n_pad;

  float cr = 0.f, cg = 0.f, cb = 0.f;
  float log_t = 0.f;  // frozen log T, carried across chunks
  for (int c0 = 0; c0 < n_pad; c0 += chunk_n) {
    __syncthreads();
    stage_chunk(tab, g, n_pad, c0, chunk_n);
    __syncthreads();
    if (!inside) continue;
    float pe = log_t;  // log T before the next gaussian of this chunk
    for (int i = 0; i < chunk_n; ++i) {
      const float dx = tab[0][i] - px, dy = tab[1][i] - py;
      const float power = ewa_power(tab[2][i], tab[3][i], tab[4][i], dx, dy);
      const float a = fminf(ALPHA_MAX, tab[5][i] * expf(power));
      if (power > POWER_SKIP || a < ALPHA_MIN) continue;  // alpha 0: no-op
      const float incl = pe + logf(1.f - a);
      if (incl < LOG_T_EPS) break;  // stopped for the rest of this chunk
      const float w = a * expf(pe);
      cr += w * tab[6][i];
      cg += w * tab[7][i];
      cb += w * tab[8][i];
      pe = incl;
      log_t = incl;
    }
  }
  if (inside) {
    const float t = expf(log_t);
    const size_t hw = (size_t)H * W, p = (size_t)y * W + x;
    float* o = out + (size_t)r * 3 * hw + p;
    o[0] = cr + bg[0] * t;
    o[hw] = cg + bg[1] * t;
    o[2 * hw] = cb + bg[2] * t;
    tfin[(size_t)r * hw + p] = t;
  }
}

__global__ void __launch_bounds__(THREADS)
dense_bwd_kernel(const float* __restrict__ data, const float* __restrict__ out,
                 const float* __restrict__ gout, float* __restrict__ dgrad,
                 int n_pad, int chunk_n, int H, int W, int tiles_x) {
  __shared__ float tab[9][MAX_CHUNK];
  __shared__ float acc[9][MAX_CHUNK];
  const int r = blockIdx.y;
  const int x = (blockIdx.x % tiles_x) * TILE + (int)(threadIdx.x % TILE);
  const int y = (blockIdx.x / tiles_x) * TILE + (int)(threadIdx.x / TILE);
  const bool inside = x < W && y < H;
  const float px = (float)x, py = (float)y;
  const int lane = threadIdx.x & 31;
  const float* g = data + (size_t)r * ROWS * n_pad;
  float* dg = dgrad + (size_t)r * ROWS * n_pad;

  float g0 = 0.f, g1 = 0.f, g2 = 0.f, total = 0.f;
  if (inside) {
    const size_t hw = (size_t)H * W, p = (size_t)y * W + x;
    const float* go = gout + (size_t)r * 3 * hw + p;
    const float* o = out + (size_t)r * 3 * hw + p;
    g0 = go[0];
    g1 = go[hw];
    g2 = go[2 * hw];
    // suffix + background share of dL/dalpha: g . out minus the prefix
    total = g0 * o[0] + g1 * o[hw] + g2 * o[2 * hw];
  }

  float log_t = 0.f, u_incl = 0.f;
  for (int c0 = 0; c0 < n_pad; c0 += chunk_n) {
    __syncthreads();
    stage_chunk(tab, g, n_pad, c0, chunk_n);
    for (int k = threadIdx.x; k < 9 * chunk_n; k += THREADS)
      acc[k / chunk_n][k % chunk_n] = 0.f;
    __syncthreads();
    float pe = log_t;
    bool active = inside;  // every pixel re-enters each chunk (chunk carry)
    for (int i = 0; i < chunk_n; ++i) {
      if (!__any_sync(FULL, active)) break;  // warp-uniform
      float v[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) v[k] = 0.f;
      bool touched = false;
      if (active) {
        const float gx = tab[0][i], gy = tab[1][i];
        const float A = tab[2][i], B = tab[3][i], C = tab[4][i];
        const float dx = gx - px, dy = gy - py;
        const float power = ewa_power(A, B, C, dx, dy);
        const float e = expf(power);
        const float a = fminf(ALPHA_MAX, tab[5][i] * e);
        if (!(power > POWER_SKIP || a < ALPHA_MIN)) {
          const float incl = pe + logf(1.f - a);
          if (incl < LOG_T_EPS) {
            active = false;
          } else {
            const float t_before = expf(pe);
            const float w = a * t_before;
            const float cgv = g0 * tab[6][i] + g1 * tab[7][i] + g2 * tab[8][i];
            u_incl += w * cgv;
            const float dalpha =
                cgv * t_before - (total - u_incl) / fmaxf(1.f - a, 1e-6f);
            v[6] = g0 * w;
            v[7] = g1 * w;
            v[8] = g2 * w;
            if (a < ALPHA_MAX) {
              const float dpow = dalpha * a;
              v[0] = -dpow * (A * dx + B * dy);
              v[1] = -dpow * (C * dy + B * dx);
              v[2] = -0.5f * dpow * dx * dx;
              v[3] = -dpow * dx * dy;
              v[4] = -0.5f * dpow * dy * dy;
              v[5] = dalpha * e;
            }
            touched = true;
            pe = incl;
            log_t = incl;
          }
        }
      }
      if (__any_sync(FULL, touched)) {  // warp-uniform
#pragma unroll
        for (int k = 0; k < 9; ++k) {
          float s = v[k];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            s += __shfl_down_sync(FULL, s, off);
          if (lane == 0 && s != 0.f) atomicAdd(&acc[k][i], s);
        }
      }
    }
    __syncthreads();
    for (int k = threadIdx.x; k < 9 * chunk_n; k += THREADS) {
      const int row = k / chunk_n, col = k - row * chunk_n;
      const float s = acc[row][col];
      if (s != 0.f) atomicAdd(&dg[(size_t)row * n_pad + c0 + col], s);
    }
  }
}

// renders ride on gridDim.y (at most 65535); chunks must tile the table
inline bool shape_ok(int R, int n_pad, int chunk_n, int H, int W) {
  return R > 0 && R <= 65535 && H > 0 && W > 0 && chunk_n > 0 &&
         chunk_n <= MAX_CHUNK && n_pad % chunk_n == 0;
}

inline dim3 grid_of(int R, int H, int W, int* tiles_x) {
  *tiles_x = (W + TILE - 1) / TILE;
  return dim3((unsigned)(*tiles_x * ((H + TILE - 1) / TILE)), (unsigned)R);
}

}  // namespace

extern "C" {

// out [R, 3, H*W], tfin [R, 1, H*W]; returns cudaGetLastError() after launch.
int dense_splat_fwd(const float* data, const float* bg, float* out,
                    float* tfin, int R, int n_pad, int chunk_n, int H, int W,
                    void* stream) {
  if (!shape_ok(R, n_pad, chunk_n, H, W)) return (int)cudaErrorInvalidValue;
  int tiles_x;
  const dim3 grid = grid_of(R, H, W, &tiles_x);
  dense_fwd_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      data, bg, out, tfin, n_pad, chunk_n, H, W, tiles_x);
  return (int)cudaGetLastError();
}

// dgrad [R, 16, n_pad] must be zeroed by the caller (rows 0-8 are added).
int dense_splat_bwd(const float* data, const float* out, const float* gout,
                    float* dgrad, int R, int n_pad, int chunk_n, int H, int W,
                    void* stream) {
  if (!shape_ok(R, n_pad, chunk_n, H, W)) return (int)cudaErrorInvalidValue;
  int tiles_x;
  const dim3 grid = grid_of(R, H, W, &tiles_x);
  dense_bwd_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      data, out, gout, dgrad, n_pad, chunk_n, H, W, tiles_x);
  return (int)cudaGetLastError();
}

}  // extern "C"
