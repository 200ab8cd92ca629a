// Batched dense Gaussian splat: forward and analytic backward (sm_90a).
//
// Replaces the TPU kernels of unipre3d_tpu/ops/rasterizer/pallas_splat_dense.py:
//   dense_fwd_kernel <- _dense_fwd_kernel (called from _dense_fwd_impl)
//   dense_bwd_kernel <- _dense_bwd_kernel (called from _dense_bwd)
//
// Input is the per-render depth-sorted packed table data [R, 16, n_pad]
// (rows 0-8: mean x, mean y, conic A, B, C, opacity, r, g, b; padding
// columns have opacity 0). Every pixel composites the gaussians of its
// render front to back with the JAX kernel's semantics, not those of the
// CUDA 3DGS reference:
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
// per pixel. For each chunk of the table the CTA first culls the chunk's
// columns against its tile (rect_keeps), then walks only the survivors.
//
// What bounds it on the H100: the TPU kernel makes every pixel evaluate
// every gaussian of its render (power, exp and two compares even where the
// pair is skipped); at the object step's shape (128 renders of 128
// gaussians at 128x128) that is 30x more pairs than contribute, and the
// walk was bound by the FP32/SFU issue rate and by one scalar shared load
// per table row per pair. Hence:
//   * per-tile cull: a column survives unless the plain version's own
//     arithmetic skips it at every pixel of the tile, so images and T stay
//     bit-identical; the walk then evaluates ~10 of 128 columns a tile at
//     the object shape;
//   * survivors compacted in depth order (warp ballot + popc prefix, warp
//     offsets through shared memory) into 48-byte records (mx, my, A, B),
//     (C, o, r, g), (b, column): a pair reads two or three broadcast
//     128-bit shared loads instead of six to nine scalar ones;
//   * the per-pair arithmetic is unchanged (ewa_power, expf, logf in the
//     plain version's order), and the colour sums are rounded op by op
//     without FMA contraction as the plain version's products and sums
//     are: T and images equal the plain version's bit for bit. Only values
//     that feed no decision and no image take fast intrinsics: the
//     backward's T before the gaussian (__expf) and its division by
//     max(1 - alpha, 1e-6) (__fdividef), within ~1e-6 of the plain
//     gradients;
//   * __launch_bounds__(256, 4): at most 64 registers (the cull's doubles
//     took 73 unbounded), four CTAs an SM.
// Bytes are small (the table read once per CTA from L2, each pixel's
// outputs written once); what is left is the per-CTA cull, the walk over
// the survivors and, in the backward, the warp reductions.
//
// The cull (rect_keeps in splat_common.cuh, and its plain twin
// tile_survivors_ref in splat_dense.py): a column is dropped only where the
// walk's own float32 arithmetic skips it (alpha < 1/255) at every pixel of
// the tile's rectangle; see the header.
//
// Backward reduction: the TPU accumulates per-gaussian rows across pixel
// blocks in a revisited output block on its sequential grid, which a GPU
// does not have. Here each warp reduces its 32 pixels' nine gradient terms
// per survivor (skipped when no lane of the warp touched it) with a
// reduce-scatter over the lanes (14 shuffles instead of 9 x 5), and nine
// lanes add the nine sums to the survivor's column of dgrad [R, 16, n_pad]
// with one global atomicAdd each (a fire-and-forget RED in L2). A shared
// [9, chunk] accumulator flushed once per CTA, as the first port had,
// costs more on this card: a float atomicAdd to shared memory is a
// compare-and-swap loop (ATOMS.CAST.SPIN), and the nine rows of a column
// sat in one bank. Atomic order changes from run to run, so gradients agree
// with the plain version to float rounding of the sum order, not bit for
// bit.
//
// Backward suffix: instead of the TPU kernel's back-to-front walk with a
// suffix carry, each thread walks front to back with the same arithmetic as
// the forward (so it reproduces the forward's stop decisions exactly) and
// forms the suffix term as total - inclusive prefix, where the total
// sum_j w_j (g . c_j) + T_final (g . bg) equals g . out, the cotangent dotted
// with the forward's output. One pass, no per-chunk scratch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "splat_common.cuh"

namespace {

using namespace splat;

constexpr int ROWS = 16;
constexpr int TILE = 16;
constexpr int THREADS = TILE * TILE;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_CHUNK = 512;
constexpr float POWER_SKIP = 1e-4f;  // the dense kernels' power skip

// Culls columns [c0, c0 + chunk_n) of the render's table g against the
// CTA's tile and writes the survivors, in depth order, to recs[0, n).
// Returns n. Ends with a barrier, so recs are ready; starts writing recs
// only after one, so the previous chunk's readers are done.
__device__ int cull_chunk(Rec* recs, int* warp_n, const float* __restrict__ g,
                          int n_pad, int c0, int chunk_n, double x0,
                          double x1, double y0, double y1) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int total = 0;
  for (int base = 0; base < chunk_n; base += THREADS) {
    const int col = base + (int)threadIdx.x;
    float v[9];
    bool keep = false;
    if (col < chunk_n) {
#pragma unroll
      for (int k = 0; k < 9; ++k) v[k] = g[(size_t)k * n_pad + c0 + col];
      keep = rect_keeps(v[0], v[1], v[2], v[3], v[4], v[5], x0, x1, y0, y1);
    }
    const unsigned ballot = __ballot_sync(FULL, keep);
    if (lane == 0) warp_n[warp] = __popc(ballot);
    __syncthreads();
    int off = total, pass = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int nw = warp_n[w];
      off += w < warp ? nw : 0;
      pass += nw;
    }
    if (keep) {
      Rec& rec = recs[off + __popc(ballot & ((1u << lane) - 1u))];
      rec.p = make_float4(v[0], v[1], v[2], v[3]);
      rec.q = make_float4(v[4], v[5], v[6], v[7]);
      rec.s = make_float4(v[8], __int_as_float(c0 + col), 0.f, 0.f);
    }
    total += pass;
    __syncthreads();
  }
  return total;
}

struct Tile {
  int x, y;               // this thread's pixel
  bool inside;
  double x0, x1, y0, y1;  // the tile's pixel rectangle, clipped to the image
};

__device__ __forceinline__ Tile tile_of(int H, int W, int tiles_x) {
  Tile t;
  const int tx0 = (int)(blockIdx.x % tiles_x) * TILE;
  const int ty0 = (int)(blockIdx.x / tiles_x) * TILE;
  t.x = tx0 + (int)(threadIdx.x % TILE);
  t.y = ty0 + (int)(threadIdx.x / TILE);
  t.inside = t.x < W && t.y < H;
  t.x0 = tx0;
  t.x1 = min(tx0 + TILE, W) - 1;
  t.y0 = ty0;
  t.y1 = min(ty0 + TILE, H) - 1;
  return t;
}

__global__ void __launch_bounds__(THREADS, 4)
dense_fwd_kernel(const float* __restrict__ data, const float* __restrict__ bg,
                 float* __restrict__ out, float* __restrict__ tfin,
                 int n_pad, int chunk_n, int H, int W, int tiles_x) {
  __shared__ Rec recs[MAX_CHUNK];
  __shared__ int warp_n[WARPS];
  const int r = blockIdx.y;
  const Tile t = tile_of(H, W, tiles_x);
  const float px = (float)t.x, py = (float)t.y;
  const float* g = data + (size_t)r * ROWS * n_pad;

  float cr = 0.f, cg = 0.f, cb = 0.f;
  float log_t = 0.f;  // frozen log T, carried across chunks
  for (int c0 = 0; c0 < n_pad; c0 += chunk_n) {
    const int n = cull_chunk(recs, warp_n, g, n_pad, c0, chunk_n, t.x0,
                             t.x1, t.y0, t.y1);
    if (!t.inside) continue;
    float pe = log_t;  // log T before the next gaussian of this chunk
    for (int i = 0; i < n; ++i) {
      const float4 p = recs[i].p, q = recs[i].q;
      const float dx = p.x - px, dy = p.y - py;
      const float power = ewa_power(p.z, p.w, q.x, dx, dy);
      const float a = fminf(ALPHA_MAX, q.y * expf(power));
      if (power > POWER_SKIP || a < ALPHA_MIN) continue;  // alpha 0: no-op
      const float incl = pe + logf(1.f - a);
      if (incl < LOG_T_EPS) break;  // stopped for the rest of this chunk
      const float w = a * expf(pe);
      cr = __fadd_rn(cr, __fmul_rn(w, q.z));
      cg = __fadd_rn(cg, __fmul_rn(w, q.w));
      cb = __fadd_rn(cb, __fmul_rn(w, recs[i].s.x));
      pe = incl;
      log_t = incl;
    }
  }
  if (t.inside) {
    const float tv = expf(log_t);
    const size_t hw = (size_t)H * W, p = (size_t)t.y * W + t.x;
    float* o = out + (size_t)r * 3 * hw + p;
    o[0] = __fadd_rn(cr, __fmul_rn(bg[0], tv));
    o[hw] = __fadd_rn(cg, __fmul_rn(bg[1], tv));
    o[2 * hw] = __fadd_rn(cb, __fmul_rn(bg[2], tv));
    tfin[(size_t)r * hw + p] = tv;
  }
}

__global__ void __launch_bounds__(THREADS, 4)
dense_bwd_kernel(const float* __restrict__ data, const float* __restrict__ out,
                 const float* __restrict__ gout, float* __restrict__ dgrad,
                 int n_pad, int chunk_n, int H, int W, int tiles_x) {
  __shared__ Rec recs[MAX_CHUNK];
  __shared__ int warp_n[WARPS];
  const int r = blockIdx.y;
  const Tile t = tile_of(H, W, tiles_x);
  const float px = (float)t.x, py = (float)t.y;
  const int lane = threadIdx.x & 31;
  const float* g = data + (size_t)r * ROWS * n_pad;
  float* dg = dgrad + (size_t)r * ROWS * n_pad;

  float g0 = 0.f, g1 = 0.f, g2 = 0.f, total = 0.f;
  if (t.inside) {
    const size_t hw = (size_t)H * W, p = (size_t)t.y * W + t.x;
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
    const int n = cull_chunk(recs, warp_n, g, n_pad, c0, chunk_n, t.x0,
                             t.x1, t.y0, t.y1);
    float pe = log_t;
    bool active = t.inside;  // every pixel re-enters each chunk (chunk carry)
    for (int i = 0; i < n; ++i) {
      if (!__any_sync(FULL, active)) break;  // warp-uniform
      float v[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) v[k] = 0.f;
      bool touched = false;
      if (active) {
        const float4 p = recs[i].p, q = recs[i].q;
        const float A = p.z, B = p.w, C = q.x;
        const float dx = p.x - px, dy = p.y - py;
        const float power = ewa_power(A, B, C, dx, dy);
        const float e = expf(power);
        const float a = fminf(ALPHA_MAX, q.y * e);
        if (!(power > POWER_SKIP || a < ALPHA_MIN)) {
          const float incl = pe + logf(1.f - a);
          if (incl < LOG_T_EPS) {
            active = false;
          } else {
            const float cb = recs[i].s.x;
            const float t_before = __expf(pe);
            const float w = a * t_before;
            const float cgv = g0 * q.z + g1 * q.w + g2 * cb;
            u_incl += w * cgv;
            const float dalpha =
                cgv * t_before -
                __fdividef(total - u_incl, fmaxf(1.f - a, 1e-6f));
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
      if (__any_sync(FULL, touched))
        warp_sum_into(v, dg + __float_as_int(recs[i].s.y), n_pad, lane);
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
