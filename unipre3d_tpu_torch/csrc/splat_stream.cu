// Streaming Gaussian splat: forward and analytic backward (sm_90a).
//
// Replaces the TPU kernels of unipre3d_tpu/ops/rasterizer/pallas_splat.py:
//   stream_fwd_kernel <- _fwd_kernel (called from _splat_fwd_impl)
//   stream_bwd_kernel <- _bwd_kernel (called from _splat_vjp_bwd)
//
// Input is the per-render depth-sorted packed table data [R, 16, n_pad]
// (rows 0-8: mean x, mean y, conic A, B, C, opacity, r, g, b; invalid and
// padding columns have opacity 0; n_pad a multiple of 512) and the chunk
// bitmap flags [R, n_tiles, n_pad / 512] (ops/rasterizer/splat_stream.py:
// chunk_flags): flag (tile, chunk) is set when any valid gaussian of the
// 512-column chunk has a radius bbox that overlaps the tile. No binning:
// every tile walks the global depth order. Semantics are the JAX kernels':
//   * a flagged chunk is composited whole for every pixel of the tile, so a
//     gaussian whose own bbox misses the tile still adds its colour there
//     (its 3-sigma alpha can exceed 1/255); an unflagged chunk adds nothing;
//   * a pair is skipped at power > 0 or alpha < 1/255; alpha <= 0.99;
//     a gaussian contributes iff log T after it stays >= log(1e-4);
//   * T re-arms at each chunk: only contributing log(1 - alpha) are carried,
//     so a pixel that stopped inside one chunk starts the next flagged chunk
//     at its last contributing T and can take small-alpha gaussians again.
//     The JAX kernel's tile-level test max(log T) >= log(1e-4) holds by
//     construction here (log T only takes values that passed the test), so
//     no later flagged chunk is ever skipped;
//   * backward: s_i = tot - inclusive prefix of w (g . c), with
//     tot = sum_c g (out - bg T_final) from the wrapper (the JAX backward's
//     suffix carry over later chunks plus the in-chunk suffix, summed front
//     to back instead); dL/dalpha = (g . c) T_before - (s_i + T_final
//     (g . bg)) / max(1 - alpha, 1e-6); the gradient flows through alpha
//     only where the pair is live and alpha < 0.99.
// Every operation that decides a skip or a stop (the EWA power, alpha,
// log T) is rounded op by op in the plain version's order (no FMA
// contraction), with expf/log1pf as torch's own CUDA exp/log1p, so the
// kernel and the plain version agree on T bit for bit. The JAX kernel sums
// the in-chunk log(1 - alpha) with a log-step scan; the port sums them in
// depth order, which rounds otherwise (held to JAX at a stated tolerance).
//
// Launch: one CTA of 256 threads per (render, tile, group of 256 pixels of
// the tile), one thread per pixel: a 32x32 tile (the object's 128^2) takes
// four CTAs, an 8x32 tile (the scene's 120x160) one. The flags are per
// tile, so how a tile's pixels are split over CTAs changes nothing. A CTA
// walks the flagged chunks of its tile in depth order and stages each in
// batches of 256 columns (9 KB of shared memory); every thread walks a batch
// front to back and stops at its pixel's stop, and the CTA leaves a chunk
// once all its pixels have stopped in it.
//
// What bounds it on the H100: per contributing (pixel, gaussian) pair the
// forward does ~24 FP32 operations and three transcendentals (exp of the
// power, log1p, exp of log T), the backward about three times that plus a
// warp reduction of nine terms. Bytes are small: the table is read once per
// CTA from L2 for the flagged chunks, each pixel's outputs written once. So
// both kernels are bound by the transcendentals (chip_smoke.py's bound_ms).
// The per-pixel serial walk holds them above it: one thread walks its
// pixel's whole depth order, and every flagged chunk is walked at least up
// to the last stop of the CTA's pixels.
//
// Backward reduction: a column is shared by every tile of its render, so
// each warp reduces its 32 pixels' nine terms per column with shuffles
// (skipped when no lane touched the column), lane 0 adds the sums into a
// shared [9, 256] accumulator, and the CTA adds each non-zero accumulator
// entry to dgrad [R, 16, n_pad] with one global atomicAdd. Atomic order
// changes from run to run: gradients agree with the plain version to the
// rounding of the sum order, not bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 16;
constexpr int THREADS = 256;  // pixels of a tile per CTA
constexpr int CHUNK = 512;    // the T re-arm boundary and the flag's width
constexpr int BATCH = 256;    // columns staged in shared memory at a time
constexpr int MAX_TILE_PIXELS = 1024;
constexpr float ALPHA_MIN = (float)(1.0 / 255.0);
constexpr float ALPHA_MAX = 0.99f;
constexpr float LOG_T_EPS = -9.210340371976184f;  // log(1e-4)
constexpr unsigned FULL = 0xffffffffu;

// EWA power -0.5 (A dx^2 + C dy^2) - B dx dy, op by op without contraction
__device__ __forceinline__ float ewa_power(float A, float B, float C, float dx,
                                          float dy) {
  const float q = __fadd_rn(__fmul_rn(__fmul_rn(A, dx), dx),
                            __fmul_rn(__fmul_rn(C, dy), dy));
  return __fsub_rn(__fmul_rn(-0.5f, q), __fmul_rn(__fmul_rn(B, dx), dy));
}

struct Pixel {
  int r, tile, x, y;
  bool inside;
};

// The CTA's render and tile, and this thread's pixel.
__device__ __forceinline__ Pixel pixel_of(int n_tiles, int groups,
                                          int tiles_x, int tile_h,
                                          int tile_w) {
  Pixel p;
  const int b = blockIdx.x;
  p.r = b / (n_tiles * groups);
  const int rem = b - p.r * n_tiles * groups;
  p.tile = rem / groups;
  const int t = (rem - p.tile * groups) * THREADS + (int)threadIdx.x;
  p.inside = t < tile_h * tile_w;
  p.x = (p.tile % tiles_x) * tile_w + (p.inside ? t % tile_w : 0);
  p.y = (p.tile / tiles_x) * tile_h + (p.inside ? t / tile_w : 0);
  return p;
}

__device__ __forceinline__ void stage(float (*tab)[BATCH],
                                      const float* __restrict__ g, int n_pad,
                                      int c0) {
  for (int k = threadIdx.x; k < 9 * BATCH; k += THREADS) {
    const int row = k / BATCH, col = k - row * BATCH;
    tab[row][col] = g[(size_t)row * n_pad + c0 + col];
  }
}

__global__ void __launch_bounds__(THREADS)
stream_fwd_kernel(const float* __restrict__ data,
                  const int* __restrict__ flags, const float* __restrict__ bg,
                  float* __restrict__ out, float* __restrict__ logt, int n_pad,
                  int H, int W, int tile_h, int tile_w) {
  __shared__ float tab[9][BATCH];
  const int tiles_x = W / tile_w, n_tiles = (H / tile_h) * tiles_x;
  const int groups = (tile_h * tile_w + THREADS - 1) / THREADS;
  const int n_chunks = n_pad / CHUNK;
  const Pixel p = pixel_of(n_tiles, groups, tiles_x, tile_h, tile_w);
  const float px = (float)p.x, py = (float)p.y;
  const float* g = data + (size_t)p.r * ROWS * n_pad;
  const int* fl = flags + ((size_t)p.r * n_tiles + p.tile) * n_chunks;

  float cr = 0.f, cg = 0.f, cb = 0.f;
  float log_t = 0.f;  // log T after the last contributing gaussian
  for (int c = 0; c < n_chunks; ++c) {
    if (fl[c] == 0) continue;  // the same for every thread of the CTA
    bool stopped = !p.inside;  // chunk re-arm
    for (int j0 = 0; j0 < CHUNK; j0 += BATCH) {
      // a barrier (the last batch is consumed) that also leaves the chunk
      // once every pixel of the CTA has stopped in it
      if (__syncthreads_count(!stopped) == 0) break;
      stage(tab, g, n_pad, c * CHUNK + j0);
      __syncthreads();
      if (stopped) continue;
      for (int i = 0; i < BATCH; ++i) {
        const float dx = __fsub_rn(tab[0][i], px);
        const float dy = __fsub_rn(tab[1][i], py);
        const float power = ewa_power(tab[2][i], tab[3][i], tab[4][i], dx, dy);
        if (power > 0.f) continue;
        const float a = fminf(ALPHA_MAX, __fmul_rn(tab[5][i], expf(power)));
        if (a < ALPHA_MIN) continue;
        const float incl = __fadd_rn(log_t, log1pf(-a));
        if (incl < LOG_T_EPS) {
          stopped = true;
          break;
        }
        const float w = __fmul_rn(a, expf(log_t));
        cr = __fadd_rn(cr, __fmul_rn(w, tab[6][i]));
        cg = __fadd_rn(cg, __fmul_rn(w, tab[7][i]));
        cb = __fadd_rn(cb, __fmul_rn(w, tab[8][i]));
        log_t = incl;
      }
    }
  }
  if (p.inside) {
    const float t = expf(log_t);
    const size_t hw = (size_t)H * W, q = (size_t)p.y * W + p.x;
    float* o = out + (size_t)p.r * 3 * hw + q;
    o[0] = __fadd_rn(cr, __fmul_rn(bg[0], t));
    o[hw] = __fadd_rn(cg, __fmul_rn(bg[1], t));
    o[2 * hw] = __fadd_rn(cb, __fmul_rn(bg[2], t));
    logt[(size_t)p.r * hw + q] = log_t;
  }
}

__global__ void __launch_bounds__(THREADS)
stream_bwd_kernel(const float* __restrict__ data,
                  const int* __restrict__ flags, const float* __restrict__ bg,
                  const float* __restrict__ logt,
                  const float* __restrict__ tot,
                  const float* __restrict__ gout, float* __restrict__ dgrad,
                  int n_pad, int H, int W, int tile_h, int tile_w) {
  __shared__ float tab[9][BATCH];
  __shared__ float acc[9][BATCH];
  const int tiles_x = W / tile_w, n_tiles = (H / tile_h) * tiles_x;
  const int groups = (tile_h * tile_w + THREADS - 1) / THREADS;
  const int n_chunks = n_pad / CHUNK;
  const Pixel p = pixel_of(n_tiles, groups, tiles_x, tile_h, tile_w);
  const float px = (float)p.x, py = (float)p.y;
  const int lane = threadIdx.x & 31;
  const float* g = data + (size_t)p.r * ROWS * n_pad;
  float* dg = dgrad + (size_t)p.r * ROWS * n_pad;
  const int* fl = flags + ((size_t)p.r * n_tiles + p.tile) * n_chunks;

  float g0 = 0.f, g1 = 0.f, g2 = 0.f, s_tot = 0.f, tb = 0.f;
  if (p.inside) {
    const size_t hw = (size_t)H * W, q = (size_t)p.y * W + p.x;
    const float* go = gout + (size_t)p.r * 3 * hw + q;
    g0 = go[0];
    g1 = go[hw];
    g2 = go[2 * hw];
    s_tot = tot[(size_t)p.r * hw + q];
    // background share of dL/dalpha: T_final (bg . g)
    tb = expf(logt[(size_t)p.r * hw + q]) * (bg[0] * g0 + bg[1] * g1 +
                                             bg[2] * g2);
  }

  float log_t = 0.f, u_incl = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    if (fl[c] == 0) continue;
    bool stopped = !p.inside;  // chunk re-arm
    for (int j0 = 0; j0 < CHUNK; j0 += BATCH) {
      if (__syncthreads_count(!stopped) == 0) break;
      const int c0 = c * CHUNK + j0;
      stage(tab, g, n_pad, c0);
      for (int k = threadIdx.x; k < 9 * BATCH; k += THREADS)
        acc[k / BATCH][k % BATCH] = 0.f;
      __syncthreads();
      for (int i = 0; i < BATCH; ++i) {
        if (!__any_sync(FULL, !stopped)) break;  // warp-uniform
        float v[9];
#pragma unroll
        for (int k = 0; k < 9; ++k) v[k] = 0.f;
        bool touched = false;
        if (!stopped) {
          const float A = tab[2][i], B = tab[3][i], C = tab[4][i];
          const float dx = __fsub_rn(tab[0][i], px);
          const float dy = __fsub_rn(tab[1][i], py);
          const float power = ewa_power(A, B, C, dx, dy);
          const float e = expf(power);
          const float a = fminf(ALPHA_MAX, __fmul_rn(tab[5][i], e));
          if (!(power > 0.f || a < ALPHA_MIN)) {
            const float incl = __fadd_rn(log_t, log1pf(-a));
            if (incl < LOG_T_EPS) {
              stopped = true;
            } else {
              const float t_before = expf(log_t);
              const float w = __fmul_rn(a, t_before);
              const float cgv = g0 * tab[6][i] + g1 * tab[7][i] + g2 * tab[8][i];
              u_incl += w * cgv;
              const float dalpha = cgv * t_before -
                                   ((s_tot - u_incl) + tb) / fmaxf(1.f - a, 1e-6f);
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
      // the column is shared by every tile of the render: add, not store
      for (int k = threadIdx.x; k < 9 * BATCH; k += THREADS) {
        const int row = k / BATCH, col = k - row * BATCH;
        const float s = acc[row][col];
        if (s != 0.f) atomicAdd(&dg[(size_t)row * n_pad + c0 + col], s);
      }
    }
  }
}

// (render, tile, pixel group) blocks ride on gridDim.x
inline bool shape_ok(int R, int n_pad, int H, int W, int tile_h, int tile_w) {
  return R > 0 && n_pad > 0 && n_pad % CHUNK == 0 && H > 0 && W > 0 &&
         tile_h > 0 && tile_w > 0 && H % tile_h == 0 && W % tile_w == 0 &&
         tile_h * tile_w <= MAX_TILE_PIXELS;
}

inline unsigned blocks_of(int R, int H, int W, int tile_h, int tile_w) {
  const unsigned groups = (unsigned)((tile_h * tile_w + THREADS - 1) / THREADS);
  return (unsigned)R * (unsigned)((H / tile_h) * (W / tile_w)) * groups;
}

}  // namespace

extern "C" {

// out [R, 3, H, W], logt [R, H, W]; returns cudaGetLastError() after launch.
int stream_splat_fwd(const float* data, const int* flags, const float* bg,
                     float* out, float* logt, int R, int n_pad, int H, int W,
                     int tile_h, int tile_w, void* stream) {
  if (!shape_ok(R, n_pad, H, W, tile_h, tile_w))
    return (int)cudaErrorInvalidValue;
  stream_fwd_kernel<<<blocks_of(R, H, W, tile_h, tile_w), THREADS, 0,
                      (cudaStream_t)stream>>>(data, flags, bg, out, logt,
                                              n_pad, H, W, tile_h, tile_w);
  return (int)cudaGetLastError();
}

// dgrad [R, 16, n_pad] must be zeroed by the caller (rows 0-8 are added).
int stream_splat_bwd(const float* data, const int* flags, const float* bg,
                     const float* logt, const float* tot, const float* gout,
                     float* dgrad, int R, int n_pad, int H, int W, int tile_h,
                     int tile_w, void* stream) {
  if (!shape_ok(R, n_pad, H, W, tile_h, tile_w))
    return (int)cudaErrorInvalidValue;
  stream_bwd_kernel<<<blocks_of(R, H, W, tile_h, tile_w), THREADS, 0,
                      (cudaStream_t)stream>>>(data, flags, bg, logt, tot, gout,
                                              dgrad, n_pad, H, W, tile_h,
                                              tile_w);
  return (int)cudaGetLastError();
}

}  // extern "C"
