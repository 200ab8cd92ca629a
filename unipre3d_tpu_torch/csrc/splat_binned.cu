// Binned Gaussian splat: per-tile forward and analytic backward (sm_90a).
//
// Replaces the TPU kernels of unipre3d_tpu/ops/rasterizer/pallas_splat_binned.py:
//   binned_fwd_kernel <- _fwd_kernel (called from _splat2_fwd_impl)
//   binned_bwd_kernel <- _bwd_kernel (called from _run_bwd_kernel)
//
// Input is the duplicate list of R renders sorted by (render, tile, depth)
// (ops/rasterizer/splat_binned.py:prep_duplicates): the table dup [9, M]
// (rows: mean x, mean y, conic A, B, C, opacity, r, g, b; one column per
// duplicate) and seg [R * n_tiles + 1], tile b's range being
// seg[b] .. seg[b+1]. Semantics are the JAX kernels':
//   * only the first maxn (a multiple of 1024) duplicates of a tile are
//     composited; later ones are dropped and get a zero gradient row (the
//     JAX backward leaves those rows unwritten, a fault the port does not
//     copy);
//   * a pair is skipped at power > 0 or alpha < 1/255; alpha <= 0.99;
//     a duplicate contributes iff log T after it stays >= log(1e-4);
//   * the list is walked in chunks of 1024 and only contributing
//     log(1 - alpha) are carried: a pixel that stopped inside one chunk
//     starts the next at its last contributing T (chunk re-arm);
//   * backward: s_i = tot - inclusive prefix of w (g . c), with
//     tot = sum_c g (out - bg T_final) from the wrapper; the gradient flows
//     through alpha only where alpha < 0.99, 1 - alpha clamped at 1e-6.
// Every operation that decides a skip or a stop (the EWA power, alpha,
// log T) is rounded op by op in the plain version's order (no FMA
// contraction), with expf/log1pf as torch's own CUDA exp/log1p, so the
// kernel and the plain version agree on T bit for bit.
//
// Launch: one CTA of 256 threads per (render, tile), one thread per pixel
// (tiles of at most 256 pixels; 8x32 at the scene's 120x160). The CTA
// stages its range of the table in batches of 256 duplicates (9 KB of
// shared memory); every thread walks a batch front to back. The CTA leaves
// a chunk early once every pixel has stopped in it, and re-arms at the
// next chunk.
//
// What bounds it on the H100: a table column is read at most once (by the
// one CTA of its tile), and only up to where the tile's last pixel stops
// in each chunk, so the bytes are small; per contributing (pixel,
// duplicate) pair the forward does ~24 FP32 operations and three
// transcendentals (exp of the power, log1p, exp of log T), the backward
// about three times that plus a warp reduction of nine terms. At the
// scene load the transcendentals bound both kernels (chip_smoke.py's
// bound_ms). What holds the kernels far above it is the per-pixel serial
// walk: one thread walks its pixel's whole list. The
// design keeps the batch in shared memory (broadcast reads: all threads
// read the same column), does no per-pair global traffic, and stops a
// pixel, and a whole chunk, as soon as it saturates.
//
// Backward reduction: each duplicate belongs to exactly one tile, so its
// gradient row is the sum over one CTA's pixels: warp shuffles (skipped
// when no lane of the warp touched the duplicate), a shared [9, 256]
// accumulator (one shared atomicAdd per warp), then one plain store per
// row and duplicate, no global atomics. The per-gaussian sum over a
// gaussian's duplicates is an index_add_ in the wrapper (the JAX package's
// XLA scatter-add).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // at most 256 pixels a tile
constexpr int CHUNK = 1024;   // the T re-arm boundary of a tile's list
constexpr int BATCH = 256;    // duplicates staged in shared memory at a time
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
  int r, x, y, start, n;
  bool inside;
};

// The CTA's render, tile range and this thread's pixel.
__device__ __forceinline__ Pixel pixel_of(const int* __restrict__ seg,
                                          int n_tiles, int tiles_x,
                                          int tile_h, int tile_w, int maxn) {
  Pixel p;
  const int b = blockIdx.x;
  p.r = b / n_tiles;
  const int tile = b - p.r * n_tiles;
  const int t = threadIdx.x;
  p.inside = t < tile_h * tile_w;
  p.x = (tile % tiles_x) * tile_w + (p.inside ? t % tile_w : 0);
  p.y = (tile / tiles_x) * tile_h + (p.inside ? t / tile_w : 0);
  p.start = seg[b];
  p.n = min(seg[b + 1] - p.start, maxn);
  return p;
}

__device__ __forceinline__ void stage(float (*tab)[BATCH],
                                      const float* __restrict__ dup,
                                      long long M, int j0, int nb) {
  for (int k = threadIdx.x; k < 9 * nb; k += THREADS) {
    const int row = k / nb, col = k - row * nb;
    tab[row][col] = dup[(size_t)row * M + j0 + col];
  }
}

__global__ void __launch_bounds__(THREADS)
binned_fwd_kernel(const int* __restrict__ seg, const float* __restrict__ dup,
                  long long M, const float* __restrict__ bg,
                  float* __restrict__ out, float* __restrict__ logt, int H,
                  int W, int tile_h, int tile_w, int maxn) {
  __shared__ float tab[9][BATCH];
  const int tiles_x = W / tile_w;
  const Pixel p = pixel_of(seg, (H / tile_h) * tiles_x, tiles_x, tile_h,
                           tile_w, maxn);
  const float px = (float)p.x, py = (float)p.y;

  float cr = 0.f, cg = 0.f, cb = 0.f;
  float log_t = 0.f;  // log T after the last contributing duplicate
  for (int c0 = 0; c0 < p.n; c0 += CHUNK) {
    const int c1 = min(c0 + CHUNK, p.n);
    bool stopped = !p.inside;  // chunk re-arm
    for (int j0 = c0; j0 < c1; j0 += BATCH) {
      // a barrier (the last batch is consumed) that also leaves the chunk
      // once every pixel of the tile has stopped in it
      if (__syncthreads_count(!stopped) == 0) break;
      const int nb = min(BATCH, c1 - j0);
      stage(tab, dup, M, p.start + j0, nb);
      __syncthreads();
      if (stopped) continue;
      for (int i = 0; i < nb; ++i) {
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
binned_bwd_kernel(const int* __restrict__ seg, const float* __restrict__ dup,
                  long long M, const float* __restrict__ bg,
                  const float* __restrict__ logt,
                  const float* __restrict__ tot,
                  const float* __restrict__ gout, float* __restrict__ dgrad,
                  int H, int W, int tile_h, int tile_w, int maxn) {
  __shared__ float tab[9][BATCH];
  __shared__ float acc[9][BATCH];
  const int tiles_x = W / tile_w;
  const Pixel p = pixel_of(seg, (H / tile_h) * tiles_x, tiles_x, tile_h,
                           tile_w, maxn);
  const float px = (float)p.x, py = (float)p.y;
  const int lane = threadIdx.x & 31;

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
  for (int c0 = 0; c0 < p.n; c0 += CHUNK) {
    const int c1 = min(c0 + CHUNK, p.n);
    bool stopped = !p.inside;  // chunk re-arm
    for (int j0 = c0; j0 < c1; j0 += BATCH) {
      if (__syncthreads_count(!stopped) == 0) break;
      const int nb = min(BATCH, c1 - j0);
      stage(tab, dup, M, p.start + j0, nb);
      for (int k = threadIdx.x; k < 9 * BATCH; k += THREADS)
        acc[k / BATCH][k % BATCH] = 0.f;
      __syncthreads();
      for (int i = 0; i < nb; ++i) {
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
      // one row per duplicate, owned by this CTA alone
      for (int k = threadIdx.x; k < 9 * nb; k += THREADS) {
        const int row = k / nb, col = k - row * nb;
        dgrad[(size_t)row * M + p.start + j0 + col] = acc[row][col];
      }
    }
  }
}

// (render, tile) blocks ride on gridDim.x; a tile holds at most 256 pixels
inline bool shape_ok(long long M, int R, int H, int W, int tile_h,
                     int tile_w, int maxn) {
  return M >= 0 && R > 0 && H > 0 && W > 0 && tile_h > 0 && tile_w > 0 &&
         H % tile_h == 0 && W % tile_w == 0 && tile_h * tile_w <= THREADS &&
         maxn > 0 && maxn % CHUNK == 0;
}

inline unsigned blocks_of(int R, int H, int W, int tile_h, int tile_w) {
  return (unsigned)R * (unsigned)((H / tile_h) * (W / tile_w));
}

}  // namespace

extern "C" {

// out [R, 3, H, W], logt [R, H, W]; returns cudaGetLastError() after launch.
int binned_splat_fwd(const int* seg, const float* dup, const float* bg,
                     float* out, float* logt, int M, int R, int H, int W,
                     int tile_h, int tile_w, int maxn, void* stream) {
  if (!shape_ok(M, R, H, W, tile_h, tile_w, maxn))
    return (int)cudaErrorInvalidValue;
  binned_fwd_kernel<<<blocks_of(R, H, W, tile_h, tile_w), THREADS, 0,
                      (cudaStream_t)stream>>>(seg, dup, (long long)M, bg, out,
                                              logt, H, W, tile_h, tile_w,
                                              maxn);
  return (int)cudaGetLastError();
}

// dgrad [9, M] must be zeroed by the caller (rows of duplicates that are
// never composited stay zero).
int binned_splat_bwd(const int* seg, const float* dup, const float* bg,
                     const float* logt, const float* tot, const float* gout,
                     float* dgrad, int M, int R, int H, int W, int tile_h,
                     int tile_w, int maxn, void* stream) {
  if (!shape_ok(M, R, H, W, tile_h, tile_w, maxn))
    return (int)cudaErrorInvalidValue;
  binned_bwd_kernel<<<blocks_of(R, H, W, tile_h, tile_w), THREADS, 0,
                      (cudaStream_t)stream>>>(seg, dup, (long long)M, bg, logt,
                                              tot, gout, dgrad, H, W, tile_h,
                                              tile_w, maxn);
  return (int)cudaGetLastError();
}

}  // extern "C"
