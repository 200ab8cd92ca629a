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
// contraction), with expf/log1pf as torch's own CUDA exp/log1p, and so are
// the colour sums, so the kernel and the plain version agree on T and the
// images bit for bit. Only values that feed the gradient alone take fast
// intrinsics: the backward's T before the duplicate (__expf) and its
// division by max(1 - alpha, 1e-6) (__fdividef).
//
// Launch: one CTA of one warp per (render, tile, warp patch), one lane per
// pixel (tiles of at most 256 pixels; 8x32 at the scene's 120x160, 16x16
// at the object renders' 128x128). A warp owns a compact 4x8 patch of the
// tile where 4 divides the tile's height and 8 its width, else 32 pixels
// of the tile in row-major order. It takes its tile's list 32 columns at a
// time: each lane loads one column and culls it against the warp's pixel
// rectangle (rect_keeps, splat_common.cuh; the plain twin is
// splat_binned.py:patch_survivors_ref), the kept columns are compacted in
// depth order (ballot + popc) into 48-byte records in shared memory, and
// the warp walks them. A culled pair is skipped by the walk at every pixel
// of the patch, so it neither adds colour nor stops a pixel: the stop
// decisions, the re-arm (counted on list positions) and the cap are the
// unculled walk's. A warp leaves a chunk once all its pixels have stopped
// in it.
//
// What bounds it on the H100: per contributing (pixel, duplicate) pair the
// forward does ~24 FP32 operations and three transcendentals (exp of the
// power, log1p, exp of log T), the backward about three times that plus a
// share of the warp reduction; at the scene load the transcendentals bound
// both kernels (chip_smoke.py's bound_ms), and the bytes are small (a
// column is read by the up to 8 warps of its tile, from L2). What the
// kernels spend is instruction issue on warp-column steps (~95
// instructions a column in the forward, log1pf alone ~25), and the first
// port took 4.5x as many steps as the 4x8 patches over the cull's
// survivors (chip_smoke.py prints both counts). One warp a CTA: a CTA of a
// whole tile held its SM slot until its busiest warp was done, and the
// 600 CTAs of the scene shape ran in two uneven waves; warps are scheduled
// one by one. The cost is that each warp loads and tests the columns it
// walks itself (up to 8 times a column, from L2). No minimum of CTAs an SM
// is asked of the compiler: 72 registers forward, 64 backward, no spill;
// bounds of 16-28 warps an SM measured no faster
// (tools/time_binned_kernels.py, PERF.md).
//
// Backward reduction: each duplicate belongs to exactly one tile, so its
// gradient row sums the pixels of the tile's up to 8 warps. A warp that
// touched a column reduces its nine terms with the 14-shuffle
// reduce-scatter of splat_common.cuh and nine lanes add them to the
// column's rows of dgrad with global atomics (dgrad zeroed by the wrapper,
// so an untouched or dropped duplicate keeps a zero row). Atomic order
// changes from run to run: gradients agree with the plain version to float
// rounding of the sum order. The per-gaussian sum over a gaussian's
// duplicates is an index_add_ in the wrapper (the JAX package's XLA
// scatter-add).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "splat_common.cuh"

namespace {

using namespace splat;

constexpr int TILE_PIXELS = 256;  // at most 256 pixels a tile
constexpr int CHUNK = 1024;       // the T re-arm boundary of a tile's list

// A warp owns a compact 4x8 patch of its tile where 4 divides the tile's
// height and 8 its width, else 32 pixels of the tile in row-major order
// (splat_binned.py:warp_of_pixel is the plain twin of this map).
constexpr int PATCH_H = 4;
constexpr int PATCH_W = 8;

__host__ __device__ __forceinline__ bool patches(int tile_h, int tile_w) {
  return tile_h % PATCH_H == 0 && tile_w % PATCH_W == 0;
}

// warps (one a CTA) a tile
__host__ __device__ __forceinline__ int warps_of(int tile_h, int tile_w) {
  return (tile_h * tile_w + 31) / 32;
}

// Lane ``lane`` of warp ``warp`` of a tile: its pixel (lx, ly) within the
// tile; false for a lane past the tile's last pixel (lx = ly = 0 then).
__device__ __forceinline__ bool patch_pixel(int warp, int lane, int tile_h,
                                            int tile_w, int& lx, int& ly) {
  if (patches(tile_h, tile_w)) {
    const int across = tile_w / PATCH_W;
    ly = (warp / across) * PATCH_H + lane / PATCH_W;
    lx = (warp % across) * PATCH_W + lane % PATCH_W;
    return true;
  }
  const int t = warp * 32 + lane;
  const bool inside = t < tile_h * tile_w;
  ly = inside ? t / tile_w : 0;
  lx = inside ? t % tile_w : 0;
  return inside;
}

// The warp's pixel rectangle (over its lanes inside the tile; every warp
// has one).
__device__ __forceinline__ Rect warp_rect(int x, int y, bool inside) {
  Rect r;
  r.x0 = __reduce_min_sync(FULL, inside ? x : INT_MAX);
  r.x1 = __reduce_max_sync(FULL, inside ? x : INT_MIN);
  r.y0 = __reduce_min_sync(FULL, inside ? y : INT_MAX);
  r.y1 = __reduce_max_sync(FULL, inside ? y : INT_MIN);
  return r;
}

struct Pixel {
  int r, x, y, start, n;
  bool inside;
};

// The CTA's (one warp's) render, tile range and this lane's pixel.
__device__ __forceinline__ Pixel pixel_of(const int* __restrict__ seg,
                                          int n_tiles, int tiles_x,
                                          int tile_h, int tile_w, int maxn) {
  Pixel p;
  const int per_tile = warps_of(tile_h, tile_w);
  const int b = blockIdx.x / per_tile, warp = blockIdx.x - b * per_tile;
  p.r = b / n_tiles;
  const int tile = b - p.r * n_tiles;
  int lx, ly;
  p.inside = patch_pixel(warp, threadIdx.x, tile_h, tile_w, lx, ly);
  p.x = (tile % tiles_x) * tile_w + lx;
  p.y = (tile / tiles_x) * tile_h + ly;
  p.start = seg[b];
  p.n = min(seg[b + 1] - p.start, maxn);
  return p;
}

__global__ void __launch_bounds__(32)
binned_fwd_kernel(const int* __restrict__ seg, const float* __restrict__ dup,
                  long long M, const float* __restrict__ bg,
                  float* __restrict__ out, float* __restrict__ logt, int H,
                  int W, int tile_h, int tile_w, int maxn) {
  __shared__ Rec recs[32];
  const int tiles_x = W / tile_w;
  const Pixel p = pixel_of(seg, (H / tile_h) * tiles_x, tiles_x, tile_h,
                           tile_w, maxn);
  const float px = (float)p.x, py = (float)p.y;
  const Rect rect = warp_rect(p.x, p.y, p.inside);

  float cr = 0.f, cg = 0.f, cb = 0.f;
  float log_t = 0.f;  // log T after the last contributing duplicate
  for (int c0 = 0; c0 < p.n; c0 += CHUNK) {
    const int c1 = min(c0 + CHUNK, p.n);
    bool stopped = !p.inside;  // chunk re-arm
    for (int j0 = c0; j0 < c1; j0 += 32) {
      // leave the chunk once every pixel of the warp has stopped in it
      if (!__any_sync(FULL, !stopped)) break;
      const int n = warp_group(recs, dup, M, p.start + j0, p.start + c1,
                               rect);
      for (int k = 0; k < n; ++k) {
        if (stopped) continue;
        const Rec& rec = recs[k];
        stopped = !blend(pair_of(rec, px, py), rec, log_t, cr, cg, cb);
      }
    }
  }
  if (p.inside)
    write_pixel(p.r, (size_t)H * W, (size_t)p.y * W + p.x, bg, cr, cg, cb,
                log_t, out, logt);
}

__global__ void __launch_bounds__(32)
binned_bwd_kernel(const int* __restrict__ seg, const float* __restrict__ dup,
                  long long M, const float* __restrict__ bg,
                  const float* __restrict__ logt,
                  const float* __restrict__ tot,
                  const float* __restrict__ gout, float* __restrict__ dgrad,
                  int H, int W, int tile_h, int tile_w, int maxn) {
  __shared__ Rec recs[32];
  const int tiles_x = W / tile_w;
  const Pixel p = pixel_of(seg, (H / tile_h) * tiles_x, tiles_x, tile_h,
                           tile_w, maxn);
  const float px = (float)p.x, py = (float)p.y;
  const int lane = threadIdx.x;
  const Rect rect = warp_rect(p.x, p.y, p.inside);
  GradPixel s = grad_pixel(p.inside, p.r, (size_t)H * W,
                           (size_t)p.y * W + p.x, bg, logt, tot, gout);

  for (int c0 = 0; c0 < p.n; c0 += CHUNK) {
    const int c1 = min(c0 + CHUNK, p.n);
    s.stopped = !p.inside;  // chunk re-arm
    for (int j0 = c0; j0 < c1; j0 += 32) {
      if (!__any_sync(FULL, !s.stopped)) break;
      const int n = warp_group(recs, dup, M, p.start + j0, p.start + c1,
                               rect);
      for (int k = 0; k < n; ++k) {
        float v[9];
#pragma unroll
        for (int r = 0; r < 9; ++r) v[r] = 0.f;
        const Rec& rec = recs[k];
        const bool touched = pair_grad(rec, px, py, s, v);
        if (__any_sync(FULL, touched))  // warp-uniform
          warp_sum_into(v, dgrad + __float_as_int(rec.s.y), (int)M, lane);
      }
    }
  }
}

// (render, tile, warp) blocks ride on gridDim.x; a tile holds at most 256
// pixels
inline bool shape_ok(long long M, int R, int H, int W, int tile_h,
                     int tile_w, int maxn) {
  return M >= 0 && R > 0 && H > 0 && W > 0 && tile_h > 0 && tile_w > 0 &&
         H % tile_h == 0 && W % tile_w == 0 &&
         tile_h * tile_w <= TILE_PIXELS && maxn > 0 && maxn % CHUNK == 0;
}

inline unsigned blocks_of(int R, int H, int W, int tile_h, int tile_w) {
  return (unsigned)R * (unsigned)((H / tile_h) * (W / tile_w)) *
         (unsigned)warps_of(tile_h, tile_w);
}

}  // namespace

extern "C" {

// out [R, 3, H, W], logt [R, H, W]; returns cudaGetLastError() after launch.
int binned_splat_fwd(const int* seg, const float* dup, const float* bg,
                     float* out, float* logt, int M, int R, int H, int W,
                     int tile_h, int tile_w, int maxn, void* stream) {
  if (!shape_ok(M, R, H, W, tile_h, tile_w, maxn))
    return (int)cudaErrorInvalidValue;
  binned_fwd_kernel<<<blocks_of(R, H, W, tile_h, tile_w), 32, 0,
                      (cudaStream_t)stream>>>(seg, dup, (long long)M, bg, out,
                                              logt, H, W, tile_h, tile_w,
                                              maxn);
  return (int)cudaGetLastError();
}

// dgrad [9, M] must be zeroed by the caller (the kernel adds the rows of
// the duplicates it composites; the others stay zero).
int binned_splat_bwd(const int* seg, const float* dup, const float* bg,
                     const float* logt, const float* tot, const float* gout,
                     float* dgrad, int M, int R, int H, int W, int tile_h,
                     int tile_w, int maxn, void* stream) {
  if (!shape_ok(M, R, H, W, tile_h, tile_w, maxn))
    return (int)cudaErrorInvalidValue;
  binned_bwd_kernel<<<blocks_of(R, H, W, tile_h, tile_w), 32, 0,
                      (cudaStream_t)stream>>>(seg, dup, (long long)M, bg, logt,
                                              tot, gout, dgrad, H, W, tile_h,
                                              tile_w, maxn);
  return (int)cudaGetLastError();
}

}  // extern "C"
