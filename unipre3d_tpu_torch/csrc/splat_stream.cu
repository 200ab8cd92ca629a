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
// contraction), with expf/log1pf as torch's own CUDA exp/log1p, and so are
// the colour sums, so the kernel and the plain version agree on T and the
// images bit for bit (splat_common.cuh: pair_of, blend; the backward's
// pair_grad takes fast intrinsics only for values that feed the gradient
// alone). The JAX kernel sums the in-chunk log(1 - alpha) with a log-step
// scan; the port sums them in depth order, which rounds otherwise (held to
// JAX at a stated tolerance).
//
// Launch: one CTA of one warp per (render, tile, warp patch), two pixels a
// lane: a warp owns an 8x8 patch of its tile (rows y and y + 4 a lane;
// pixels_of), so an 8x32 tile (the scene's 120x160) holds 4 patches and a
// 32x32 tile (the object's 128^2) 16. Each warp walks its tile's flagged
// chunks (found 32 flags at a time with a ballot) in depth order, on its
// own, with no barrier: it takes a chunk 32 columns at a time, each lane
// loading one column (rows 0-8, from L2) and culling it against the warp's
// pixel rectangle (rect_keeps, splat_common.cuh; the plain twin is
// splat_stream.py:patch_survivors_ref); the kept columns are compacted in
// lane order, which is depth order (ballot + popc), into 48-byte records
// in shared memory, and the warp walks them, each lane for both its
// pixels. A culled pair is skipped by the walk at every pixel of the patch
// (the test culls on alpha < 1/255 alone, so it is conservative for the
// power > 0 skip too): it neither adds colour nor stops a pixel, so the
// chunk is still composited whole, and the stops and re-arms are the
// unculled walk's. The warp leaves a chunk once its 64 pixels have stopped
// in it.
//
// What bounds it on the H100: the function needs the contributing (pixel,
// gaussian) pairs, ~24 FP32 operations and three transcendentals each (exp
// of the power, log1p, exp of log T) forward and about three times that
// backward, and the table's columns read once; at the scene load the bytes
// set that bound, at a few hundredths of a millisecond (chip_smoke.py
// bound_ms), far below both kernels. The chunk rule makes the plain walk
// test every column of a flagged chunk up to each pixel's stop; the cull
// below spares the kernels most of those tests, and what they still do
// (groups, walk) is the distance to the bound. The first port ran one
// thread a pixel, 256 a
// CTA, staged each flagged chunk in 256-column batches between CTA-wide
// barriers, so every batch waited for the slowest of 256 pixels, and every
// pixel tested every column up to its stop. Here the cull drops the
// columns the patch's pixels all skip before the walk, a warp waits only
// for its own pixels, and the cost of staging and culling scales with the
// columns walked (a group of 32 at a time), not with the 512 columns of a
// flagged chunk. What is left is instruction issue, most of it in the
// groups (the nine loads, the cull in double, the compaction: a 4x8 warp
// needs ~1.8 groups a flagged chunk at the scene load, for ~1.3 kept
// columns a group) and less in the walk (per-warp clock64 in a copy of
// the source). Hence two pixels a lane: a group's loads and cull serve 64
// pixels, a record's loads two pixel walks, and the backward's reduction
// two pixels' terms; the scene load's 2,400 warps also fit the card in one
// wave (4,800 one-pixel warps took two, the second on ~8 warps an SM).
// At the scene load on an H100 80GB HBM3 at 700 W
// (tools/time_stream_kernels.py): 0.66 / 0.77 ms forward / backward,
// against 0.93 / 1.08 for 4x8 patches of one pixel a lane and 0.81 / 0.94
// for four pixels a lane (8x16 patches, 116 registers). 90 registers
// backward, 76 forward, no spills. chip_smoke.py prints the warp-column
// iterations of both the first port's 1x32 rows walking every column and
// these patches walking the cull's survivors.
//
// Backward reduction: a column is shared by every tile of its render. A
// warp that touched a column reduces its nine terms with the 14-shuffle
// reduce-scatter of splat_common.cuh (warp_sum_into) and nine lanes add
// them to the column's rows of dgrad [R, 16, n_pad] with global atomics
// (the first port's shared [9, 256] accumulator compiled to compare-and-
// swap loops, and was zeroed and flushed every batch). Atomic order changes
// from run to run: gradients agree with the plain version to the rounding
// of the sum order, not bit for bit.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "splat_common.cuh"

namespace {

using namespace splat;

constexpr int ROWS = 16;
constexpr int CHUNK = 512;  // the T re-arm boundary and the flag's width
constexpr int MAX_TILE_PIXELS = 1024;

// A warp's patch of its tile: BLOCKS_Y x BLOCKS_X blocks of 4x8 pixels,
// each lane one pixel of every block (lane / 8, lane % 8 within it), where
// the patch divides the tile; else 32 NPX pixels of the tile in row-major
// order (pixel t + 32 h of lane t). splat_stream.py:warp_of_pixel is the
// plain twin of this map.
constexpr int BLOCKS_Y = 2, BLOCKS_X = 1;
constexpr int NPX = BLOCKS_Y * BLOCKS_X;  // pixels a lane
constexpr int PATCH_Y = 4 * BLOCKS_Y, PATCH_X = 8 * BLOCKS_X;

__host__ __device__ __forceinline__ int patches_of(int tile_h, int tile_w) {
  return (tile_h * tile_w + 32 * NPX - 1) / (32 * NPX);
}

struct Pixels {
  int r, tile;
  int x[NPX], y[NPX];
  float px[NPX], py[NPX];  // x, y as floats
  bool inside[NPX];
};

// The CTA's (one warp's) render and tile, and this lane's pixels.
__device__ __forceinline__ Pixels pixels_of(int n_tiles, int tiles_x,
                                            int tile_h, int tile_w) {
  Pixels p;
  const int per_tile = patches_of(tile_h, tile_w);
  const int b = blockIdx.x / per_tile, warp = blockIdx.x - b * per_tile;
  const int lane = threadIdx.x;
  p.r = b / n_tiles;
  p.tile = b - p.r * n_tiles;
  const bool patched = tile_h % PATCH_Y == 0 && tile_w % PATCH_X == 0;
  const int across = tile_w / PATCH_X;
#pragma unroll
  for (int h = 0; h < NPX; ++h) {
    int lx, ly;
    if (patched) {
      ly = (warp / across) * PATCH_Y + (h / BLOCKS_X) * 4 + lane / 8;
      lx = (warp % across) * PATCH_X + (h % BLOCKS_X) * 8 + lane % 8;
      p.inside[h] = true;
    } else {
      const int t = warp * 32 * NPX + h * 32 + lane;
      p.inside[h] = t < tile_h * tile_w;
      ly = p.inside[h] ? t / tile_w : 0;
      lx = p.inside[h] ? t % tile_w : 0;
    }
    p.x[h] = (p.tile % tiles_x) * tile_w + lx;
    p.y[h] = (p.tile / tiles_x) * tile_h + ly;
    p.px[h] = (float)p.x[h];
    p.py[h] = (float)p.y[h];
  }
  return p;
}

// The warp's pixel rectangle (over its pixels inside the tile).
__device__ __forceinline__ Rect patch_rect(const Pixels& p) {
  int x0 = INT_MAX, x1 = INT_MIN, y0 = INT_MAX, y1 = INT_MIN;
#pragma unroll
  for (int h = 0; h < NPX; ++h) {
    if (!p.inside[h]) continue;
    x0 = min(x0, p.x[h]);
    x1 = max(x1, p.x[h]);
    y0 = min(y0, p.y[h]);
    y1 = max(y1, p.y[h]);
  }
  Rect r;
  r.x0 = __reduce_min_sync(FULL, x0);
  r.x1 = __reduce_max_sync(FULL, x1);
  r.y0 = __reduce_min_sync(FULL, y0);
  r.y1 = __reduce_max_sync(FULL, y1);
  return r;
}

// The flagged chunks c0 + bit of the 32 flags fl[c0, c0 + 32): every lane
// gets the same mask.
__device__ __forceinline__ unsigned flagged(const int* __restrict__ fl,
                                            int c0, int n_chunks) {
  const int c = c0 + (int)threadIdx.x;
  return __ballot_sync(FULL, c < n_chunks && fl[c] != 0);
}

// Whether every pixel of the warp has stopped.
__device__ __forceinline__ bool all_stopped(const bool (&stopped)[NPX]) {
  bool all = true;
#pragma unroll
  for (int h = 0; h < NPX; ++h) all = all && stopped[h];
  return __all_sync(FULL, all);
}

__global__ void __launch_bounds__(32)
stream_fwd_kernel(const float* __restrict__ data,
                  const int* __restrict__ flags, const float* __restrict__ bg,
                  float* __restrict__ out, float* __restrict__ logt, int n_pad,
                  int H, int W, int tile_h, int tile_w) {
  __shared__ Rec recs[32];
  const int tiles_x = W / tile_w, n_tiles = (H / tile_h) * tiles_x;
  const int n_chunks = n_pad / CHUNK;
  const Pixels p = pixels_of(n_tiles, tiles_x, tile_h, tile_w);
  const Rect rect = patch_rect(p);
  const float* g = data + (size_t)p.r * ROWS * n_pad;
  const int* fl = flags + ((size_t)p.r * n_tiles + p.tile) * n_chunks;

  float cr[NPX], cg[NPX], cb[NPX], log_t[NPX];  // log T after the last
  bool stopped[NPX];                            // contributing gaussian
#pragma unroll
  for (int h = 0; h < NPX; ++h) cr[h] = cg[h] = cb[h] = log_t[h] = 0.f;
  for (int f0 = 0; f0 < n_chunks; f0 += 32) {
    for (unsigned set = flagged(fl, f0, n_chunks); set; set &= set - 1) {
      const int c = f0 + __ffs((int)set) - 1;
#pragma unroll
      for (int h = 0; h < NPX; ++h) stopped[h] = !p.inside[h];  // re-arm
      for (int j0 = c * CHUNK; j0 < (c + 1) * CHUNK; j0 += 32) {
        // leave the chunk once every pixel of the warp has stopped in it
        if (all_stopped(stopped)) break;
        const int n = warp_group(recs, g, n_pad, j0, j0 + 32, rect);
        for (int k = 0; k < n; ++k) {
          const Rec& rec = recs[k];
#pragma unroll
          for (int h = 0; h < NPX; ++h)
            if (!stopped[h])
              stopped[h] = !blend(pair_of(rec, p.px[h], p.py[h]), rec,
                                  log_t[h], cr[h], cg[h], cb[h]);
        }
      }
    }
  }
#pragma unroll
  for (int h = 0; h < NPX; ++h)
    if (p.inside[h])
      write_pixel(p.r, (size_t)H * W, (size_t)p.y[h] * W + p.x[h], bg, cr[h],
                  cg[h], cb[h], log_t[h], out, logt);
}

__global__ void __launch_bounds__(32)
stream_bwd_kernel(const float* __restrict__ data,
                  const int* __restrict__ flags, const float* __restrict__ bg,
                  const float* __restrict__ logt,
                  const float* __restrict__ tot,
                  const float* __restrict__ gout, float* __restrict__ dgrad,
                  int n_pad, int H, int W, int tile_h, int tile_w) {
  __shared__ Rec recs[32];
  const int tiles_x = W / tile_w, n_tiles = (H / tile_h) * tiles_x;
  const int n_chunks = n_pad / CHUNK;
  const Pixels p = pixels_of(n_tiles, tiles_x, tile_h, tile_w);
  const int lane = threadIdx.x;
  const Rect rect = patch_rect(p);
  const float* g = data + (size_t)p.r * ROWS * n_pad;
  float* dg = dgrad + (size_t)p.r * ROWS * n_pad;
  const int* fl = flags + ((size_t)p.r * n_tiles + p.tile) * n_chunks;
  GradPixel s[NPX];
  bool stopped[NPX];
#pragma unroll
  for (int h = 0; h < NPX; ++h)
    s[h] = grad_pixel(p.inside[h], p.r, (size_t)H * W,
                      (size_t)p.y[h] * W + p.x[h], bg, logt, tot, gout);

  for (int f0 = 0; f0 < n_chunks; f0 += 32) {
    for (unsigned set = flagged(fl, f0, n_chunks); set; set &= set - 1) {
      const int c = f0 + __ffs((int)set) - 1;
#pragma unroll
      for (int h = 0; h < NPX; ++h) s[h].stopped = !p.inside[h];  // re-arm
      for (int j0 = c * CHUNK; j0 < (c + 1) * CHUNK; j0 += 32) {
#pragma unroll
        for (int h = 0; h < NPX; ++h) stopped[h] = s[h].stopped;
        if (all_stopped(stopped)) break;
        const int n = warp_group(recs, g, n_pad, j0, j0 + 32, rect);
        for (int k = 0; k < n; ++k) {
          const Rec& rec = recs[k];
          // the lane's pixels' terms, summed, then over the warp
          float v[9];
#pragma unroll
          for (int r = 0; r < 9; ++r) v[r] = 0.f;
          bool touched = false;
#pragma unroll
          for (int h = 0; h < NPX; ++h) {
            float w[9];
#pragma unroll
            for (int r = 0; r < 9; ++r) w[r] = 0.f;
            if (pair_grad(rec, p.px[h], p.py[h], s[h], w)) {
              touched = true;
#pragma unroll
              for (int r = 0; r < 9; ++r) v[r] += w[r];
            }
          }
          // the column is shared by every tile of the render: add
          if (__any_sync(FULL, touched))  // warp-uniform
            warp_sum_into(v, dg + __float_as_int(rec.s.y), n_pad, lane);
        }
      }
    }
  }
}

// (render, tile, warp) blocks ride on gridDim.x
inline bool shape_ok(int R, int n_pad, int H, int W, int tile_h, int tile_w) {
  return R > 0 && n_pad > 0 && n_pad % CHUNK == 0 && H > 0 && W > 0 &&
         tile_h > 0 && tile_w > 0 && H % tile_h == 0 && W % tile_w == 0 &&
         tile_h * tile_w <= MAX_TILE_PIXELS;
}

inline unsigned blocks_of(int R, int H, int W, int tile_h, int tile_w) {
  return (unsigned)R * (unsigned)((H / tile_h) * (W / tile_w)) *
         (unsigned)patches_of(tile_h, tile_w);
}

}  // namespace

extern "C" {

// out [R, 3, H, W], logt [R, H, W]; returns cudaGetLastError() after launch.
int stream_splat_fwd(const float* data, const int* flags, const float* bg,
                     float* out, float* logt, int R, int n_pad, int H, int W,
                     int tile_h, int tile_w, void* stream) {
  if (!shape_ok(R, n_pad, H, W, tile_h, tile_w))
    return (int)cudaErrorInvalidValue;
  stream_fwd_kernel<<<blocks_of(R, H, W, tile_h, tile_w), 32, 0,
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
  stream_bwd_kernel<<<blocks_of(R, H, W, tile_h, tile_w), 32, 0,
                      (cudaStream_t)stream>>>(data, flags, bg, logt, tot, gout,
                                              dgrad, n_pad, H, W, tile_h,
                                              tile_w);
  return (int)cudaGetLastError();
}

}  // extern "C"
