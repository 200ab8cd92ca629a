// Farthest point sampling on the host, for the PTv3 ScanNet pipeline's FPS
// cap (unipre3d_tpu_torch/data/transforms.py:FPS).
//
// Port of unipre3d_tpu/native/src/host_ops.cpp:fps, on one thread: each
// sample's pass updates every point's distance to the sampled set and takes
// the largest, in vectorized loops over the coordinates held as three
// columns, then the first point that holds it. The first index of the
// maximum is numpy's argmax, so the result equals the plain numpy reference
// (native/__init__.py:host_fps_ref) bit for bit, ties included; the squared
// distance is summed as (dx*dx + dy*dy) + dz*dz with no fused multiply-add
// (-ffp-contract=off), the reference's rounding. The JAX package splits the
// points over OpenMP threads, which meet once a sample and break ties in
// the order they arrive; a thread that the host deschedules then stalls
// every sample, and the input pipeline's reader threads already run one
// cloud each.
//
// C linkage, consumed through ctypes (native/__init__.py).

#include <cstdint>
#include <limits>
#include <vector>

extern "C" {

// xyz: [n, 3] row-major float32; out: [m] indices, out[0] = 0.
void fps(const float* xyz, int n, int m, int32_t* out) {
  if (n <= 0 || m <= 0) return;
  std::vector<float> xs(n), ys(n), zs(n),
      dist(n, std::numeric_limits<float>::infinity());
  for (int j = 0; j < n; ++j) {
    xs[j] = xyz[3 * j];
    ys[j] = xyz[3 * j + 1];
    zs[j] = xyz[3 * j + 2];
  }
  const float* __restrict x = xs.data();
  const float* __restrict y = ys.data();
  const float* __restrict z = zs.data();
  float* __restrict d = dist.data();
  int cur = 0;
  out[0] = 0;
  for (int i = 1; i < m; ++i) {
    const float cx = x[cur], cy = y[cur], cz = z[cur];
    float best = -1.f;
    for (int j = 0; j < n; ++j) {
      const float dx = x[j] - cx, dy = y[j] - cy, dz = z[j] - cz;
      const float d2 = dx * dx + dy * dy + dz * dz;
      const float v = d2 < d[j] ? d2 : d[j];
      d[j] = v;
      best = v > best ? v : best;
    }
    int j = 0;
    while (d[j] != best) ++j;
    cur = j;
    out[i] = cur;
  }
}

}  // extern "C"
