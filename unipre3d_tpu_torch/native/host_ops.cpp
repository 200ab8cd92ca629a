// Host-side point-cloud ops: farthest point sampling (the PTv3 ScanNet
// pipeline's FPS cap, unipre3d_tpu_torch/data/transforms.py:FPS), the
// first-point-per-voxel grid dedup and brute-force kNN.
//
// fps: port of unipre3d_tpu/native/src/host_ops.cpp:fps, on one thread: each
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

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <unordered_map>
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

// Voxel-grid dedup (port of unipre3d_tpu/native/src/host_ops.cpp:
// grid_subsample): keeps the first input row of each occupied voxel, in
// input order. The voxel of a row is floor((x - min) / grid_size) per axis
// in float32; voxels are keyed by their three coordinates' low 21 bits.
// Returns the number of rows kept; their indices in out_idx (capacity n),
// their voxel coordinates in out_grid ([n, 3]).
int grid_subsample(const float* xyz, int n, float grid_size,
                   const float* min_coord, int32_t* out_idx,
                   int32_t* out_grid) {
  std::unordered_map<uint64_t, int32_t> seen;
  seen.reserve(static_cast<size_t>(n) * 2);
  int kept = 0;
  for (int i = 0; i < n; ++i) {
    int64_t g[3];
    for (int a = 0; a < 3; ++a)
      g[a] = static_cast<int64_t>(
          std::floor((xyz[3 * i + a] - min_coord[a]) / grid_size));
    const uint64_t key = (static_cast<uint64_t>(g[0] & 0x1FFFFF) << 42) |
                         (static_cast<uint64_t>(g[1] & 0x1FFFFF) << 21) |
                         static_cast<uint64_t>(g[2] & 0x1FFFFF);
    if (seen.emplace(key, kept).second) {
      out_idx[kept] = i;
      for (int a = 0; a < 3; ++a)
        out_grid[3 * kept + a] = static_cast<int32_t>(g[a]);
      ++kept;
    }
  }
  return kept;
}

// Brute-force kNN (port of unipre3d_tpu/native/src/host_ops.cpp:knn, on one
// thread): query [nq, 3], support [ns, 3] -> idx [nq, k], d2 [nq, k] in
// ascending squared distance, (dx*dx + dy*dy) + dz*dz with dx = s - q. An
// insertion keeps the k best: a support point enters only below the k-th
// and moves ahead of strictly larger ones, so equal distances keep the
// lower index first. k <= ns.
void knn(const float* query, int nq, const float* support, int ns, int k,
         int32_t* out_idx, float* out_d2) {
  std::vector<float> best_d(k);
  std::vector<int32_t> best_i(k);
  for (int i = 0; i < nq; ++i) {
    const float qx = query[3 * i], qy = query[3 * i + 1],
                qz = query[3 * i + 2];
    std::fill(best_d.begin(), best_d.end(),
              std::numeric_limits<float>::max());
    std::fill(best_i.begin(), best_i.end(), 0);
    for (int j = 0; j < ns; ++j) {
      const float dx = support[3 * j] - qx, dy = support[3 * j + 1] - qy,
                  dz = support[3 * j + 2] - qz;
      const float d2 = dx * dx + dy * dy + dz * dz;
      if (d2 < best_d[k - 1]) {
        int p = k - 1;
        while (p > 0 && best_d[p - 1] > d2) {
          best_d[p] = best_d[p - 1];
          best_i[p] = best_i[p - 1];
          --p;
        }
        best_d[p] = d2;
        best_i[p] = j;
      }
    }
    for (int p = 0; p < k; ++p) {
      out_idx[static_cast<size_t>(i) * k + p] = best_i[p];
      out_d2[static_cast<size_t>(i) * k + p] = best_d[p];
    }
  }
}

}  // extern "C"
