// Single-core C++ measurement baseline for BASELINE config 3:
// mean-shift clustering of a ~1M-point unorganized cloud.
//
// The reference cannot run this config meaningfully — it treats
// unorganized clouds as 1-row grids (multichannel_cloud.proto:39-40),
// where the 11x11 index window of SlidingMeanShift degenerates to a
// 1x11 linear strip. This program therefore implements the SAME
// algorithm as pcseg_tpu's device path (voxelize to an XY cell-centroid
// grid, SlidingMeanShift over the organized cell grid with the
// reference's constants from mean_shift_segmentation.h:31-51, FIFO mode
// growth + suppression per :262-328, labels scattered back to points) in
// optimized single-threaded C++ — the measurement stand-in, exactly like
// cpp_baseline.cc for configs 1-2 (BASELINE.md: the reference publishes
// no numbers and cannot be built offline).
//
// Independent implementation: own types, own control flow; no Eigen.
//
// Input: binary file  int32 n, then n * 3 float32 (x, y, z).
// Output: one JSON line {"total_ms": ..., "regions": ..., "labeled": ...}
//
// Build: g++ -O3 -march=native -std=c++17 -o cpp_baseline_meanshift \
//          cpp_baseline_meanshift.cc

#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <vector>
#include <algorithm>

namespace {

constexpr int kGx = 512, kGy = 512;
constexpr float kCell = 0.125f;
constexpr int kHalfWin = 5;                      // kHalfSearchWindow
constexpr float kSqDist = 1.0f;                  // window spatial gate
constexpr float kMinSupport = 0.5f * kHalfWin * kHalfWin * 4;  // 50
constexpr int kIterations = 5;
constexpr float kSqCentroid = 1.0f;              // growth centroid gate
constexpr float kSqNeighbor = 0.04f;             // growth neighbor gate
constexpr int kMinInliers = 7;
constexpr int kUnlabeled = -1;

struct V3 { float x, y, z; };

inline float sq(float v) { return v * v; }
inline float d2(const V3& a, const V3& b) {
  return sq(a.x - b.x) + sq(a.y - b.y) + sq(a.z - b.z);
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 2) { std::fprintf(stderr, "usage: %s cloud.bin\n", argv[0]);
                  return 1; }
  FILE* f = std::fopen(argv[1], "rb");
  if (!f) { std::perror("open"); return 1; }
  int32_t n = 0;
  if (std::fread(&n, 4, 1, f) != 1) return 1;
  std::vector<V3> pts(n);
  if (std::fread(pts.data(), sizeof(V3), n, f) != size_t(n)) return 1;
  std::fclose(f);

  const auto t0 = std::chrono::steady_clock::now();

  // ---- voxelize: cell centroids over an XY grid anchored at the min ----
  float minx = 1e30f, miny = 1e30f;
  for (const V3& p : pts) {
    if (std::isfinite(p.x) && std::isfinite(p.y) && std::isfinite(p.z)) {
      minx = std::min(minx, p.x);
      miny = std::min(miny, p.y);
    }
  }
  const int cells = kGx * kGy;
  std::vector<double> sx(cells, 0), sy(cells, 0), sz(cells, 0);
  std::vector<int32_t> cnt(cells, 0);
  std::vector<int32_t> point_cell(n, -1);
  for (int i = 0; i < n; ++i) {
    const V3& p = pts[i];
    if (!(std::isfinite(p.x) && std::isfinite(p.y) && std::isfinite(p.z)))
      continue;
    const int ix = int(std::floor((p.x - minx) / kCell));
    const int iy = int(std::floor((p.y - miny) / kCell));
    if (ix < 0 || ix >= kGx || iy < 0 || iy >= kGy) continue;
    const int c = ix * kGy + iy;
    sx[c] += p.x; sy[c] += p.y; sz[c] += p.z; ++cnt[c];
    point_cell[i] = c;
  }
  std::vector<V3> cell(cells);
  std::vector<uint8_t> occ(cells, 0);
  for (int c = 0; c < cells; ++c) {
    if (cnt[c] > 0) {
      cell[c] = {float(sx[c] / cnt[c]), float(sy[c] / cnt[c]),
                 float(sz[c] / cnt[c])};
      occ[c] = 1;
    }
  }

  // ---- mean-shift fixed point over every occupied cell ------------------
  // (mean_shift_segmentation.h:219-260: shift in 3-D AND fractional index)
  std::vector<V3> mode(cells);
  std::vector<float> fr(cells), fc(cells);      // fractional (row=x, col=y)
  std::vector<uint8_t> valid(cells, 0);
  std::vector<float> intensity(cells, 1.0f);
  for (int c = 0; c < cells; ++c) {
    if (!occ[c]) continue;
    mode[c] = cell[c];
    fr[c] = float(c / kGy);
    fc[c] = float(c % kGy);
    valid[c] = 1;
  }
  for (int it = 0; it < kIterations; ++it) {
    for (int c = 0; c < cells; ++c) {
      if (!valid[c]) continue;
      const int r0 = int(std::lround(fr[c]));
      const int c0 = int(std::lround(fc[c]));
      double dx = 0, dy = 0, dz = 0, dri = 0, dci = 0;
      int support = 0;
      for (int dr = -kHalfWin; dr <= kHalfWin; ++dr) {
        const int rr = r0 + dr;
        if (rr < 0 || rr >= kGx) continue;
        for (int dc = -kHalfWin; dc <= kHalfWin; ++dc) {
          const int cc = c0 + dc;
          if (cc < 0 || cc >= kGy) continue;
          const int q = rr * kGy + cc;
          if (!occ[q]) continue;
          if (d2(cell[q], mode[c]) > kSqDist) continue;
          dx += cell[q].x - mode[c].x;
          dy += cell[q].y - mode[c].y;
          dz += cell[q].z - mode[c].z;
          dri += rr - fr[c];
          dci += cc - fc[c];
          ++support;
        }
      }
      if (support < kMinSupport) { valid[c] = 0; continue; }
      mode[c].x += float(dx / support);
      mode[c].y += float(dy / support);
      mode[c].z += float(dz / support);
      fr[c] += float(dri / support);
      fc[c] += float(dci / support);
      intensity[c] = float(support);
    }
  }

  // ---- mode ordering (intensity ascending, stable) + FIFO growth --------
  std::vector<int32_t> order;
  order.reserve(cells);
  for (int c = 0; c < cells; ++c) if (valid[c]) order.push_back(c);
  std::stable_sort(order.begin(), order.end(),
                   [&](int a, int b) { return intensity[a] < intensity[b]; });

  std::vector<int32_t> labels(cells, kUnlabeled);
  std::vector<uint8_t> suppressed(cells, 0);
  std::vector<V3> accepted_seeds;
  std::deque<int32_t> q;
  std::vector<int32_t> inliers;
  int regions = 0;
  for (size_t oi = 0; oi < order.size(); ++oi) {
    const int s = order[oi];
    if (suppressed[s]) continue;
    const V3 seed = mode[s];
    const int r0 = int(std::lround(fr[s]));
    const int c0 = int(std::lround(fc[s]));
    if (r0 < 0 || r0 >= kGx || c0 < 0 || c0 >= kGy) continue;
    // no claimed-start pre-check: the reference's FIFO walk still grows
    // from a claimed start's unlabeled neighbors (grow_mean_shift_regions
    // port; mirrored by hostops.pcseg_mean_shift_grid)
    inliers.clear();
    q.clear();
    q.push_back(r0 * kGy + c0);
    bool first = true;
    while (!q.empty()) {
      const int center = q.front(); q.pop_front();
      const int cr = center / kGy, cc = center % kGy;
      const V3 cp = cell[center];
      for (int dc = -1; dc <= 1; ++dc) {
        for (int dr = -1; dr <= 1; ++dr) {
          if (!first && dc == 0 && dr == 0) continue;
          const int rr = cr + dr, ccc = cc + dc;
          if (rr < 0 || rr >= kGx || ccc < 0 || ccc >= kGy) continue;
          const int cand = rr * kGy + ccc;
          if (labels[cand] != kUnlabeled || !occ[cand]) continue;
          if (d2(cell[cand], seed) > kSqCentroid) {
            if (first || d2(cell[cand], cp) > kSqNeighbor) continue;
          }
          labels[cand] = regions;
          inliers.push_back(cand);
          q.push_back(cand);
        }
      }
      first = false;
    }
    if (int(inliers.size()) >= kMinInliers) {
      for (size_t oj = oi + 1; oj < order.size(); ++oj) {
        if (d2(mode[order[oj]], seed) < kSqCentroid)
          suppressed[order[oj]] = 1;
      }
      accepted_seeds.push_back(seed);
      ++regions;
    } else {
      for (int c : inliers) labels[c] = kUnlabeled;
    }
  }

  // ---- scatter cell labels back to points -------------------------------
  int64_t labeled = 0;
  for (int i = 0; i < n; ++i) {
    if (point_cell[i] >= 0 && labels[point_cell[i]] >= 0) ++labeled;
  }

  const auto t1 = std::chrono::steady_clock::now();
  const double ms =
      std::chrono::duration<double, std::milli>(t1 - t0).count();
  std::printf("{\"total_ms\": %.3f, \"regions\": %d, \"labeled\": %lld}\n",
              ms, regions, static_cast<long long>(labeled));
  return 0;
}
