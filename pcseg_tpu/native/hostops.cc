// Native host-side runtime ops for pcseg_tpu.
//
// The per-region finalize pass runs inherently-sequential walks on the host
// (SURVEY.md §7: boundary ordering stays host-side). This library provides
// them in C++ for production-rate frame finalization, loaded via ctypes
// (pcseg_tpu/native/__init__.py) with a NumPy fallback.
//
//   pcseg_moore_trace: the reference's Moore boundary walk
//     (planar_region.h:295-353 + planar_region.cc:26-65) over a boolean
//     member mask, including the one-pixel-branch revisit handling.
//     Conscious divergence (documented in models/boundary.py + CLAUDE.md):
//     the reference's sweep backtracks to the previous boundary PIXEL and
//     loses which side the background is on — near single-pixel notches
//     the walk enters parasitic 3-cycles, and its stop rule fires early
//     on thin appendage tips, rejecting arbitrarily large regions by
//     area. This is textbook Moore-neighbor tracing with background
//     backtracking + Jacob's termination criterion instead.
//   pcseg_flood_outside: border-connected non-member flood fill (used to
//     pick an outer-boundary start pixel).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o libpcseg_hostops.so hostops.cc

#include <cstdint>
#include <vector>

namespace {

struct Dir {
  int dx, dy, didx;  // dx = col step, dy = row step, didx = dx*rows + dy
};

void neighborhood8(int rows, Dir out[8]) {
  const Dir dirs[8] = {{-1, 0, -rows},       {-1, -1, -rows - 1},
                       {0, -1, -1},          {1, -1, rows - 1},
                       {1, 0, rows},         {1, 1, rows + 1},
                       {0, 1, 1},            {-1, 1, -rows + 1}};
  for (int i = 0; i < 8; ++i) out[i] = dirs[i];
}

}  // namespace

extern "C" {

// Trace the boundary of the true-region of `mask` (col-major linear
// addressing: idx = x*rows + y) starting from `start_idx`.
// `b_dir0` is the entry-background direction index (ring order); pass 0
// (West) with the canonical col-major-first start — the textbook
// configuration whose orbit provably closes. Pass -1 for the first
// in-bounds non-member neighbor in table order (arbitrary starts; may
// trace a hole ring or fail to close).
// Returns the number of boundary indices written to `out` (capacity
// `out_cap`), 0 if start is not on a boundary or the orbit fails to
// close within the step cap, or -1 on overflow.
int64_t pcseg_moore_trace(const uint8_t* mask, int32_t rows, int32_t cols,
                          int64_t start_idx, int32_t b_dir0, int64_t* out,
                          int64_t out_cap) {
  Dir dirs[8];
  neighborhood8(rows, dirs);
  auto at = [&](int64_t idx) -> bool { return mask[idx] != 0; };

  int64_t curr_idx = start_idx;
  int32_t curr_x = int32_t(start_idx / rows);
  int32_t curr_y = int32_t(start_idx % rows);

  int b_dir = b_dir0;
  if (b_dir < 0) {
    for (int i = 0; i < 8; ++i) {
      int x = curr_x + dirs[i].dx, y = curr_y + dirs[i].dy;
      if (x >= 0 && x < cols && y >= 0 && y < rows &&
          !at(curr_idx + dirs[i].didx)) {
        b_dir = i;
        break;
      }
    }
    if (b_dir < 0) return 0;
  }

  // REL[m]: direction index of dirs[m-1] - dirs[m] (the new pixel's view
  // of the last background cell scanned before entering it).
  int rel[8];
  for (int m = 0; m < 8; ++m) {
    int vx = dirs[(m + 7) % 8].dx - dirs[m].dx;
    int vy = dirs[(m + 7) % 8].dy - dirs[m].dy;
    for (int i = 0; i < 8; ++i) {
      if (dirs[i].dx == vx && dirs[i].dy == vy) {
        rel[m] = i;
        break;
      }
    }
  }

  int64_t n = 0;
  if (n >= out_cap) return -1;
  out[n++] = start_idx;
  // Terminate on ANY (pixel, background-direction) state recurrence: the
  // walk map is deterministic, so the first repeat closes the contour
  // cycle (the initial state may be a 1-state tail when the re-entry
  // background differs from the seeded West anchor).
  std::vector<uint8_t> seen(int64_t(rows) * cols, 0);
  seen[start_idx] = uint8_t(1u << b_dir);
  while (true) {
    int new_dir = -1;
    for (int delta = 1; delta <= 8; ++delta) {
      int ndi = (b_dir + delta) % 8;
      int x = curr_x + dirs[ndi].dx, y = curr_y + dirs[ndi].dy;
      if (x >= 0 && x < cols && y >= 0 && y < rows &&
          at(curr_idx + dirs[ndi].didx)) {
        new_dir = ndi;
        break;
      }
    }
    if (new_dir < 0) return n;  // isolated pixel
    b_dir = rel[new_dir];
    curr_idx += dirs[new_dir].didx;
    curr_x += dirs[new_dir].dx;
    curr_y += dirs[new_dir].dy;

    const uint8_t bit = uint8_t(1u << b_dir);
    if (seen[curr_idx] & bit) return n;
    seen[curr_idx] |= bit;
    if (n >= out_cap) return -1;
    out[n++] = curr_idx;
  }
}

// Mark all non-member cells 4-connected to the grid border.
// mask/out are col-major [rows*cols] uint8; out must be zero-initialized.
void pcseg_flood_outside(const uint8_t* mask, int32_t rows, int32_t cols,
                         uint8_t* out) {
  std::vector<int64_t> stack;
  auto push = [&](int64_t idx) {
    if (!mask[idx] && !out[idx]) {
      out[idx] = 1;
      stack.push_back(idx);
    }
  };
  for (int32_t x = 0; x < cols; ++x) {
    push(int64_t(x) * rows);
    push(int64_t(x) * rows + rows - 1);
  }
  for (int32_t y = 0; y < rows; ++y) {
    push(y);
    push(int64_t(cols - 1) * rows + y);
  }
  while (!stack.empty()) {
    int64_t idx = stack.back();
    stack.pop_back();
    int32_t x = int32_t(idx / rows), y = int32_t(idx % rows);
    if (y > 0) push(idx - 1);
    if (y + 1 < rows) push(idx + 1);
    if (x > 0) push(idx - rows);
    if (x + 1 < cols) push(idx + rows);
  }
}

}  // extern "C"

extern "C" {

// Andrew monotone-chain 2-D convex hull over [n, 2] float64 points (already
// deduplicated + lexsorted by the caller). Writes CCW hull vertex INDICES
// into ``out`` (capacity n) and returns their count. Moved from the
// pure-Python hostgeom.convex_hull_2d: the per-point Python loop was the
// host finalize's hottest spot (~43 ms/VGA-frame; this is ~microseconds).
int64_t pcseg_convex_hull_2d(const double* pts, int64_t n, int64_t* out) {
  if (n <= 2) {
    for (int64_t i = 0; i < n; ++i) out[i] = i;
    return n;
  }
  auto cross = [&](int64_t o, int64_t a, int64_t b) {
    const double ox = pts[2 * o], oy = pts[2 * o + 1];
    return (pts[2 * a] - ox) * (pts[2 * b + 1] - oy) -
           (pts[2 * a + 1] - oy) * (pts[2 * b] - ox);
  };
  std::vector<int64_t> h(2 * n);
  int64_t k = 0;
  for (int64_t i = 0; i < n; ++i) {  // lower
    while (k >= 2 && cross(h[k - 2], h[k - 1], i) <= 0) --k;
    h[k++] = i;
  }
  const int64_t lower = k + 1;
  for (int64_t i = n - 2; i >= 0; --i) {  // upper
    while (k >= lower && cross(h[k - 2], h[k - 1], i) <= 0) --k;
    h[k++] = i;
  }
  --k;  // last point == first
  for (int64_t i = 0; i < k; ++i) out[i] = h[i];
  return k;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// SlidingMeanShift over a voxel cell grid (the config-3 serving fast path).
//
// After voxelization a ~1M-point cloud reduces to ~10-20k occupied cells:
// little enough work for one core.
// Same semantics as models/mean_shift.py's mean_shift_modes (device
// fixed point: sticky support cutoff, dual 3-D + fractional-index shift,
// constants of mean_shift_segmentation.h:31-51) + grow_mean_shift_regions
// (FIFO growth with the dual centroid/neighbor gate, intensity-ascending
// stable mode order, acceptance suppression, :262-328); loop orders
// mirrored so membership matches (agreement-tested in tests/).
// ---------------------------------------------------------------------------

#include <cmath>
#include <deque>
#include <algorithm>

namespace {

struct MsV3 { float x, y, z; };

inline float ms_sq(float v) { return v * v; }
inline float ms_d2(const MsV3& a, const MsV3& b) {
  return ms_sq(a.x - b.x) + ms_sq(a.y - b.y) + ms_sq(a.z - b.z);
}

}  // namespace

extern "C" {

// cell_pts: [gx*gy*3] f32 centroids (garbage where !occ); occ: [gx*gy] u8;
// labels (out): [gx*gy] i32, pre-filled with `unlabeled`; accepted region
// ids are unlabeled_offset, unlabeled_offset+1, ... Returns #regions.
int32_t pcseg_mean_shift_grid(
    const float* cell_pts, const uint8_t* occ, int32_t gx, int32_t gy,
    int32_t iterations, int32_t half_win, float sq_dist, float min_support,
    float sq_centroid, float sq_neighbor, int32_t min_inliers,
    int32_t unlabeled, int32_t id_offset, int32_t* labels) {
  const int cells = gx * gy;
  const MsV3* cell = reinterpret_cast<const MsV3*>(cell_pts);

  std::vector<MsV3> mode(cells);
  std::vector<float> fr(cells), fc(cells);
  std::vector<uint8_t> valid(cells, 0);
  std::vector<float> intensity(cells, 1.0f);
  for (int c = 0; c < cells; ++c) {
    if (!occ[c] || labels[c] != unlabeled) continue;
    mode[c] = cell[c];
    fr[c] = float(c / gy);
    fc[c] = float(c % gy);
    valid[c] = 1;
  }
  // neighbor eligibility is fixed at entry (unlabeled & occupied),
  // mirroring mean_shift_modes' neighbor_ok_grid
  std::vector<uint8_t> nb_ok(cells, 0);
  for (int c = 0; c < cells; ++c)
    nb_ok[c] = occ[c] && labels[c] == unlabeled;

  for (int it = 0; it < iterations; ++it) {
    for (int c = 0; c < cells; ++c) {
      if (!valid[c]) continue;
      const int r0 = int(std::lround(fr[c]));
      const int c0 = int(std::lround(fc[c]));
      double dx = 0, dy = 0, dz = 0, dri = 0, dci = 0;
      int support = 0;
      for (int dr = -half_win; dr <= half_win; ++dr) {
        const int rr = r0 + dr;
        if (rr < 0 || rr >= gx) continue;
        for (int dc = -half_win; dc <= half_win; ++dc) {
          const int cc = c0 + dc;
          if (cc < 0 || cc >= gy) continue;
          const int q = rr * gy + cc;
          if (!nb_ok[q]) continue;
          if (ms_d2(cell[q], mode[c]) > sq_dist) continue;
          dx += cell[q].x - mode[c].x;
          dy += cell[q].y - mode[c].y;
          dz += cell[q].z - mode[c].z;
          dri += rr - fr[c];
          dci += cc - fc[c];
          ++support;
        }
      }
      if (float(support) < min_support) { valid[c] = 0; continue; }
      mode[c].x += float(dx / support);
      mode[c].y += float(dy / support);
      mode[c].z += float(dz / support);
      fr[c] += float(dri / support);
      fc[c] += float(dci / support);
      intensity[c] = float(support);
    }
  }

  std::vector<int32_t> order;
  order.reserve(cells);
  for (int c = 0; c < cells; ++c) if (valid[c]) order.push_back(c);
  std::stable_sort(order.begin(), order.end(),
                   [&](int a, int b) { return intensity[a] < intensity[b]; });

  std::vector<uint8_t> suppressed(cells, 0);
  std::deque<int32_t> q;
  std::vector<int32_t> inliers;
  int regions = 0;
  for (size_t oi = 0; oi < order.size(); ++oi) {
    const int s = order[oi];
    if (suppressed[s]) continue;
    const MsV3 seed = mode[s];
    const int r0 = int(std::lround(fr[s]));
    const int c0 = int(std::lround(fc[s]));
    if (r0 < 0 || r0 >= gx || c0 < 0 || c0 >= gy) continue;
    const int label_id = id_offset + regions;
    inliers.clear();
    q.clear();
    q.push_back(r0 * gy + c0);
    bool first = true;
    while (!q.empty()) {
      const int center = q.front(); q.pop_front();
      const int cr = center / gy, cc0 = center % gy;
      const MsV3 cp = cell[center];
      for (int dc = -1; dc <= 1; ++dc) {        // dc outer: the exact
        for (int dr = -1; dr <= 1; ++dr) {      // FIFO port's loop order
          if (!first && dc == 0 && dr == 0) continue;
          const int rr = cr + dr, ccc = cc0 + dc;
          if (rr < 0 || rr >= gx || ccc < 0 || ccc >= gy) continue;
          const int cand = rr * gy + ccc;
          if (labels[cand] != unlabeled || !occ[cand]) continue;
          if (ms_d2(cell[cand], seed) > sq_centroid) {
            if (first || ms_d2(cell[cand], cp) > sq_neighbor) continue;
          }
          labels[cand] = label_id;
          inliers.push_back(cand);
          q.push_back(cand);
        }
      }
      first = false;
    }
    if (int(inliers.size()) >= min_inliers) {
      for (size_t oj = oi + 1; oj < order.size(); ++oj) {
        if (ms_d2(mode[order[oj]], seed) < sq_centroid)
          suppressed[order[oj]] = 1;
      }
      ++regions;
    } else {
      for (int c : inliers) labels[c] = unlabeled;
    }
  }
  return regions;
}

}  // extern "C"

extern "C" {

// End-to-end config-3 fast path: voxelize [n, 3] points to a gx*gy XY
// cell-centroid grid (origin = min of finite XY when origin_x/y = NaN),
// run pcseg_mean_shift_grid, scatter labels back to points. Writes
// point_labels [n] i32 (-1 unclustered) and cell labels [gx*gy] i32;
// returns #regions. Mirrors ops/voxelize.voxelize_xy semantics.
int32_t pcseg_mean_shift_points(
    const float* pts, int64_t n, int32_t gx, int32_t gy, float cell_size,
    float origin_x, float origin_y, int32_t iterations, int32_t half_win,
    float sq_dist, float min_support, float sq_centroid, float sq_neighbor,
    int32_t min_inliers, int32_t id_offset, int32_t* point_labels,
    int32_t* cell_labels) {
  const int cells = gx * gy;
  float minx = origin_x, miny = origin_y;
  if (!std::isfinite(minx) || !std::isfinite(miny)) {
    minx = 1e30f; miny = 1e30f;
    for (int64_t i = 0; i < n; ++i) {
      const float x = pts[3 * i], y = pts[3 * i + 1], z = pts[3 * i + 2];
      if (std::isfinite(x) && std::isfinite(y) && std::isfinite(z)) {
        minx = std::min(minx, x);
        miny = std::min(miny, y);
      }
    }
  }
  std::vector<double> sx(cells, 0), sy(cells, 0), sz(cells, 0);
  std::vector<int32_t> cnt(cells, 0);
  std::vector<int32_t> point_cell(n, -1);
  for (int64_t i = 0; i < n; ++i) {
    const float x = pts[3 * i], y = pts[3 * i + 1], z = pts[3 * i + 2];
    if (!(std::isfinite(x) && std::isfinite(y) && std::isfinite(z)))
      continue;
    const int ix = int(std::floor((x - minx) / cell_size));
    const int iy = int(std::floor((y - miny) / cell_size));
    if (ix < 0 || ix >= gx || iy < 0 || iy >= gy) continue;
    const int c = ix * gy + iy;
    sx[c] += x; sy[c] += y; sz[c] += z; ++cnt[c];
    point_cell[i] = c;
  }
  std::vector<float> cell(3 * cells, 0.0f);
  std::vector<uint8_t> occ(cells, 0);
  for (int c = 0; c < cells; ++c) {
    if (cnt[c] > 0) {
      cell[3 * c] = float(sx[c] / cnt[c]);
      cell[3 * c + 1] = float(sy[c] / cnt[c]);
      cell[3 * c + 2] = float(sz[c] / cnt[c]);
      occ[c] = 1;
    }
    cell_labels[c] = -1;
  }
  const int32_t regions = pcseg_mean_shift_grid(
      cell.data(), occ.data(), gx, gy, iterations, half_win, sq_dist,
      min_support, sq_centroid, sq_neighbor, min_inliers, -1, id_offset,
      cell_labels);
  for (int64_t i = 0; i < n; ++i) {
    point_labels[i] =
        point_cell[i] >= 0 ? cell_labels[point_cell[i]] : -1;
  }
  return regions;
}

}  // extern "C"

extern "C" {

// Euclidean clustering of an unorganized cloud via the voxel grid (the
// config-3 euclidean fast path; mirrors models/unorganized.py
// cluster_unorganized semantics exactly): voxelize, union-find over the
// (2w+1)^2 window edges gated by ||cell_i - cell_j||^2 < sq_dist, dense
// component ids in ascending min-root (col-major) order, size gate on
// POINT counts, labels scattered to points. Returns #regions.
int32_t pcseg_cluster_unorganized(
    const float* pts, int64_t n, int32_t gx, int32_t gy, float cell_size,
    float origin_x, float origin_y, int32_t half_win, float sq_dist,
    int32_t min_point_inliers, int32_t* point_labels,
    int32_t* cell_labels) {
  const int cells = gx * gy;
  float minx = origin_x, miny = origin_y;
  if (!std::isfinite(minx) || !std::isfinite(miny)) {
    minx = 1e30f; miny = 1e30f;
    for (int64_t i = 0; i < n; ++i) {
      const float x = pts[3 * i], y = pts[3 * i + 1], z = pts[3 * i + 2];
      if (std::isfinite(x) && std::isfinite(y) && std::isfinite(z)) {
        minx = std::min(minx, x);
        miny = std::min(miny, y);
      }
    }
  }
  std::vector<double> sx(cells, 0), sy(cells, 0), sz(cells, 0);
  std::vector<int32_t> cnt(cells, 0);
  std::vector<int32_t> point_cell(n, -1);
  for (int64_t i = 0; i < n; ++i) {
    const float x = pts[3 * i], y = pts[3 * i + 1], z = pts[3 * i + 2];
    if (!(std::isfinite(x) && std::isfinite(y) && std::isfinite(z)))
      continue;
    const int ix = int(std::floor((x - minx) / cell_size));
    const int iy = int(std::floor((y - miny) / cell_size));
    if (ix < 0 || ix >= gx || iy < 0 || iy >= gy) continue;
    const int c = ix * gy + iy;
    sx[c] += x; sy[c] += y; sz[c] += z; ++cnt[c];
    point_cell[i] = c;
  }
  std::vector<MsV3> cell(cells);
  for (int c = 0; c < cells; ++c) {
    if (cnt[c] > 0)
      cell[c] = {float(sx[c] / cnt[c]), float(sy[c] / cnt[c]),
                 float(sz[c] / cnt[c])};
  }

  // union-find keyed by COL-MAJOR cell index (iy * gx + ix), matching the
  // device CCL's root convention so dense ids come out identical
  auto colmajor = [&](int c) { return (c % gy) * gx + (c / gy); };
  std::vector<int32_t> parent(cells);
  for (int c = 0; c < cells; ++c) parent[c] = c;
  std::vector<int32_t> find_stack;
  auto find = [&](int a) {
    while (parent[a] != a) { parent[a] = parent[parent[a]]; a = parent[a]; }
    return a;
  };
  auto unite = [&](int a, int b) {
    a = find(a); b = find(b);
    if (a == b) return;
    // keep the smaller col-major index as root
    if (colmajor(a) < colmajor(b)) parent[b] = a; else parent[a] = b;
  };
  for (int ix = 0; ix < gx; ++ix) {
    for (int iy = 0; iy < gy; ++iy) {
      const int c = ix * gy + iy;
      if (!cnt[c]) continue;
      for (int dx = 0; dx <= half_win; ++dx) {
        for (int dy = (dx == 0 ? 1 : -half_win); dy <= half_win; ++dy) {
          const int jx = ix + dx, jy = iy + dy;
          if (jx < 0 || jx >= gx || jy < 0 || jy >= gy) continue;
          const int q = jx * gy + jy;
          if (!cnt[q]) continue;
          if (ms_d2(cell[c], cell[q]) < sq_dist) unite(c, q);
        }
      }
    }
  }

  // per-component point counts; accepted roots in ascending col-major
  std::vector<int64_t> comp_pts(cells, 0);
  for (int c = 0; c < cells; ++c)
    if (cnt[c]) comp_pts[find(c)] += cnt[c];
  std::vector<int32_t> roots;
  for (int c = 0; c < cells; ++c)
    if (cnt[c] && find(c) == c && comp_pts[c] >= min_point_inliers)
      roots.push_back(c);
  std::sort(roots.begin(), roots.end(),
            [&](int a, int b) { return colmajor(a) < colmajor(b); });
  std::vector<int32_t> id_of(cells, -1);
  for (size_t i = 0; i < roots.size(); ++i) id_of[roots[i]] = int(i);

  for (int c = 0; c < cells; ++c)
    cell_labels[c] = cnt[c] ? id_of[find(c)] : -1;
  for (int64_t i = 0; i < n; ++i)
    point_labels[i] = point_cell[i] >= 0 ? cell_labels[point_cell[i]] : -1;
  return int32_t(roots.size());
}

}  // extern "C"
