"""Sequential NumPy oracle of the reference C++ semantics.

This module is a *validation harness*, not the device compute path: it
mirrors, step for step, the pointer-chasing algorithms of
``theteamatx/x-edr-pointcloud-segmentation`` so
the device kernels in :mod:`pcseg_tpu.ops` / :mod:`pcseg_tpu.models` can be
checked for per-point label agreement on arbitrary synthetic clouds — the
BASELINE.json north-star metric — without building the C++ (its bazel deps
are unreachable offline). It also serves as the single-core CPU reference
for benchmark speedups.

Faithfulness notes (all file:line into pointcloud_segmentation):
  * Grids are stored [H, W, ...] numpy arrays; linear indices follow the
    reference's col-major convention ``idx = col * rows + row``
    (cloud.h:37-41).
  * The seed finders reproduce the reference's *transposed* grid accesses
    (``points.AtUnsafe(col, row)`` against a (row, col) signature,
    segmentation.h:66,104,208-209) — harmless on the square grids all
    fixtures use, replicated here for bit-parity.
  * ``PlanarRegionOracle.check_and_finalize`` implements the **intended**
    semantics: the reference never resizes ``projected_boundary_points_``
    before writing the hull into it (algorithms.h:540-548 writes AtUnsafe
    into a 0-sized buffer) so its ``Size() < 3`` gate (planar_region.h:217)
    rejects every region; we size the hull buffer correctly and gate on the
    actual hull size. Set ``replicate_hull_bug=True`` to reproduce the
    reference's reject-everything behavior.
  * Float accumulation runs in float32 like the C++; the reference's own
    tests accept 1e-4 normal error from ordering (plane_estimator_test.cc:34).
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import List, Optional, Tuple

import numpy as np

from pcseg_tpu.models.config import (
    UNLABELED, MASKED_OUT, IN_QUEUE, EXAMINED, MASKED_EGO,
    ComputeNormalsParams, PlanarRegionConfig, ClusterRegionConfig,
    MeanShiftParams, PlaneClassificationConfig, PlaneClass,
)
from pcseg_tpu.utils import hostgeom

FLT_MIN = np.float32(1.1754944e-38)


# ---------------------------------------------------------------------------
# Index helpers (cloud.h:37-63; col-major default)
# ---------------------------------------------------------------------------

def lin(row: int, col: int, rows: int) -> int:
    return col * rows + row


def to_rc(index: int, rows: int) -> Tuple[int, int]:
    return index % rows, index // rows


def at_lin(grid: np.ndarray, index: int):
    """grid[H, W, ...] accessed by col-major linear index."""
    rows = grid.shape[0]
    return grid[index % rows, index // rows]


def set_lin(grid: np.ndarray, index: int, value) -> None:
    rows = grid.shape[0]
    grid[index % rows, index // rows] = value


# ---------------------------------------------------------------------------
# Planes (Eigen Hyperplane convention) and PlaneEstimator
# ---------------------------------------------------------------------------

def plane_from_normal_point(normal, point):
    n = np.asarray(normal, np.float32)
    return np.concatenate([n, [-np.dot(n, np.asarray(point, np.float32))]])


def plane_signed_distance(plane, x):
    return float(np.dot(plane[:3], np.asarray(x, np.float32)) + plane[3])


def plane_abs_distance(plane, x):
    return abs(plane_signed_distance(plane, x))


def eig3x3_roots_f32(cov: np.ndarray) -> np.ndarray:
    """Ascending eigenvalues of a symmetric 3x3 via the same shifted/scaled
    trigonometric closed form as Eigen's computeDirect, in float32.

    Degenerate fixtures rely on the exact-f32 zeros this formula produces
    (e.g. plane_estimator_test.cc:110-121 expects a perfectly collinear set
    to yield lambda_1 == 0 <= FLT_MIN); a double-precision eigh leaves
    ~1e-17 noise and flips the validity gate.
    """
    cov = cov.astype(np.float32)
    shift = np.float32(np.trace(cov) / 3.0)
    scaled = cov - shift * np.eye(3, dtype=np.float32)
    scale = np.float32(np.max(np.abs(scaled)))
    if scale > 0:
        scaled = scaled / scale
    else:
        scale = np.float32(1.0)
    m = scaled
    c0 = np.float32(m[0, 0] * m[1, 1] * m[2, 2]
                    + 2.0 * m[0, 1] * m[0, 2] * m[1, 2]
                    - m[0, 0] * m[1, 2] * m[1, 2]
                    - m[1, 1] * m[0, 2] * m[0, 2]
                    - m[2, 2] * m[0, 1] * m[0, 1])
    c1 = np.float32(m[0, 0] * m[1, 1] - m[0, 1] * m[0, 1]
                    + m[0, 0] * m[2, 2] - m[0, 2] * m[0, 2]
                    + m[1, 1] * m[2, 2] - m[1, 2] * m[1, 2])
    c2 = np.float32(m[0, 0] + m[1, 1] + m[2, 2])
    c2_over_3 = np.float32(c2 / 3.0)
    a_over_3 = np.float32(max((c2 * c2_over_3 - c1) / np.float32(3.0),
                              np.float32(0.0)))
    half_b = np.float32(0.5) * np.float32(
        c0 + c2_over_3 * (np.float32(2.0) * c2_over_3 * c2_over_3 - c1))
    q = np.float32(max(a_over_3 ** 3 - half_b * half_b, np.float32(0.0)))
    rho = np.float32(np.sqrt(a_over_3))
    theta = np.float32(np.arctan2(np.sqrt(q), half_b) / 3.0)
    cos_t, sin_t = np.float32(np.cos(theta)), np.float32(np.sin(theta))
    sqrt3 = np.float32(np.sqrt(3.0))
    roots = np.array([
        c2_over_3 - rho * (cos_t + sqrt3 * sin_t),
        c2_over_3 - rho * (cos_t - sqrt3 * sin_t),
        c2_over_3 + np.float32(2.0) * rho * cos_t,
    ], np.float32)
    return roots * scale + shift


def eig3x3_smallest_vector_f32(cov: np.ndarray):
    """(ascending eigenvalues, smallest-eigenvalue eigenvector) mirroring
    Eigen computeDirect's kernel-extraction order in float32 — stable and
    deterministic on near-degenerate (line-like) point sets where a generic
    f64 eigh picks an arbitrary different vector."""
    cov = cov.astype(np.float32)
    eps = np.float32(1.1920929e-07)
    shift = np.float32(np.trace(cov) / 3.0)
    scaled = cov - shift * np.eye(3, dtype=np.float32)
    scale = np.float32(np.max(np.abs(scaled)))
    if scale > 0:
        scaled = scaled / scale
    else:
        scale = np.float32(1.0)
    evals = eig3x3_roots_f32(cov)
    ev_sc = (evals - shift) / scale

    def extract_kernel(lam):
        a = scaled - np.float32(lam) * np.eye(3, dtype=np.float32)
        i0 = int(np.argmax(np.abs(np.diag(a))))
        rep = a[:, i0]
        c0 = np.cross(rep, a[:, (i0 + 1) % 3])
        c1 = np.cross(rep, a[:, (i0 + 2) % 3])
        n0, n1 = float(c0 @ c0), float(c1 @ c1)
        best, n = (c0, n0) if n0 > n1 else (c1, n1)
        n = max(n, float(FLT_MIN))
        return (best / np.sqrt(n)).astype(np.float32), rep

    if ev_sc[2] - ev_sc[0] <= eps:
        return evals, np.array([1.0, 0.0, 0.0], np.float32)
    d0 = ev_sc[2] - ev_sc[1]
    d1 = ev_sc[1] - ev_sc[0]
    if d0 > d1:  # lambda_0 ~ lambda_1 — extract top eigenvector first
        v2, rep = extract_kernel(ev_sc[2])
        if min(d0, d1) <= 2.0 * eps * max(d0, d1):
            ortho = rep - float(v2 @ rep) * v2
            n = max(float(ortho @ ortho), float(FLT_MIN))
            return evals, (ortho / np.sqrt(n)).astype(np.float32)
        v0, _ = extract_kernel(ev_sc[0])
        return evals, v0
    v0, _ = extract_kernel(ev_sc[0])
    return evals, v0


class PlaneEstimatorOracle:
    """plane_estimator.cc:26-229, sequential f32."""

    def __init__(self):
        self.clear()

    def clear(self):
        self.acc = np.zeros(6, np.float32)
        self.c = np.zeros(3, np.float32)
        self.w = np.float32(0.0)
        self.plane = np.array([1.0, 0.0, 0.0, 0.0], np.float32)
        self.centroid = np.zeros(3, np.float32)
        self.curvature = np.float32(0.0)
        self.up_to_date = True
        self.valid = False

    def add_point(self, p, weight=1.0):
        p = np.asarray(p, np.float32)
        wt = np.float32(weight)
        self.acc[0] += p[0] * p[0] * wt
        self.acc[1] += p[0] * p[1] * wt
        self.acc[2] += p[0] * p[2] * wt
        self.acc[3] += p[1] * p[1] * wt
        self.acc[4] += p[1] * p[2] * wt
        self.acc[5] += p[2] * p[2] * wt
        self.c += p * wt
        self.w += wt
        self.up_to_date = False

    def set_normal_orientation(self, hint):
        hint = np.asarray(hint, np.float32)
        if self.plane_valid():
            if float(np.dot(self.plane[:3], hint)) < 0.0:
                self.plane = -self.plane
        else:
            self.plane[:3] = hint

    def merge(self, other: "PlaneEstimatorOracle"):
        self.acc += other.acc
        self.c += other.c
        self.w += other.w
        self.up_to_date = False

    def _cov(self):
        centroid = self.c / self.w
        a = self.acc / self.w
        cov = np.array([
            [a[0] - centroid[0] * centroid[0],
             a[1] - centroid[0] * centroid[1],
             a[2] - centroid[0] * centroid[2]],
            [a[1] - centroid[0] * centroid[1],
             a[3] - centroid[1] * centroid[1],
             a[4] - centroid[1] * centroid[2]],
            [a[2] - centroid[0] * centroid[2],
             a[4] - centroid[1] * centroid[2],
             a[5] - centroid[2] * centroid[2]],
        ], np.float32)
        return cov, centroid

    def compute_plane(self):
        assert self.w > 0, "No points added to plane estimator?"
        self.up_to_date = True
        cov, centroid = self._cov()
        self.centroid = centroid
        evals, v = eig3x3_smallest_vector_f32(cov)
        if evals[1] > FLT_MIN:
            if float(np.dot(self.plane[:3], v)) < 0.0:
                v = -v
            self.plane = plane_from_normal_point(v, centroid)
            lam0 = np.float32(evals[0])
            trace = np.float32(np.trace(cov))
            if trace > lam0 and lam0 > FLT_MIN:
                self.curvature = np.float32(abs(lam0 / trace))
            else:
                self.curvature = np.float32(0.0)
            self.valid = True
        else:
            self.curvature = np.float32(0.0)
            self.plane = plane_from_normal_point(self.plane[:3], centroid)
            self.valid = False

    def get_plane(self):
        if not self.up_to_date:
            self.compute_plane()
        return self.plane

    def get_centroid(self):
        if not self.up_to_date:
            self.compute_plane()
        return self.centroid

    def plane_valid(self):
        if not self.up_to_date:
            self.compute_plane()
        return self.valid


# ---------------------------------------------------------------------------
# Normal support search + organized normals (algorithms.h:106-257, 330-375)
# ---------------------------------------------------------------------------

def find_normal_support_neighbors(points, col, row, min_d, max_d,
                                  include_diagonals):
    rows, cols = points.shape[:2]
    min2, max2 = np.float32(min_d * min_d), np.float32(max_d * max_d)
    center = points[row, col]
    if not np.all(np.isfinite(center)):
        return []
    out = [lin(row, col, rows)]
    min_row, max_row = max(row - 1, 0), min(row + 1, rows - 1)
    min_col, max_col = max(col - 1, 0), min(col + 1, cols - 1)

    def in_band(p):
        if not np.all(np.isfinite(p)):
            return False
        d2 = np.float32(np.sum((center - p).astype(np.float32) ** 2))
        return min2 <= d2 <= max2

    for r in range(row - 1, -1, -1):
        p = points[r, col]
        if not np.all(np.isfinite(p)):
            continue
        if in_band(p):
            out.append(lin(r, col, rows))
            min_row = r
            break
    for c in range(col - 1, -1, -1):
        p = points[row, c]
        if not np.all(np.isfinite(p)):
            continue
        if in_band(p):
            out.append(lin(row, c, rows))
            min_col = c
            break
    for r in range(row + 1, rows):
        p = points[r, col]
        if not np.all(np.isfinite(p)):
            continue
        if in_band(p):
            out.append(lin(r, col, rows))
            max_row = r
            break
    for c in range(col + 1, cols):
        p = points[row, c]
        if not np.all(np.isfinite(p)):
            continue
        if in_band(p):
            out.append(lin(row, c, rows))
            max_col = c
            break

    if not include_diagonals:
        return out
    if min_col != col:
        if min_row != row and in_band(points[min_row, min_col]):
            out.append(lin(min_row, min_col, rows))
        if max_row != row and in_band(points[max_row, min_col]):
            out.append(lin(max_row, min_col, rows))
    if max_col != col:
        if min_row != row and in_band(points[min_row, max_col]):
            out.append(lin(min_row, max_col, rows))
        if max_row != row and in_band(points[max_row, max_col]):
            out.append(lin(max_row, max_col, rows))
    return out


def compute_normals_organized(points, sensor_origin,
                              params: ComputeNormalsParams = ComputeNormalsParams()):
    rows, cols = points.shape[:2]
    normals = np.full_like(points, np.nan)
    est = PlaneEstimatorOracle()
    for col in range(cols):
        for row in range(rows):
            p = points[row, col]
            if not np.all(np.isfinite(p)):
                continue
            nbrs = find_normal_support_neighbors(
                points, col, row, params.min_neighbor_distance,
                params.max_neighbor_distance,
                params.include_diagonal_neighbors)
            if len(nbrs) < params.min_num_support_neighbors:
                continue
            est.clear()
            est.set_normal_orientation(
                np.asarray(sensor_origin, np.float32) - p)
            for idx in nbrs:
                est.add_point(at_lin(points, idx))
            if est.plane_valid():
                normals[row, col] = est.get_plane()[:3]
    return normals


# ---------------------------------------------------------------------------
# Seed finders (segmentation.h:136-230) — transposed accesses preserved
# ---------------------------------------------------------------------------

def find_seed_points_from_average_normals(points, normals,
                                          neighborhood_size=5,
                                          min_num_valid_normals=8,
                                          min_avg_normal_length=0.9999):
    rows, cols = points.shape[:2]
    assert rows > 1
    half = neighborhood_size // 2
    min_sq = np.float32(min_avg_normal_length * min_avg_normal_length)
    seeds = []
    if rows < neighborhood_size or cols < neighborhood_size:
        return seeds

    for row in range(half, rows - half):
        avg_row = np.zeros((neighborhood_size, 3), np.float32)
        nvalid_row = np.zeros(neighborhood_size, np.int64)
        for col in range(cols):
            avg = np.zeros(3, np.float32)
            nvalid = 0
            for i in range(neighborhood_size):
                if col >= neighborhood_size:
                    # transposed access normals.AtUnsafe(col - nbh, row+i-half)
                    leaving = normals[col - neighborhood_size,
                                      row + i - half]
                    if np.all(np.isfinite(leaving)):
                        avg_row[i] -= leaving
                        nvalid_row[i] -= 1
                entering = normals[col, row + i - half]
                if np.all(np.isfinite(entering)):
                    avg_row[i] += entering
                    nvalid_row[i] += 1
                new_n = nvalid + nvalid_row[i]
                with np.errstate(invalid="ignore", divide="ignore"):
                    avg = (nvalid * avg + nvalid_row[i] * avg_row[i]) \
                        / np.float32(new_n)
                nvalid = new_n
            sq = np.float32(np.sum(avg * avg))
            if (col >= neighborhood_size - 1
                    and nvalid >= min_num_valid_normals
                    and sq >= min_sq):
                seeds.append(lin(row, col, rows) - half)
    return seeds


def get_num_plane_support_points(plane, max_plane_distance, row, col,
                                 half, points):
    rows, cols = points.shape[:2]
    n = 0
    for support_col in range(max(0, col - half), min(cols - 1, col + half) + 1):
        for support_row in range(max(0, row - half),
                                 min(rows - 1, row + half) + 1):
            # transposed access points.AtUnsafe(support_col, support_row)
            if plane_abs_distance(plane, points[support_col, support_row]) \
                    < max_plane_distance:
                n += 1
    return n


def find_seed_points_from_plane_support(points, normals,
                                        neighborhood_size=9,
                                        max_plane_distance=0.05,
                                        min_num_support_points=12):
    rows, cols = points.shape[:2]
    assert rows > 1
    half = neighborhood_size // 2
    if rows < neighborhood_size or cols < neighborhood_size:
        return []
    ranked = []  # (count, insertion_idx, seed_index)
    order = 0
    for col in range(cols):
        for row in range(rows):
            point = points[col, row]     # transposed
            normal = normals[col, row]   # transposed
            if not (np.all(np.isfinite(normal))
                    and np.all(np.isfinite(point))):
                continue
            plane = plane_from_normal_point(normal, point)
            n = get_num_plane_support_points(
                plane, max_plane_distance, row, col, half, points)
            if n >= min_num_support_points:
                ranked.append((n, order, lin(row, col, rows)))
                order += 1
    ranked.sort()  # multimap: ascending count, insertion order within ties
    return [idx for _, _, idx in ranked]


# ---------------------------------------------------------------------------
# Generic region growing driver (segmentation.h:239-292)
# ---------------------------------------------------------------------------

def prepare_unlabeled_labels(points):
    return np.full(points.shape[:2], UNLABELED, np.int32)


def segment_regions(region, input_data, seed_point_indices, labels,
                    initial_id_offset=0):
    """Exact FIFO driver. ``region`` is reused across seeds like the C++."""
    regions = []
    queue = deque()
    n = len(seed_point_indices)
    while n > 0:
        seed = seed_point_indices[n - 1]
        n -= 1
        if at_lin(labels, seed) != UNLABELED:
            continue
        region.init(input_data, seed, queue)
        while queue:
            cand = queue.popleft()
            if region.check_inlier_and_update(
                    input_data, cand, labels,
                    len(regions) + initial_id_offset):
                region.add_neighbors(input_data, cand, labels, queue)
        if region.check_and_finalize(input_data, labels):
            regions.append(region.snapshot())
        else:
            for i in region.inlier_indices:
                set_lin(labels, i, EXAMINED)
    labels[labels == EXAMINED] = UNLABELED
    return regions


# ---------------------------------------------------------------------------
# Planar region (planar_region.h / .cc)
# ---------------------------------------------------------------------------

def create_neighborhood(use8: bool, rows: int):
    """planar_region.cc:26-45 (delta_x = col, delta_y = row)."""
    if use8:
        return [(-1, 0, -rows), (-1, -1, -rows - 1), (0, -1, -1),
                (1, -1, rows - 1), (1, 0, rows), (1, 1, rows + 1),
                (0, 1, 1), (-1, 1, -rows + 1)]
    return [(-1, 0, -rows), (0, -1, -1), (1, 0, rows), (0, 1, 1)]


def in_bounds(labels, idx, n):
    rows, cols = labels.shape[:2]
    x = (idx // rows) + n[0]
    y = (idx % rows) + n[1]
    return 0 <= x < cols and 0 <= y < rows


def check_min_rows_and_cols(indices, rows, cols, min_cols, min_rows):
    """planar_region.cc:91-106 (strict > comparisons)."""
    min_x, max_x, min_y, max_y = cols, 0, rows, 0
    for index in indices:
        x, y = index // rows, index % rows
        min_x, max_x = min(x, min_x), max(x, max_x)
        min_y, max_y = min(y, min_y), max(y, max_y)
    return (max_x - min_x) > min_cols and (max_y - min_y) > min_rows


def planar_convex_hull(points, indices, plane):
    """algorithms.h:527-549 with the intended resize of the output buffer
    (shared host implementation in utils/hostgeom)."""
    gathered = np.array([at_lin(points, i) for i in indices], np.float64)
    return hostgeom.planar_convex_hull(gathered, plane)


def cumulative_polygon_normal(points, indices):
    """algorithms.h:265-275 (Stokes)."""
    normal = np.zeros(3, np.float32)
    size = len(indices)
    for i in range(size):
        a = at_lin(points, indices[i]).astype(np.float32)
        b = at_lin(points, indices[(i + 1) % size]).astype(np.float32)
        normal += np.cross(a, b)
    return normal


def polygon_area(points, indices):
    return np.float32(0.5) * np.float32(
        np.linalg.norm(cumulative_polygon_normal(points, indices)))


@dataclasses.dataclass
class PlanarRegionSnapshot:
    label_id: int
    inlier_indices: List[int]
    boundary_indices: List[int]
    discontinuous_boundary_indices: set
    plane: np.ndarray
    centroid: np.ndarray
    area: float
    seed_point_index: int
    projected_boundary_points: np.ndarray
    plane_class: PlaneClass = PlaneClass.UNKNOWN
    estimator: Optional[PlaneEstimatorOracle] = None


class PlanarRegionOracle:
    """planar_region.h:89-465."""

    def __init__(self, config: PlanarRegionConfig,
                 robot_pose_quat_matrix: Optional[np.ndarray] = None,
                 replicate_hull_bug: bool = False):
        self.config = config
        self.rot_robot = (np.eye(3, dtype=np.float32)
                          if robot_pose_quat_matrix is None
                          else robot_pose_quat_matrix.astype(np.float32))
        self.replicate_hull_bug = replicate_hull_bug
        self.estimator = PlaneEstimatorOracle()
        self.inlier_indices: List[int] = []

    def init(self, in_data, seed, queue):
        points, normals = in_data["points"], in_data["normals"]
        seed_normal = at_lin(normals, seed)
        seed_point = at_lin(points, seed)
        self.seed_point_index = seed
        self.plane = plane_from_normal_point(seed_normal, seed_point)
        self.estimator = PlaneEstimatorOracle()
        self.estimator.set_normal_orientation(seed_normal)
        self.centroid = seed_point.copy()
        self.area = np.float32(0.0)
        self.inlier_indices = []
        self.boundary_indices = []
        self.discontinuous = set()
        self.label_id = 0
        self.hull = np.zeros((0, 3), np.float32)
        queue.append(seed)

    def check_inlier_and_update(self, in_data, cand, labels, label_id):
        point = at_lin(in_data["points"], cand)
        d = plane_abs_distance(self.plane, point)
        if d < self.config.max_plane_distance:  # NaN compares False
            self.inlier_indices.append(cand)
            self.estimator.add_point(point)
            if len(self.inlier_indices) \
                    % self.config.plane_model_reestimation_period == 0:
                self.plane = self.estimator.get_plane().copy()
            set_lin(labels, cand, label_id)
            self.label_id = label_id
            return True
        set_lin(labels, cand, UNLABELED)
        return False

    def add_neighbors(self, in_data, cand, labels, queue):
        rows, cols = labels.shape[:2]
        row, col = to_rc(cand, rows)
        # 4-neighborhood in the reference's push order (planar_region.h:236-254)
        for delta_col in (-1, 0, 1):
            for delta_row in (-1, 0, 1):
                if abs(delta_col + delta_row) != 1:
                    continue
                c, r = col + delta_col, row + delta_row
                if not (0 <= c < cols and 0 <= r < rows):
                    continue
                if labels[r, c] != UNLABELED:
                    continue
                labels[r, c] = IN_QUEUE
                queue.append(lin(r, c, rows))

    def check_and_finalize(self, in_data, labels):
        if len(self.inlier_indices) < self.config.min_region_inliers:
            return False
        self.plane = self.estimator.get_plane().copy()
        self.centroid = self.estimator.get_centroid().copy()
        # Conscious divergence (CheckAndFinalize, planar_region.h:198-203,
        # mirrored in models/boundary.py — see its docstring): the
        # reference walks inliers in reverse BFS order and traces from the
        # first with ANY non-region neighbor, which can be an interior
        # NaN-hole rim or a thin appendage tip — the traced "boundary" is
        # then a hole ring / parasitic cycle and the region is rejected by
        # area, chaotically in the exact BFS order. We trace from the
        # canonical raster start (first member in col-major order, entered
        # from the West) so the full outer contour is always the one
        # traced. A region covering the entire grid still has no trace
        # start and is rejected like the reference (planar_region.h:316-318).
        mask = labels == self.label_id
        self.boundary_indices = []
        self.discontinuous = set()
        if mask.any() and not mask.all():
            start = int(np.argmax(mask.T.ravel()))  # col-major first member
            self.find_labeled_region_boundary(
                start, in_data, labels, use8=True, b_dir0=0)
        rows, cols = labels.shape[:2]
        if not check_min_rows_and_cols(self.boundary_indices, rows, cols, 3, 3):
            return False
        if not self.boundary_indices:
            return False
        if self.replicate_hull_bug:
            return False  # reference rejects every region; see module docstring
        self.hull = planar_convex_hull(
            in_data["points"], self.boundary_indices, self.plane)
        if len(self.hull) < 3:
            return False
        self.area = polygon_area(in_data["points"], self.boundary_indices)
        return self.area >= self.config.min_region_area

    def find_labeled_region_boundary(self, start_idx, in_data, labels, use8,
                                     b_dir0=-1):
        """planar_region.h:295-425 with the conscious-fix walk rule — see
        models/boundary.py docstring. ``b_dir0``: entry-background
        direction index; 0 (West) with the canonical col-major-first start,
        -1 = reference-style first non-region neighbor in table order."""
        points, normals = in_data["points"], in_data["normals"]
        rows, cols = labels.shape[:2]
        directions = create_neighborhood(use8, rows)
        self.boundary_indices = []
        self.discontinuous = set()

        curr_idx = start_idx
        curr_x, curr_y = start_idx // rows, start_idx % rows
        region_label = at_lin(labels, start_idx)

        def find_initial_predecessor():
            for i, d in enumerate(directions):
                x, y = curr_x + d[0], curr_y + d[1]
                if 0 <= x < cols and 0 <= y < rows \
                        and at_lin(labels, curr_idx + d[2]) != region_label:
                    return i
            return -1

        b_dir = b_dir0 if b_dir0 >= 0 else find_initial_predecessor()
        if b_dir < 0:
            return False

        min_range_sq = np.float32(self.config.discontinuity_min_range ** 2)
        max_range_sq = np.float32(self.config.discontinuity_max_range ** 2)
        dirs4 = create_neighborhood(False, rows)
        # Conscious divergence (planar_region.cc:47-65 +
        # planar_region.h:331-345, mirrored in models/boundary.py — see its
        # docstring): textbook Moore-neighbor tracing with background
        # backtracking + Jacob's termination instead of the reference's
        # previous-pixel sweep (parasitic notch orbits) and
        # stop-after-start-revisit rule (premature stop on appendage tips).
        rel = []
        for m in range(8):
            p = directions[(m + 7) % 8]
            q = directions[m]
            v = (p[0] - q[0], p[1] - q[1])
            rel.append(next(i for i, d in enumerate(directions)
                            if (d[0], d[1]) == v))
        def check_discontinuity(curr_idx):
            p = at_lin(points, curr_idx).astype(np.float32)
            sq = np.float32(np.sum(p * p))
            if min_range_sq < sq < max_range_sq:
                n_inb = sum(1 for n4 in dirs4
                            if in_bounds(labels, curr_idx, n4))
                if n_inb == 4:  # kNSkipCycles (planar_region.h:38,368-371)
                    for n4 in dirs4:
                        pn = at_lin(points, curr_idx + n4[2])
                        if math.isnan(float(p[2])) or math.isnan(float(pn[2])):
                            continue
                        if not in_bounds(labels, curr_idx, n4) \
                                or region_label != at_lin(labels,
                                                          curr_idx + n4[2]):
                            continue
                        pt_delta = (p - pn).astype(np.float32)
                        delta_r = self.rot_robot @ pt_delta
                        cosang = float(np.dot(at_lin(normals, curr_idx),
                                              at_lin(normals,
                                                     curr_idx + n4[2])))
                        with np.errstate(invalid="ignore"):
                            ang = abs(math.degrees(np.arccos(
                                np.float32(cosang)))) \
                                if -1 <= cosang <= 1 else float("nan")
                        dz = abs(float(delta_r[2]))
                        if (not math.isnan(ang)
                                and ang < self.config.discontinuity_normal_angle_diff
                                and dz < self.config.discontinuity_z_diff):
                            continue
                        norm = float(np.linalg.norm(delta_r))
                        if norm > 0 and dz / norm \
                                < self.config.discontinuity_z_ratio:
                            continue
                        self.discontinuous.add(curr_idx)

        # Terminate on ANY (pixel, background-direction) state recurrence
        # (mirrors models/boundary.py — see its docstring).
        seen = {start_idx * 8 + b_dir}
        self.boundary_indices.append(start_idx)
        check_discontinuity(start_idx)
        while True:
            new_dir = -1
            for delta in range(1, len(directions) + 1):
                ndi = (b_dir + delta) % len(directions)
                d = directions[ndi]
                x, y = curr_x + d[0], curr_y + d[1]
                if 0 <= x < cols and 0 <= y < rows \
                        and at_lin(labels, curr_idx + d[2]) == region_label:
                    new_dir = ndi
                    break
            if new_dir < 0:
                break  # isolated pixel
            b_dir = rel[new_dir]
            curr_idx += directions[new_dir][2]
            curr_x += directions[new_dir][0]
            curr_y += directions[new_dir][1]

            state = curr_idx * 8 + b_dir
            if state in seen:
                break
            seen.add(state)
            self.boundary_indices.append(curr_idx)
            check_discontinuity(curr_idx)
        return True

    def snapshot(self) -> PlanarRegionSnapshot:
        est = PlaneEstimatorOracle()
        est.merge(self.estimator)
        est.plane = self.estimator.plane.copy()
        return PlanarRegionSnapshot(
            label_id=self.label_id,
            inlier_indices=list(self.inlier_indices),
            boundary_indices=list(self.boundary_indices),
            discontinuous_boundary_indices=set(self.discontinuous),
            plane=self.plane.copy(),
            centroid=self.centroid.copy(),
            area=float(self.area),
            seed_point_index=self.seed_point_index,
            projected_boundary_points=self.hull.copy(),
            estimator=est,
        )


# ---------------------------------------------------------------------------
# Euclidean cluster region (cluster_region.h)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ClusterRegionSnapshot:
    label_id: int
    inlier_indices: List[int]
    seed: Optional[np.ndarray] = None


class ClusterRegionOracle:
    """cluster_region.h:47-176. Queue entries are (source, candidate)."""

    def __init__(self, config: ClusterRegionConfig):
        self.config = config
        self.inlier_indices: List[int] = []
        self.label_id = 0

    def init(self, in_data, seed, queue):
        self.inlier_indices = []
        queue.append((seed, seed))

    def check_inlier_and_update(self, in_data, pair, labels, label_id):
        source, cand = pair[0], pair[1]
        points = in_data["points"]
        d2 = np.float32(np.sum(
            (at_lin(points, cand).astype(np.float32)
             - at_lin(points, source).astype(np.float32)) ** 2))
        if d2 < self.config.squared_distance_threshold:
            self.inlier_indices.append(cand)
            set_lin(labels, cand, label_id)
            self.label_id = label_id
            return True
        set_lin(labels, cand, UNLABELED)
        return False

    def add_neighbors(self, in_data, pair, labels, queue):
        points = in_data["points"]
        rows, cols = labels.shape[:2]
        cand = pair[1]
        row, col = to_rc(cand, rows)
        hw = self.config.half_search_window
        for delta_col in range(-hw, hw + 1):
            for delta_row in range(-hw, hw + 1):
                if delta_col == 0 and delta_row == 0:
                    continue
                c, r = col + delta_col, row + delta_row
                if not (0 <= c < cols and 0 <= r < rows):
                    continue
                if labels[r, c] != UNLABELED:
                    continue
                labels[r, c] = IN_QUEUE
                queue.append((cand, lin(r, c, rows)))

    def check_and_finalize(self, in_data, labels):
        return len(self.inlier_indices) >= self.config.min_region_inliers

    def snapshot(self):
        return ClusterRegionSnapshot(self.label_id, list(self.inlier_indices))


# ---------------------------------------------------------------------------
# Mean shift (mean_shift_segmentation.h)
# ---------------------------------------------------------------------------

def sliding_mean_shift(points, config: ClusterRegionConfig, iterations,
                       initial_region_id_offset, labels,
                       params: MeanShiftParams = MeanShiftParams()):
    """mean_shift_segmentation.h:207-330, sequential."""
    rows, cols = points.shape[:2]
    seeds = []      # [pos3 float32, index2 float32, linear index]
    for index in range(rows * cols):
        if at_lin(labels, index) == UNLABELED \
                and not np.any(np.isnan(at_lin(points, index))):
            r, c = to_rc(index, rows)
            seeds.append([at_lin(points, index).astype(np.float32).copy(),
                          np.array([r, c], np.float32)])
    valid = [True] * len(seeds)
    intensities = [1.0] * len(seeds)

    for _ in range(iterations):
        for i, (pos, idx2) in enumerate(seeds):
            if not valid[i]:
                continue
            row, col = int(round(float(idx2[0]))), int(round(float(idx2[1])))
            shifts = []
            for delta_col in range(-params.half_search_window,
                                   params.half_search_window + 1):
                for delta_row in range(-params.half_search_window,
                                       params.half_search_window + 1):
                    r, c = row + delta_row, col + delta_col
                    if not (0 <= c < cols and 0 <= r < rows):
                        continue
                    if labels[r, c] != UNLABELED \
                            or np.any(np.isnan(points[r, c])):
                        continue
                    dpos = points[r, c].astype(np.float32) - pos
                    if float(np.sum(dpos * dpos)) \
                            > params.square_distance_threshold:
                        continue
                    shifts.append((dpos, np.array([r, c], np.float32) - idx2))
            total = float(len(shifts))
            if total < params.min_support:
                valid[i] = False
                continue
            sum_pos = np.sum([s[0] for s in shifts], axis=0)
            sum_idx = np.sum([s[1] for s in shifts], axis=0)
            seeds[i][0] = pos + sum_pos / np.float32(total)
            seeds[i][1] = idx2 + sum_idx / np.float32(total)
            intensities[i] = total

    survivors = [(seeds[i][0], seeds[i][1], intensities[i], i)
                 for i in range(len(seeds)) if valid[i]]
    # std::sort by intensity ascending (unstable; we use stable + original
    # order as tie-break, documented divergence for exact ties).
    survivors.sort(key=lambda s: (s[2], s[3]))

    regions = []
    valid_sorted = [True] * len(survivors)
    for i, (pos, idx2, intensity, _) in enumerate(survivors):
        if not valid_sorted[i]:
            continue
        region = ClusterRegionOracle(config)
        region.label_id = len(regions) + initial_region_id_offset
        seed_pos = pos.copy()
        queue = deque()
        queue.append(lin(int(round(float(idx2[0]))),
                         int(round(float(idx2[1]))), rows))
        first = True
        while queue:
            center_idx = queue.popleft()
            _grow_mean_shift(points, center_idx, params, first, labels,
                             region, seed_pos, queue)
            first = False
        if len(region.inlier_indices) >= config.min_region_inliers:
            for j in range(i + 1, len(survivors)):
                if valid_sorted[j] and float(np.sum(
                        (survivors[j][0] - seed_pos) ** 2)) \
                        < params.squared_centroid_distance_threshold:
                    valid_sorted[j] = False
            regions.append(ClusterRegionSnapshot(
                region.label_id, list(region.inlier_indices),
                seed=seed_pos))
        else:
            for idx in region.inlier_indices:
                set_lin(labels, idx, UNLABELED)
    return regions


def _grow_mean_shift(points, center_idx, params, first, labels, region,
                     seed_pos, queue):
    """AddNeighborsAndGrowReigon (mean_shift_segmentation.h:152-199)."""
    rows, cols = points.shape[:2]
    hw = region.config.half_search_window
    row, col = to_rc(center_idx, rows)
    center_point = at_lin(points, center_idx)
    for delta_col in range(-hw, hw + 1):
        for delta_row in range(-hw, hw + 1):
            if not first and delta_col == 0 and delta_row == 0:
                continue
            r, c = row + delta_row, col + delta_col
            if not (0 <= c < cols and 0 <= r < rows):
                continue
            if labels[r, c] != UNLABELED or np.any(np.isnan(points[r, c])):
                continue
            cand = points[r, c].astype(np.float32)
            if float(np.sum((cand - seed_pos) ** 2)) \
                    > params.squared_centroid_distance_threshold:
                if first or float(np.sum(
                        (cand - center_point.astype(np.float32)) ** 2)) \
                        > params.squared_neighbor_distance_threshold:
                    continue
            idx = lin(r, c, rows)
            region.inlier_indices.append(idx)
            set_lin(labels, idx, region.label_id)
            queue.append(idx)


# ---------------------------------------------------------------------------
# Plane classification (plane_classification.cc:26-136)
# ---------------------------------------------------------------------------

def _is_horizontal_plane_with_offset(params, region: PlanarRegionSnapshot,
                                     up, floor_point):
    cos_max = math.cos(math.radians(
        params.max_up_direction_delta_angle_degrees))
    if float(np.dot(region.plane[:3], up)) < cos_max:
        return False, "angle"
    floor_offset = plane_signed_distance(region.plane, floor_point)
    if abs(params.floor_offset + floor_offset) \
            > params.max_floor_offset_deviation:
        return False, "distance"
    if region.area < params.min_area or region.area > params.max_area:
        return False, "size"
    return True, None


def _is_wall(params, region: PlanarRegionSnapshot, up):
    cos_max = math.cos(math.radians(
        90.0 - params.max_horizontal_delta_angle_degrees))
    if abs(float(np.dot(region.plane[:3], up))) > cos_max:
        return False
    if len(region.projected_boundary_points) == 0:
        return False
    heights = region.projected_boundary_points @ np.asarray(up, np.float32)
    return (np.max(heights) - np.min(heights)) >= params.min_height


def classify_plane(config: PlaneClassificationConfig, up, floor_point,
                   region: PlanarRegionSnapshot):
    ok, _ = _is_horizontal_plane_with_offset(
        config.floor_params, region, up, floor_point)
    if ok:
        region.plane_class = PlaneClass.FLOOR
        return region.plane_class
    ok, _ = _is_horizontal_plane_with_offset(
        config.coffee_table_params, region, up, floor_point)
    if ok:
        region.plane_class = PlaneClass.TABLE
        return region.plane_class
    if _is_wall(config.wall_params, region, up):
        region.plane_class = PlaneClass.WALL
        return region.plane_class
    region.plane_class = PlaneClass.UNKNOWN
    return region.plane_class
