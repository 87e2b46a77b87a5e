"""Region boundary extraction and the host finalize pass for planar regions.

The reference finalizes each planar region with a Moore boundary trace,
convex hull, Stokes area, and geometric discontinuity detection
(pointcloud_segmentation/planar_region.h:189-425 + .cc).
These are ordering-dependent walks over *small* per-region sets — the
natural host seam. The dense growth already happened on device
(models/planar.py); this pass:

  1. traces each candidate region's outer boundary (Moore walk, exact port
     of the direction tables and revisit handling),
  2. applies the extent (CheckMinRowsAndCols, strict >3 spreads,
     planar_region.cc:91-106), hull-size, and min-area gates
     (planar_region.h:205-223) — implementing the *intended* hull-size gate
     (the reference's unsized hull buffer rejects everything; see
     pcseg_tpu/oracle.py docstring),
  3. rejects failing regions (their pixels revert to kUnlabeled — identical
     final state to the reference's quarantine-then-reset) and compacts
     surviving ids,
  4. computes discontinuous boundary points (planar_region.h:356-417).

Conscious divergences (mirrored in the oracle, so both sides of the parity
harness share them; see CLAUDE.md "Parity policy"):

  * Trace start: the reference starts from the last BFS-order inlier with
    any non-region neighbor (planar_region.h:198-203) — with interior NaN
    holes that start can sit on a hole rim, tracing the hole ring instead
    of the region boundary and rejecting arbitrarily large regions by
    area; the outcome flips on the exact BFS order (chaotic, observed on
    the 560x560 room scene: a 216k-point wall region rejected). We start
    from a member adjacent to the border-connected *outside* component —
    always the outer ring, set-determined.
  * Walk rule: the reference's radial sweep backtracks to the *previous
    boundary pixel* and rescans from there (planar_region.cc:47-65 +
    planar_region.h:331-345), which loses track of which side the
    background is on; near single-pixel notches the deterministic walk
    enters parasitic 3-cycles that never trace the contour (observed:
    1189-point wall "boundary" of 3 pixels => area 0 => reject), and its
    stop-after-start-revisit rule additionally terminates prematurely on
    thin appendage tips. We use textbook Moore-neighbor tracing with
    background backtracking (scan clockwise from the background pixel the
    walk entered through) and Jacob's termination criterion (stop when
    the initial (pixel, entry-background) state recurs) — this provably
    traces the full outer contour of the 8-connected blob.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np

from pcseg_tpu.models.config import (
    UNLABELED, PlanarRegionConfig, PlaneClass)
from pcseg_tpu.utils import hostgeom
from pcseg_tpu import native as _native


def neighborhood(use8: bool, rows: int):
    """Direction table (delta_x=col, delta_y=row, delta_index) —
    planar_region.cc:26-45."""
    if use8:
        return [(-1, 0, -rows), (-1, -1, -rows - 1), (0, -1, -1),
                (1, -1, rows - 1), (1, 0, rows), (1, 1, rows + 1),
                (0, 1, 1), (-1, 1, -rows + 1)]
    return [(-1, 0, -rows), (0, -1, -1), (1, 0, rows), (0, 1, 1)]


def moore_trace(mask: np.ndarray, start_idx: int, use8: bool = True,
                b_dir0: int = -1):
    """Boundary walk on a bool member mask (planar_region.h:295-353 intent;
    conscious-fix walk rule, see module docstring).

    ``start_idx`` is a col-major linear index of a member. ``b_dir0`` is
    the entry-background direction index (ring order of
    :func:`neighborhood`); pass 0 (West) with the canonical raster start
    from :func:`find_outer_start` — the textbook configuration whose orbit
    provably closes. -1 = first in-bounds non-member neighbor in table
    order (legacy behavior for arbitrary starts; may trace a hole ring).
    Returns the ordered boundary index list or None if start is not on a
    boundary. Uses the native C++ walk when available
    (pcseg_tpu/native/hostops.cc), falling back to the pure-Python port.
    """
    rows, cols = mask.shape
    if use8:
        lib = _native.load_hostops()
        if lib is not None:
            import ctypes
            mask_cm = np.ascontiguousarray(mask.T).astype(np.uint8)
            cap = 8 * (rows * cols + 16)
            out = np.empty(cap, np.int64)
            n = lib.pcseg_moore_trace(
                mask_cm.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                rows, cols, int(start_idx), int(b_dir0),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), cap)
            if n > 0:
                return [int(i) for i in out[:n]]
            if n == 0:
                return None
            # n < 0: capacity overflow — fall through to the Python walk
    dirs = neighborhood(True, rows)  # ring-ordered 8-neighborhood

    def at(idx):
        return mask[idx % rows, idx // rows]

    curr_idx = start_idx
    curr_x, curr_y = start_idx // rows, start_idx % rows

    b_dir = b_dir0
    if b_dir < 0:
        for i, d in enumerate(dirs):
            x, y = curr_x + d[0], curr_y + d[1]
            if 0 <= x < cols and 0 <= y < rows and not at(curr_idx + d[2]):
                b_dir = i
                break
        if b_dir < 0:
            return None

    # REL[m]: direction index of dirs[m-1] - dirs[m] (the new pixel's view
    # of the last background cell scanned before entering it)
    rel = []
    for m in range(8):
        p = dirs[(m + 7) % 8]
        q = dirs[m]
        v = (p[0] - q[0], p[1] - q[1])
        rel.append(next(i for i, d in enumerate(dirs)
                        if (d[0], d[1]) == v))

    boundary = [start_idx]
    # Terminate on ANY (pixel, background-direction) state recurrence: the
    # walk map is deterministic, so the first repeat closes the contour
    # cycle (the initial state may be a 1-state tail when the re-entry
    # background differs from the seeded West anchor).
    seen = {start_idx * 8 + b_dir}
    while True:
        new_dir = -1
        for delta in range(1, 9):
            ndi = (b_dir + delta) % 8
            d = dirs[ndi]
            x, y = curr_x + d[0], curr_y + d[1]
            if 0 <= x < cols and 0 <= y < rows and at(curr_idx + d[2]):
                new_dir = ndi
                break
        if new_dir < 0:
            return boundary  # isolated pixel
        b_dir = rel[new_dir]
        curr_idx += dirs[new_dir][2]
        curr_x += dirs[new_dir][0]
        curr_y += dirs[new_dir][1]
        state = curr_idx * 8 + b_dir
        if state in seen:
            return boundary
        seen.add(state)
        boundary.append(curr_idx)


def outside_component(mask: np.ndarray) -> np.ndarray:
    """Non-member cells 4-connected to the grid border ([H, W] bool)."""
    rows, cols = mask.shape
    lib = _native.load_hostops()
    if lib is not None:
        import ctypes
        mask_cm = np.ascontiguousarray(mask.T).astype(np.uint8)
        out_cm = np.zeros_like(mask_cm)
        lib.pcseg_flood_outside(
            mask_cm.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            rows, cols,
            out_cm.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return out_cm.T.astype(bool)
    outside = np.zeros_like(mask)
    # flood fill non-member cells from the border (iterative dilation)
    nonmember = ~mask
    frontier = np.zeros_like(mask)
    frontier[0, :] = nonmember[0, :]
    frontier[-1, :] = nonmember[-1, :]
    frontier[:, 0] = nonmember[:, 0]
    frontier[:, -1] = nonmember[:, -1]
    outside |= frontier
    while frontier.any():
        grown = np.zeros_like(mask)
        grown[1:, :] |= outside[:-1, :]
        grown[:-1, :] |= outside[1:, :]
        grown[:, 1:] |= outside[:, :-1]
        grown[:, :-1] |= outside[:, 1:]
        grown &= nonmember
        frontier = grown & ~outside
        outside |= frontier
    return outside


def find_outer_start(mask: np.ndarray) -> Optional[int]:
    """Canonical outer-contour trace start: the first member in col-major
    order. Its West neighbor is background (or off-grid) by construction —
    the textbook Moore-trace start whose orbit with ``b_dir0=0`` closes on
    the full outer contour. None if the region covers the entire grid (the
    reference then fails every FindInitialPredecessorDirection and rejects
    the region, planar_region.h:316-318 — replicated)."""
    if mask.all():
        return None
    if not mask.any():
        return None
    flat_cm = mask.T.ravel()  # col-major order
    return int(np.argmax(flat_cm))


def check_min_rows_and_cols(indices, rows, min_cols=3, min_rows=3) -> bool:
    """planar_region.cc:91-106 (strict > comparisons)."""
    if not indices:
        return False
    idx = np.asarray(indices)
    x = idx // rows
    y = idx % rows
    return (x.max() - x.min()) > min_cols and (y.max() - y.min()) > min_rows


def discontinuous_boundary(boundary, points, normals, labels, region_label,
                           rot_robot, config: PlanarRegionConfig):
    """planar_region.h:356-417: per-boundary-point geometric discontinuity
    checks against same-label 4-neighbors (the code compares same-label
    neighbors despite its comment; replicated). Vectorized over the whole
    boundary list (the checks are pure per-pixel stencil math, SURVEY §7.7)
    with the same f32 op order as the scalar port it replaced."""
    rows, cols = labels.shape
    if len(boundary) == 0:
        return set()
    idx = np.asarray(boundary, np.int64)
    r = idx % rows
    c = idx // rows
    min_sq = np.float32(config.discontinuity_min_range ** 2)
    max_sq = np.float32(config.discontinuity_max_range ** 2)

    p = points[r, c].astype(np.float32)                       # [B, 3]
    sq = np.sum(p * p, axis=-1, dtype=np.float32)
    # kNSkipCycles: all 4 neighbors in bounds (planar_region.h:368-371)
    cand = ((sq > min_sq) & (sq < max_sq)
            & (r > 0) & (r < rows - 1) & (c > 0) & (c < cols - 1))
    n_here = normals[r, c].astype(np.float32)
    rot = rot_robot.astype(np.float32)
    disc = np.zeros(idx.shape, bool)
    for d_col, d_row, _ in neighborhood(False, rows):
        rn = np.clip(r + d_row, 0, rows - 1)
        cn = np.clip(c + d_col, 0, cols - 1)
        pn = points[rn, cn].astype(np.float32)
        ok = (cand
              & ~np.isnan(p[:, 2]) & ~np.isnan(pn[:, 2])
              & (labels[rn, cn] == region_label))
        delta = p - pn
        delta_r = delta @ rot.T
        with np.errstate(invalid="ignore", divide="ignore"):
            cosang = np.sum(n_here * normals[rn, cn].astype(np.float32),
                            axis=-1)
            ang = np.abs(np.degrees(np.arccos(cosang.astype(np.float32))))
            ang = np.where((cosang >= -1.0) & (cosang <= 1.0), ang, np.nan)
            dz = np.abs(delta_r[:, 2]).astype(np.float64)
            smooth = (~np.isnan(ang)
                      & (ang < config.discontinuity_normal_angle_diff)
                      & (dz < config.discontinuity_z_diff))
            norm = np.linalg.norm(delta_r.astype(np.float64), axis=-1)
            shadow = (norm > 0) & (dz / np.where(norm > 0, norm, 1.0)
                                   < config.discontinuity_z_ratio)
        disc |= ok & ~smooth & ~shadow
    return set(int(i) for i in idx[disc])


@dataclasses.dataclass
class PlanarRegionRecord:
    """Host-side finalized region (the reference's PlanarRegion fields,
    planar_region.h:452-464)."""
    label_id: int
    plane: np.ndarray
    centroid: np.ndarray
    curvature: float
    area: float
    count: int
    seed_point_index: int
    boundary_indices: List[int]
    discontinuous_boundary_indices: set
    projected_boundary_points: np.ndarray  # convex hull, in-plane
    plane_class: PlaneClass = PlaneClass.UNKNOWN


def finalize_planar_regions(points, normals, device_regions,
                            config: PlanarRegionConfig,
                            initial_id_offset: int = 0,
                            rot_robot: Optional[np.ndarray] = None,
                            disc_flags: Optional[np.ndarray] = None):
    """Apply the deferred finalize gates and build host region records.

    Args:
      points/normals: [H, W, 3] numpy. ``normals`` may be None when
        ``disc_flags`` is given (its only use is the discontinuity pass).
      device_regions: models.planar.PlanarRegions (device output).
      config: planar config.
      initial_id_offset: same offset passed to the device pass.
      rot_robot: 3x3 rotation of robot_pose_point_cloud (for the
        discontinuity z checks); identity if None.
      disc_flags: optional [H, W] bool — per-pixel discontinuity stencil
        precomputed ON DEVICE (ops/discontinuity.py) against the
        device-time labels; the per-region discontinuous set is then just
        boundary ∩ flags (valid for accepted regions: rejection only
        clears OTHER labels, see ops/discontinuity.py docstring). Without
        it the host recomputes the stencil from ``normals``.

    Returns (labels [H, W] int32 with compacted ids, [PlanarRegionRecord]).
    """
    labels = np.asarray(device_regions.labels).copy()
    rows = labels.shape[0]
    n = int(device_regions.num_regions)
    planes = np.asarray(device_regions.planes)
    centroids = np.asarray(device_regions.centroids)
    curvatures = np.asarray(device_regions.curvatures)
    counts = np.asarray(device_regions.counts)
    seeds = np.asarray(device_regions.seed_indices)
    rot = np.eye(3, dtype=np.float32) if rot_robot is None else rot_robot

    records: List[PlanarRegionRecord] = []
    relabel = {}
    for rid in range(n):
        old_id = rid + initial_id_offset
        mask = labels == old_id
        ok = False
        boundary = None
        hull = np.zeros((0, 3), np.float32)
        area = 0.0
        start = find_outer_start(mask)
        if start is not None:
            boundary = moore_trace(mask, start, use8=True, b_dir0=0)
        if boundary:
            if check_min_rows_and_cols(boundary, rows):
                bidx = np.asarray(boundary, np.int64)
                bpts = points[bidx % rows, bidx // rows].astype(np.float32)
                hull = hostgeom.planar_convex_hull(bpts, planes[rid])
                if len(hull) >= 3:
                    area = hostgeom.polygon_area(bpts)
                    ok = area >= config.min_region_area
        if not ok:
            labels[mask] = UNLABELED
            continue
        new_id = len(records) + initial_id_offset
        relabel[old_id] = new_id
        if disc_flags is not None:
            bidx_all = np.asarray(boundary, np.int64)
            br, bc = bidx_all % rows, bidx_all // rows
            disc = set(int(i) for i in bidx_all[disc_flags[br, bc]])
        else:
            disc = discontinuous_boundary(
                boundary, points, normals, labels, old_id, rot, config)
        records.append(PlanarRegionRecord(
            label_id=new_id,
            plane=planes[rid].copy(),
            centroid=centroids[rid].copy(),
            curvature=float(curvatures[rid]),
            area=float(area),
            count=int(counts[rid]),
            seed_point_index=int(seeds[rid]),
            boundary_indices=list(boundary),
            discontinuous_boundary_indices=disc,
            projected_boundary_points=hull,
        ))

    # compact ids in one pass
    if relabel:
        out = labels.copy()
        for old_id, new_id in relabel.items():
            if old_id != new_id:
                out[labels == old_id] = new_id
        labels = out
    return labels, records
