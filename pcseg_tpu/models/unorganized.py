"""Clustering of unorganized (~1M-point) clouds via voxel grids.

BASELINE config 3: euclidean / mean-shift clustering on large unorganized
clouds. Pipeline: voxelize to a bird's-eye grid of cell centroids
(ops/voxelize.py), run the organized windowed clustering (gated CCL) on the
representative grid, scatter cell labels back to points. Cluster granularity
is the voxel size — choose cell_size well below squared_distance_threshold's
root so voxelization never merges distinct clusters.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from pcseg_tpu.models.config import (
    UNLABELED, ClusterRegionConfig, MeanShiftParams)
from pcseg_tpu.models import cluster as cluster_model
from pcseg_tpu.ops import voxelize


class UnorganizedClusterResult(NamedTuple):
    point_labels: jnp.ndarray   # [N] int32 cluster id (-1 unclustered)
    grid_labels: jnp.ndarray    # [Gx, Gy]
    num_regions: jnp.ndarray
    region_sizes: jnp.ndarray   # per-region POINT counts


def cluster_unorganized(points: jnp.ndarray,
                        config: ClusterRegionConfig = ClusterRegionConfig(),
                        cell_size: float = 0.25,
                        grid_shape=(512, 512),
                        origin=None) -> UnorganizedClusterResult:
    """Cluster a [N, 3] unorganized cloud (jittable end to end)."""
    import dataclasses

    grid = voxelize.voxelize_xy(points, cell_size, grid_shape, origin)
    gx, gy = grid_shape

    labels0 = jnp.full((gx, gy), UNLABELED, jnp.int32)
    # every occupied cell seeds, popped in ascending col-major order;
    # min_region_inliers gates POINT counts (applied below), so accept any
    # seeded cell component here
    seed_vec = jnp.arange(gx * gy - 1, -1, -1, dtype=jnp.int32)
    cell_config = dataclasses.replace(config, min_region_inliers=1)
    res = cluster_model.segment_clusters(
        grid.points, labels0, seed_vec, cell_config, initial_id_offset=0)

    raw_point_labels = voxelize.scatter_labels_to_points(
        res.labels, grid.point_cell)

    # raw cell-component ids are dense but can reach gx*gy (every noise cell
    # is its own component before the point-count gate) — remap over the
    # full id space, then compact survivors into [0, max_regions).
    id_cap = gx * gy
    raw_sizes = jax.ops.segment_sum(
        jnp.where(raw_point_labels >= 0, 1, 0),
        jnp.clip(raw_point_labels, 0, id_cap - 1),
        num_segments=id_cap)
    keep = raw_sizes >= config.min_region_inliers
    remap = jnp.cumsum(keep.astype(jnp.int32)) - 1
    new_id = jnp.where(keep, remap, -1)

    def relabel(lbl):
        safe = jnp.clip(lbl, 0, id_cap - 1)
        return jnp.where(lbl >= 0, new_id[safe], -1)

    point_labels = relabel(raw_point_labels)
    grid_labels = relabel(res.labels)
    grid_labels = jnp.where(res.labels < 0, res.labels, grid_labels)
    num_regions = jnp.sum(keep.astype(jnp.int32))
    r_cap = config.max_regions
    sizes = jax.ops.segment_sum(
        jnp.where((point_labels >= 0) & (point_labels < r_cap), 1, 0),
        jnp.clip(point_labels, 0, r_cap - 1), num_segments=r_cap)
    return UnorganizedClusterResult(
        point_labels=point_labels,
        grid_labels=grid_labels,
        num_regions=num_regions,
        region_sizes=sizes)


def cluster_unorganized_host(points,
                             config: ClusterRegionConfig
                             = ClusterRegionConfig(),
                             cell_size: float = 0.25,
                             grid_shape=(512, 512),
                             origin=None) -> UnorganizedClusterResult:
    """Native host fast path of :func:`cluster_unorganized` (NOT jittable).

    One call into hostops.pcseg_cluster_unorganized does voxelize +
    union-find CCL + point-count gate + scatter: after voxelization the
    work is ~15k cells, small enough for one core. Ids and labels are
    identical to the device path (ascending min-root order;
    equality-tested)."""
    import ctypes
    import numpy as np
    from pcseg_tpu import native as _native

    lib = _native.load_hostops()
    if lib is None:
        raise RuntimeError("native hostops unavailable")
    gx, gy = grid_shape
    pts_c = np.ascontiguousarray(np.asarray(points, np.float32))
    n = len(pts_c)
    point_labels = np.empty((n,), np.int32)
    cell_labels = np.empty((gx * gy,), np.int32)
    if origin is None:
        ox = oy = np.float32(np.nan)
    else:
        ox, oy = (np.float32(v) for v in np.asarray(origin)[:2])
    n_regions = lib.pcseg_cluster_unorganized(
        pts_c.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n,
        gx, gy, ctypes.c_float(cell_size),
        ctypes.c_float(ox), ctypes.c_float(oy),
        int(config.half_search_window),
        ctypes.c_float(config.squared_distance_threshold),
        int(config.min_region_inliers),
        point_labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        cell_labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    r_cap = config.max_regions
    keep = (point_labels >= 0) & (point_labels < r_cap)
    sizes = np.bincount(np.where(keep, point_labels, 0),
                        weights=keep.astype(np.int64),
                        minlength=r_cap)[:r_cap].astype(np.int32)
    return UnorganizedClusterResult(
        point_labels=point_labels,
        grid_labels=cell_labels.reshape(gx, gy),
        num_regions=np.int32(n_regions),
        region_sizes=sizes)


def cluster_unorganized_mean_shift(
        points,
        config: ClusterRegionConfig = ClusterRegionConfig(),
        cell_size: float = 0.25,
        grid_shape=(512, 512),
        origin=None,
        iterations: int = 5,
        params: MeanShiftParams = MeanShiftParams(),
        backend: str = "auto") -> UnorganizedClusterResult:
    """ClusterMethod.MEAN_SHIFT on a [N, 3] unorganized cloud
    (region_segmentation_config.proto:23-29 + BASELINE config 3).

    Voxelizes to a cell-centroid grid (like :func:`cluster_unorganized`),
    runs SlidingMeanShift over the organized representative grid, scatters
    cell labels back to points.

    ``backend``: "host" runs the mode fixed point + growth in the native
    C++ runtime (pcseg_tpu/native/hostops.cc pcseg_mean_shift_grid) —
    after voxelization a ~1M-point cloud reduces to ~10-20k occupied
    cells, little enough work for one core; "device" keeps every hot phase
    a device program (the multi-chip composition path); "auto" = host when
    the native lib is available.
    """
    import numpy as np
    from pcseg_tpu import native as _native

    gx, gy = grid_shape
    lib = _native.load_hostops() if backend in ("auto", "host") else None
    if backend == "host" and lib is None:
        raise RuntimeError("native hostops unavailable for backend='host'")
    if lib is not None:
        # the host fast path never touches the device: ONE native call
        # does voxelize + mean shift + growth + point scatter
        import ctypes
        pts_c = np.ascontiguousarray(np.asarray(points, np.float32))
        n = len(pts_c)
        point_labels = np.empty((n,), np.int32)
        cell_labels = np.empty((gx * gy,), np.int32)
        if origin is None:
            ox = oy = np.float32(np.nan)   # native computes the min
        else:
            ox, oy = (np.float32(v) for v in np.asarray(origin)[:2])
        n_regions = lib.pcseg_mean_shift_points(
            pts_c.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n,
            gx, gy, ctypes.c_float(cell_size),
            ctypes.c_float(ox), ctypes.c_float(oy),
            int(iterations), int(params.half_search_window),
            ctypes.c_float(params.square_distance_threshold),
            ctypes.c_float(params.min_support),
            ctypes.c_float(params.squared_centroid_distance_threshold),
            ctypes.c_float(params.squared_neighbor_distance_threshold),
            int(config.min_region_inliers), 0,
            point_labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            cell_labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        r_cap = config.max_regions
        keep = (point_labels >= 0) & (point_labels < r_cap)
        sizes = np.bincount(np.where(keep, point_labels, 0),
                            weights=keep.astype(np.int64),
                            minlength=r_cap)[:r_cap].astype(np.int32)
        return UnorganizedClusterResult(
            point_labels=point_labels,
            grid_labels=cell_labels.reshape(gx, gy),
            num_regions=np.int32(n_regions),
            region_sizes=sizes)

    grid = voxelize.voxelize_xy(points, cell_size, grid_shape, origin)
    grid_pts = np.asarray(grid.points)

    labels = np.full((gx, gy), UNLABELED, np.int32)
    from pcseg_tpu.models import mean_shift
    regions = mean_shift.sliding_mean_shift(
        grid_pts, labels, config, iterations, 0, params)

    r_cap = config.max_regions
    raw_point_labels = voxelize.scatter_labels_to_points(
        jnp.asarray(labels), grid.point_cell)

    sizes = jax.ops.segment_sum(
        jnp.where((raw_point_labels >= 0) & (raw_point_labels < r_cap),
                  1, 0),
        jnp.clip(raw_point_labels, 0, r_cap - 1), num_segments=r_cap)
    return UnorganizedClusterResult(
        point_labels=raw_point_labels,
        grid_labels=jnp.asarray(labels),
        num_regions=jnp.asarray(len(regions), jnp.int32),
        region_sizes=sizes)
