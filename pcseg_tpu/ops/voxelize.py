"""Voxel-hash organization of unorganized point clouds.

The reference treats unorganized clouds as 1-row grids
(multichannel_cloud.proto:39-40) where every windowed algorithm degenerates
to linear adjacency — there is no real unorganized story. The device
design (BASELINE config 3: mean-shift / euclidean clustering on ~1M-point
clouds) scatters points into a dense 2-D bird's-eye grid of voxel
representatives, runs the organized windowed kernels on that grid, and maps
labels back through each point's cell id. All scatter/gather is static-shape
segment arithmetic.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from pcseg_tpu.ops import nansafe


class VoxelGrid(NamedTuple):
    points: jnp.ndarray       # [Gx, Gy, 3] cell centroids (NaN empty)
    counts: jnp.ndarray       # [Gx, Gy] int32 points per cell
    point_cell: jnp.ndarray   # [N] int32 row-major cell id (-1 off-grid)
    origin: jnp.ndarray       # [2]
    cell_size: jnp.ndarray    # scalar


def voxelize_xy(points: jnp.ndarray, cell_size: float,
                grid_shape: tuple, origin=None) -> VoxelGrid:
    """Scatter an unorganized [N, 3] cloud into a [Gx, Gy] XY grid.

    Cell representative = centroid of its points (a mergeable first-moment
    accumulator, so multi-shard voxelization composes with psum).
    """
    gx, gy = grid_shape
    n = points.shape[0]
    finite = nansafe.all_finite(points)
    pts = jnp.where(finite[:, None], points, 0.0)

    if origin is None:
        big = jnp.asarray(1e30, points.dtype)
        mins = jnp.min(jnp.where(finite[:, None], pts[:, :2], big), axis=0)
        origin = mins
    origin = jnp.asarray(origin, points.dtype)

    ij = jnp.floor((pts[:, :2] - origin) / cell_size).astype(jnp.int32)
    inb = finite & (ij[:, 0] >= 0) & (ij[:, 0] < gx) \
        & (ij[:, 1] >= 0) & (ij[:, 1] < gy)
    cell = jnp.where(inb, ij[:, 0] * gy + ij[:, 1], gx * gy)

    sums = jax.ops.segment_sum(
        jnp.where(inb[:, None], pts, 0.0), cell,
        num_segments=gx * gy + 1)[:gx * gy]
    counts = jax.ops.segment_sum(
        inb.astype(jnp.int32), cell, num_segments=gx * gy + 1)[:gx * gy]

    denom = jnp.maximum(counts, 1).astype(points.dtype)
    centroids = jnp.where(counts[:, None] > 0, sums / denom[:, None],
                          jnp.nan)
    return VoxelGrid(points=centroids.reshape(gx, gy, 3),
                     counts=counts.reshape(gx, gy),
                     point_cell=jnp.where(inb, cell, -1),
                     origin=origin,
                     cell_size=jnp.asarray(cell_size, points.dtype))


def scatter_labels_to_points(grid_labels: jnp.ndarray,
                             point_cell: jnp.ndarray,
                             fill=-1) -> jnp.ndarray:
    """Per-point labels from per-cell labels ([Gx, Gy] row-major ids)."""
    flat = grid_labels.reshape(-1)
    safe = jnp.clip(point_cell, 0, flat.shape[0] - 1)
    out = flat[safe]
    return jnp.where(point_cell >= 0, out, fill)


def voxelize_xy_np(points, cell_size: float, grid_shape, origin=None):
    """NumPy twin of :func:`voxelize_xy` for the native host fast path
    (models/unorganized.py backend='host') — np.bincount does the 1M-point
    scatter without touching the device. Same cell assignment
    (integer-exact); centroids
    accumulate in f64 (vs the device's f32 segment sums) before the f32
    cast — the per-cell difference is an f32 ulp."""
    import numpy as np

    gx, gy = grid_shape
    pts = np.asarray(points, np.float32)
    finite = np.isfinite(pts).all(axis=-1)
    safe = np.where(finite[:, None], pts, 0.0)
    if origin is None:
        xy = np.where(finite[:, None], safe[:, :2], np.float32(1e30))
        origin = xy.min(axis=0)
    origin = np.asarray(origin, np.float32)
    ij = np.floor((safe[:, :2] - origin) / np.float32(cell_size)) \
        .astype(np.int32)
    inb = finite & (ij[:, 0] >= 0) & (ij[:, 0] < gx) \
        & (ij[:, 1] >= 0) & (ij[:, 1] < gy)
    cell = np.where(inb, ij[:, 0] * gy + ij[:, 1], gx * gy)

    counts = np.bincount(cell, minlength=gx * gy + 1)[:gx * gy]
    sums = np.stack([
        np.bincount(cell, weights=np.where(inb, safe[:, k], 0.0),
                    minlength=gx * gy + 1)[:gx * gy]
        for k in range(3)], axis=-1)
    denom = np.maximum(counts, 1).astype(np.float32)
    centroids = np.where(counts[:, None] > 0,
                         (sums / denom[:, None]).astype(np.float32),
                         np.float32(np.nan))
    return VoxelGrid(points=centroids.reshape(gx, gy, 3),
                     counts=counts.reshape(gx, gy).astype(np.int32),
                     point_cell=np.where(inb, cell, -1).astype(np.int32),
                     origin=origin,
                     cell_size=np.float32(cell_size))
