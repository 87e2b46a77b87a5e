"""Seed-point finders for planar region growing — dense reformulations.

Replaces the two finders of
pointcloud_segmentation/segmentation.h:
  * FindSeedPointsFromAverageNormals (:136-184) — sliding-window average
    normal length as a local planarity score; here a pair of separable box
    filters over the whole grid at once.
  * FindSeedPointsFromPlaneSupport (:190-230) — per-pixel plane support
    counting over an NxN window, ranked ascending so the driver (which pops
    seeds back-to-front, :254-255) processes the best-supported seeds first;
    here (2h+1)^2 shifted plane-distance tests + one device sort.

Parity quirk (replicated consciously): both reference finders index the
grids *transposed* — ``points.AtUnsafe(col, row)`` against a (row, col)
signature (segmentation.h:66,104,208-209 and the sliding-window updates
:93-104). On the square grids every fixture uses this reads the transposed
grid; on non-square grids the C++ reads out of bounds. We compute the
natural orientation on the transposed arrays, which is bit-equivalent on
square grids and well-defined (in-bounds) on rectangular ones.

The reference's weighted-average recurrence (:112-117) is algebraically
sum_i n_i * S_i / sum_i n_i over the window's per-row normal *sums* S_i
(not the plain mean — S_i enters unnormalized), and a window whose first
row has no valid normals hits a 0/0 that NaN-poisons the whole window
(rejecting it); both behaviors are replicated exactly.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from pcseg_tpu.models.config import (
    SeedsFromAverageNormalsParams, SeedsFromPlaneSupportParams)
from pcseg_tpu.ops import nansafe
from pcseg_tpu.ops.normals import _shift


def _box_sum_trailing(arr, n, axis):
    """Trailing box sum of length n along ``axis``: out[..k..] =
    sum(arr[.., k-n+1 : k+1, ..]) (partial near the leading edge)."""
    cs = jnp.cumsum(arr, axis=axis)
    shifted = jnp.roll(cs, n, axis=axis)
    # zero the wrapped part
    idx = jax.lax.broadcasted_iota(jnp.int32, arr.shape[:2], axis)
    if arr.ndim > 2:
        idx = idx[..., None]
    shifted = jnp.where(idx >= n, shifted, 0)
    return cs - shifted


def _box_sum_centered(arr, half, axis):
    """Centered box sum of radius ``half`` along ``axis`` (truncated at the
    borders)."""
    n = 2 * half + 1
    trailing = _box_sum_trailing(arr, n, axis)
    return jnp.roll(trailing, -half, axis=axis) if half else trailing


class SeedMask(NamedTuple):
    mask: jnp.ndarray        # [H, W] bool — (r, c) produces a seed
    seed_index: jnp.ndarray  # [H, W] int32 — emitted col-major linear index
    score: jnp.ndarray       # [H, W] — squared avg normal length / count


def seeds_from_average_normals(
        normals: jnp.ndarray,
        params: SeedsFromAverageNormalsParams = SeedsFromAverageNormalsParams(),
) -> SeedMask:
    """FindSeedPointsFromAverageNormals (segmentation.h:136-184), dense.

    normals: [H, W, 3]. Emits for position (r, c) the seed index
    ``lin(r, c) - half`` (the reference re-centers the seed half a window
    back along the minor axis, :178-179).
    """
    h, w = normals.shape[0], normals.shape[1]
    nbh = params.neighborhood_size
    half = nbh // 2

    if h < nbh or w < nbh:
        z = jnp.zeros((h, w), bool)
        return SeedMask(z, jnp.zeros((h, w), jnp.int32),
                        jnp.zeros((h, w), normals.dtype))

    # Work on the transposed grid (see module docstring).
    nt = jnp.swapaxes(normals, 0, 1)  # [W, H, 3]
    valid = nansafe.all_finite(nt)
    nvals = jnp.where(valid[..., None], nt, 0.0)

    # Per-row (axis0 of nt) trailing sums along axis1 over nbh columns:
    # S[a, c] = sum_j nt[a, c-j], counts likewise.
    s = _box_sum_trailing(nvals, nbh, axis=1)                   # [W, H, 3]
    cnt = _box_sum_trailing(valid.astype(nt.dtype), nbh, axis=1)  # [W, H]

    # Weighted combine over window rows a in r +- half (axis0):
    # avg = sum_a cnt*S / sum_a cnt  — the reference recurrence's closed form.
    numer = _box_sum_centered(cnt[..., None] * s, half, axis=0)
    denom = _box_sum_centered(cnt, half, axis=0)

    avg = numer / jnp.where(denom > 0, denom, 1.0)[..., None]
    score = jnp.sum(avg * avg, axis=-1)

    # 0/0 NaN-poisoning: the first window row (a = r - half) must have at
    # least one valid normal (segmentation.h:112-116 divides by a zero
    # running total otherwise and the NaN sticks).
    first_cnt = _shift(cnt, half, 0, 0.0)  # first_cnt[r] = cnt[r - half]
    rows_t = jax.lax.broadcasted_iota(jnp.int32, (w, h), 0)
    cols_t = jax.lax.broadcasted_iota(jnp.int32, (w, h), 1)

    # Position (a, b) of the transposed computation is the reference's loop
    # (row=a in [half, H-half), col=b in [nbh-1, W)) — on a square grid these
    # bounds coincide with the array extents; on rectangular grids the C++
    # is out-of-bounds UB and we simply keep everything in range.
    min_sq = params.min_avg_normal_length ** 2
    mask_t = ((rows_t >= half) & (rows_t < h - half)
              & (cols_t >= nbh - 1) & (cols_t < w)
              & (denom >= params.min_num_valid_normals)
              & (first_cnt > 0)
              & (score >= min_sq))

    # mask_t / score are [W, H]-shaped but indexed by (row, col); crop or
    # pad to the [H, W] output frame.
    def to_hw(arr, fill):
        out = jnp.full((h, w), fill, arr.dtype)
        hh, ww = min(h, arr.shape[0]), min(w, arr.shape[1])
        return out.at[:hh, :ww].set(arr[:hh, :ww])

    mask = to_hw(mask_t, False)
    score_rc = to_hw(score, jnp.asarray(0.0, score.dtype))
    rows = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    seed_index = cols * h + rows - half
    return SeedMask(mask=mask, seed_index=seed_index, score=score_rc)


def average_normal_seed_list(seed_mask: SeedMask, max_seeds: int):
    """Ranked seed vector in the reference's emit order (row-outer then
    column scan, segmentation.h:159-181): returns (indices [max_seeds],
    valid [max_seeds]); the driver pops back-to-front. Over capacity, the
    back of the vector (the first-popped seeds) is kept."""
    h, w = seed_mask.mask.shape
    rows = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    scan_pos = rows * w + cols  # row-outer scan order
    key = jnp.where(seed_mask.mask, scan_pos, -1).reshape(-1)
    order = jnp.argsort(key)[-max_seeds:]
    valid = key[order] >= 0
    indices = seed_mask.seed_index.reshape(-1)[order]
    return jnp.where(valid, indices, 0), valid


class RankedSeeds(NamedTuple):
    indices: jnp.ndarray  # [max_seeds] int32 col-major linear indices
    valid: jnp.ndarray    # [max_seeds] bool
    count: jnp.ndarray    # [H, W] int32 support counts (diagnostic)
    # [H, W] int32 dense pop-priority grid covering EVERY qualifying seed
    # (smaller = popped earlier); INF (2^30) where not a seed. The batched
    # grower consumes this directly — unlike the top-``max_seeds`` vector
    # it cannot starve low-ranked seeds on large grids (the reference's
    # seed list is unbounded, segmentation.h:200-229).
    rank_grid: jnp.ndarray = None


def plane_support_counts(points, normals, params):
    """Per-pixel plane-support counts in the *natural* orientation: the
    plane at (r, c) tested against the window points[r±h, c±h]. Used
    directly by the sharded pipeline (which drops the transposed-access
    quirk) and via transposed inputs for reference parity."""
    finite_pts = nansafe.all_finite(points)
    center_ok = finite_pts & nansafe.all_finite(normals)
    half = params.neighborhood_size // 2
    d = -jnp.sum(normals * points, axis=-1)
    count = jnp.zeros(points.shape[:2], jnp.int32)
    for dr in range(-half, half + 1):
        for dc in range(-half, half + 1):
            q = _shift(points, -dr, -dc, jnp.nan)  # q[a,b] = points[a+dr, b+dc]
            # explicit neighbor-validity AND: NaN `dist < tau` is not a
            # trustworthy exclusion inside fused programs (ops/nansafe.py)
            q_ok = _shift(finite_pts, -dr, -dc, False)
            dist = jnp.abs(jnp.sum(normals * q, axis=-1) + d)
            count = count + ((dist < params.max_plane_distance)
                             & q_ok).astype(jnp.int32)
    return count, center_ok


def rank_plane_support_seeds(count, qualifies, h, w, max_seeds):
    """Reference multimap ranking: (count asc, col-major scan position asc);
    the driver pops back-to-front so the best seed is consumed first.

    When more than ``max_seeds`` qualify, the TOP of the ranking (the back
    of the ascending vector — the seeds the driver actually consumes) is
    kept: invalid entries key below every valid one, so taking the last
    ``max_seeds`` of the ascending sort keeps the best seeds in pop order.
    """
    rows = jax.lax.broadcasted_iota(jnp.int32, count.shape, 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, count.shape, 1)
    lin_idx = cols * h + rows
    # int32 key safe while (window_area+1) * H * W < 2^31.
    key = jnp.where(qualifies, count * (h * w) + lin_idx, -1).reshape(-1)
    order = jnp.argsort(key)[-max_seeds:]
    valid = key[order] >= 0
    indices = lin_idx.reshape(-1)[order]
    return jnp.where(valid, indices, 0), valid


# == models.planar_batched.INF_RANK. A numpy scalar (not jnp): module
# import must not initialize the XLA backend (multi-host bring-up needs
# jax.distributed.initialize before any backend touch).
SEED_RANK_INF = np.int32(2 ** 30)


def plane_support_rank_grid(count, qualifies, h, w, cmax):
    """Dense [H, W] pop-priority grid from the support counts — every
    qualifying cell gets a unique rank, strictly monotone in the
    reference's pop order (count desc, col-major lin desc; the multimap is
    ascending and the driver pops back-to-front, segmentation.h:200-229,
    254-255). No ``max_seeds`` truncation: on VGA grids the reference's
    seed list holds ~3*10^5 entries and regions seeded near its bottom are
    real (observed: a 3k-point far-floor region at rank ~2.6*10^5).

    ``count``/``qualifies`` may be in the transposed-parity layout — the
    iota math emits the same col-major index either way (on square grids;
    see seeds_from_plane_support) and the result is scattered into the
    natural [H, W] grid. int32-safe while (cmax+1) * H * W < 2^30.
    """
    rows = jax.lax.broadcasted_iota(jnp.int32, count.shape, 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, count.shape, 1)
    lin_idx = cols * h + rows
    hw = h * w
    rank = (cmax - count) * hw + (hw - 1 - lin_idx)
    vals = jnp.where(qualifies, rank, SEED_RANK_INF)
    # The scatter this used to do has a closed form. NATURAL orientation
    # (count shaped [h, w]): position (r, c) lands back at (r, c) — the
    # identity. TRANSPOSED-parity
    # orientation (count shaped [w, h], the reference's quirk): position
    # (a, b) emits col-major index b*h + a, so natural cell (r, c)
    # receives contributions from (a, b) = (r + k*h, c - k) for every
    # k >= 0 in range — on square grids exactly k=0 (a plain relayout),
    # on non-square grids a min over ceil(w/h) shifted planes (mirroring
    # the reference's own out-of-bounds index arithmetic, module
    # docstring), plus the old code's clip: emitted indices >= h*w all
    # min-folded into the last cell.
    if count.shape == (h, w):
        return vals
    assert count.shape == (w, h), (count.shape, h, w)
    hw = h * w
    out = jnp.full((h, w), SEED_RANK_INF, jnp.int32)
    inf = jnp.asarray(SEED_RANK_INF, jnp.int32)
    for k in range(-(-w // h)):
        # term[r, c] = vals[r + k*h, c - k] (out of range -> INF)
        r0 = k * h
        rows_avail = min(h, w - r0)
        cols_keep = min(h, w - k)       # c = k + b must stay < w
        if rows_avail <= 0 or cols_keep <= 0:
            break
        block = vals[r0:r0 + rows_avail, :cols_keep]
        padded = jnp.pad(block,
                         ((0, h - rows_avail), (k, w - k - cols_keep)),
                         constant_values=inf)
        out = jnp.minimum(out, padded)
    if (h - 1) * h + (w - 1) >= hw:  # clip engaged (tall grids)
        clipped = jnp.min(jnp.where(lin_idx >= hw, vals, inf))
        out = out.at[h - 1, w - 1].min(clipped)
    return out


def append_temporal_to_rank_grid(rank_grid, t_idx, t_found):
    """Scatter temporal seeds into a rank grid with ranks below every
    per-frame seed's: the reference APPENDS them to the vector
    (planar_region.h:516) and the driver pops back-to-front, so the last
    appended pops first."""
    h, w = rank_grid.shape
    hw = h * w
    t = t_idx.shape[0]
    rank = -(jnp.arange(t, dtype=jnp.int32) + 1)  # t[i] -> -(i + 1)
    ok = t_found & (t_idx >= 0) & (t_idx < hw)
    flat_cm = jnp.swapaxes(rank_grid, 0, 1).reshape(hw)
    flat_cm = flat_cm.at[jnp.clip(t_idx, 0, hw - 1)].min(
        jnp.where(ok, rank, SEED_RANK_INF))
    return jnp.swapaxes(flat_cm.reshape(w, h), 0, 1)


def seeds_from_last_regions(points, normals, prev_centroids, prev_normals,
                            prev_counts, prev_valid, pose_cur_prev,
                            max_distance: float,
                            max_normal_difference_angle: float):
    """Temporal seed transfer — FindSeedPointsFromLastPlanarRegions
    (planar_region.h:478-519).

    For each previous region (centroid+normal moved into the current frame
    by ``pose_cur_prev``), find the nearest current point within
    ``max_distance`` whose normal agrees within the angle gate. Emitted in
    the reference's order: ascending previous inlier count (multimap),
    ties by region index. Returns (indices [R], found [R]) to append to a
    seed vector (the reference appends without clearing, :516).

    points/normals: [H, W, 3]; prev_*: [R, ...]; pose_cur_prev: geom.Pose.
    """
    import math as _math

    h, w = points.shape[0], points.shape[1]
    c_cur = pose_cur_prev.apply(prev_centroids)          # [R, 3]
    n_cur = pose_cur_prev.rotate(prev_normals)           # [R, 3]
    cos_gate = _math.cos(max_normal_difference_angle)

    flat_p = points.reshape(-1, 3)
    flat_n = normals.reshape(-1, 3)
    # [R, HW] squared distances; cross term as one matmul
    cross = jnp.dot(c_cur, flat_p.T, preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST)
    d2 = (jnp.sum(c_cur * c_cur, axis=-1, keepdims=True)
          - 2.0 * cross
          + jnp.sum(flat_p * flat_p, axis=-1)[None, :])
    ndot = jnp.dot(n_cur, flat_n.T, preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)
    # explicit finite-normal AND: `NaN ndot > cos_gate` compare-false is
    # not trustworthy inside large fused programs (ops/nansafe.py), and a
    # finite-point/NaN-normal cell must never be picked as a seed
    ok = (ndot > cos_gate) & (d2 < max_distance * max_distance) \
        & nansafe.all_finite(flat_p)[None, :] \
        & nansafe.all_finite(flat_n)[None, :]
    big = jnp.asarray(jnp.inf, points.dtype)
    masked = jnp.where(ok, d2, big)
    best = jnp.argmin(masked, axis=-1)
    found = (jnp.take_along_axis(masked, best[:, None], axis=-1)[:, 0]
             < big) & prev_valid
    # row-major flat -> col-major linear index
    rows = (best // w).astype(jnp.int32)
    cols = (best % w).astype(jnp.int32)
    lin = cols * h + rows
    # multimap order: ascending count, region-index tiebreak
    r = prev_counts.shape[0]
    order = jnp.argsort(prev_counts * r + jnp.arange(r, dtype=jnp.int32))
    return lin[order], found[order]


def seeds_from_plane_support(
        points: jnp.ndarray,
        normals: jnp.ndarray,
        params: SeedsFromPlaneSupportParams = SeedsFromPlaneSupportParams(),
        transposed_parity: bool = True,
) -> RankedSeeds:
    """FindSeedPointsFromPlaneSupport (segmentation.h:190-230), dense.

    Returns the ranked seed vector in the reference's order: ascending
    support count, ties by scan position (multimap insertion order, which
    equals the col-major linear index) — the driver pops back-to-front so
    the best seed is consumed first.

    ``transposed_parity=True`` replicates the reference's transposed grid
    accesses (bit-parity on square grids); ``False`` uses the natural
    orientation — the corrected semantics used by the sharded pipeline.
    """
    h, w = points.shape[0], points.shape[1]
    max_seeds = params.max_seeds

    if h < params.neighborhood_size or w < params.neighborhood_size:
        return RankedSeeds(jnp.zeros((max_seeds,), jnp.int32),
                           jnp.zeros((max_seeds,), bool),
                           jnp.zeros((h, w), jnp.int32),
                           jnp.full((h, w), SEED_RANK_INF, jnp.int32))

    if transposed_parity:
        pt = jnp.swapaxes(points, 0, 1)   # [W, H, 3]
        nt = jnp.swapaxes(normals, 0, 1)
    else:
        pt, nt = points, normals

    count, center_ok = plane_support_counts(pt, nt, params)
    qualifies = center_ok & (count >= params.min_num_support_points)

    # In parity mode the transposed position (a, b) is the reference loop's
    # (row, col), so the ranking iota math yields exactly lin(row, col, h)
    # either way.
    indices, valid = rank_plane_support_seeds(
        count, qualifies, h, w, max_seeds)
    rank_grid = plane_support_rank_grid(
        count, qualifies, h, w, cmax=params.neighborhood_size ** 2 + 1)
    count_rc = jnp.swapaxes(count, 0, 1) if transposed_parity else count
    return RankedSeeds(indices=indices, valid=valid, count=count_rc,
                       rank_grid=rank_grid)
