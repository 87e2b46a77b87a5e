"""Euclidean cluster segmentation (the reference's SegmentRegions<ClusterRegion>).

Data-parallel reformulation of pointcloud_segmentation/cluster_region.h
+ the generic driver segmentation.h:239-292:

  * membership: gated connected components over the (2w+1)^2 window
    (closure of the BFS source-distance gate — exact on the reference's
    golden fixture, see ops/connectivity.py).
  * region identity: the reference assigns dense ids in acceptance order,
    which equals the order of each component's earliest-popped seed
    (seeds are consumed back-to-front, segmentation.h:254-255); rejected
    components quarantine until call end and then revert to kUnlabeled
    (segmentation.h:277-291), so they never affect final labels.
  * size filter: >= min_region_inliers (cluster_region.h:111-116).

Known divergence (bounded, documented): the reference enqueues each point at
most once per region attempt; a candidate rejected through its first source
is only re-enqueued by members processed *after* its rejection
(segmentation.h:265-275 + cluster_region.h:104-106). A point all of whose
tau-neighbors were processed before its rejection is therefore permanently
excluded even though it is closure-reachable. Closure includes it. On
geometrically coherent clouds (the golden fixture, depth scenes) the two
agree exactly; on adversarial i.i.d.-random clouds the measured disagreement
is <1% of points — inside the >=99% per-point label-agreement budget
(BASELINE.md north star).

Everything runs in one jitted program: CCL fixed point + segment reductions
+ one sort for dense id assignment.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from pcseg_tpu.models.config import UNLABELED, ClusterRegionConfig
from pcseg_tpu.ops import connectivity, nansafe


class ClusterResult(NamedTuple):
    labels: jnp.ndarray        # [H, W] int32 — final label grid
    num_regions: jnp.ndarray   # scalar int32
    region_sizes: jnp.ndarray  # [max_regions] int32 (0 past num_regions)
    roots: jnp.ndarray         # [H, W] int32 component roots (diagnostic)


def segment_clusters(points: jnp.ndarray,
                     labels: jnp.ndarray,
                     seed_indices: jnp.ndarray,
                     config: ClusterRegionConfig = ClusterRegionConfig(),
                     initial_id_offset: int = 0,
                     seed_valid: Optional[jnp.ndarray] = None,
                     canonical_seeds: bool = False,
                     need_sizes: bool = True) -> ClusterResult:
    """Segment euclidean clusters on an organized grid.

    Args:
      points: [H, W, 3] (NaN = invalid; never joins a cluster).
      labels: [H, W] int32 input labels; only UNLABELED points participate
        (pre-labeled planar regions / masks are untouched).
      seed_indices: [S] int32 col-major linear seed indices in the
        *reference vector order* (the driver pops back-to-front, so the
        last entry is tried first — segmentation.h:254-255).
      config: cluster parameters.
      initial_id_offset: added to every assigned region id
        (segmentation.h:271).
      seed_valid: optional [S] bool mask for padded seed arrays.
      canonical_seeds: promise that ``seed_indices`` is the full canonical
        sweep [hw-1 .. 0] with no seed_valid mask (every pixel seeds, in
        ascending col-major pop order — the production pipeline's cluster
        closure). Then a component's founding pop priority IS its root
        (min eligible col-major index), so the priority scatter, the
        per-component min-reduction, and the full-grid argsort are all
        skipped.
      need_sizes: when False (stream serving path), ``region_sizes`` is
        returned as zeros and, when the configuration permits, acceptance
        is decided by an exact windowed same-root count instead of the
        307k-segment scatter + top_k: a gated
        component has >= m members iff ANY member sees >= m same-root
        cells within Chebyshev radius w*(m-1) (BFS from a member gains
        >= 1 cell per ring until the component is exhausted, and the whole
        component lies within that radius when its size < m). Labels and
        num_regions are identical to the general path (tested).

    Returns ClusterResult with dense region ids assigned exactly like the
    reference (verified against clustering_test.cc:127-151; the canonical
    fast path is asserted identical to the general path in tests).
    """
    h, w = points.shape[0], points.shape[1]
    hw = h * w
    big = jnp.int32(hw)
    inf = jnp.int32(2**31 - 1)

    # bit-level finite test: a compiler may fold jnp.isfinite away inside
    # large fused programs (see ops/nansafe.py)
    finite = nansafe.all_finite(points)
    eligible = (labels == UNLABELED) & finite

    if config.ccl_mode == "scan":
        roots = connectivity.connected_components_scan(
            points, eligible,
            jnp.asarray(config.squared_distance_threshold, points.dtype),
            config.half_search_window, rounds=config.scan_rounds)
    else:
        roots = connectivity.connected_components_window(
            points, eligible,
            jnp.asarray(config.squared_distance_threshold, points.dtype),
            config.half_search_window)

    # --- per-component sizes (keyed by col-major root index) ----------------
    sizes = connectivity.segment_field(
        eligible.astype(jnp.int32), roots, eligible, h, w, "sum")

    max_regions = config.max_regions
    # exact windowed-acceptance radius (see need_sizes docstring); only
    # worth unrolling for small radii (the production 8-neighborhood with
    # min 7 inliers -> radius 6, 168 shifted compares)
    win_r = config.half_search_window * (config.min_region_inliers - 1)
    if canonical_seeds and not need_sizes and win_r <= 6:
        cnt = jnp.ones(points.shape[:2], jnp.int32)
        for dr in range(-win_r, win_r + 1):
            for dc in range(-win_r, win_r + 1):
                if dr == 0 and dc == 0:
                    continue
                nb = connectivity._shift2(roots, dr, dc, big)
                cnt = cnt + (nb == roots).astype(jnp.int32)
        # per-pixel acceptance (constant across a component); ineligible
        # neighbors carry root BIG != any eligible root, so no masking
        # beyond the final eligibility gate is needed
        acc_px = eligible & (cnt >= config.min_region_inliers)
        # dense ids ascend by root index: cumsum of the accepted-ROOT
        # indicator in col-major order (roots are col-major min indices)
        lin_grid = connectivity.colmajor_index_grid(h, w)
        acc_root_cm = jnp.swapaxes(
            acc_px & (roots == lin_grid), 0, 1).reshape(-1)
        order_cm = jnp.cumsum(acc_root_cm.astype(jnp.int32)) - 1
        num_regions = jnp.sum(acc_root_cm.astype(jnp.int32))
        point_region = jnp.where(
            acc_px, order_cm[jnp.clip(roots, 0, hw - 1)], -1)
        new_labels = jnp.where(point_region >= 0,
                               point_region + initial_id_offset, labels)
        return ClusterResult(labels=new_labels, num_regions=num_regions,
                             region_sizes=jnp.zeros((max_regions,),
                                                    jnp.int32),
                             roots=roots)
    if canonical_seeds:
        # Founding pop priority of a component == its root index (every
        # pixel seeds, ascending col-major pop order), so acceptance order
        # == ascending root order: dense ids by cumsum over the accepted-
        # root indicator, no scatter/argsort.
        accepted = sizes >= config.min_region_inliers   # [HW] by root index
        region_id_by_root = jnp.where(
            accepted, jnp.cumsum(accepted.astype(jnp.int32)) - 1, -1)
        num_regions = jnp.sum(accepted.astype(jnp.int32))
        # region sizes table = sizes of the first max_regions accepted roots
        # in ascending root order: a top_k over a strictly-descending-in-root
        # key (top_k is a partial selection; a full-grid lax.sort is not)
        key = jnp.where(accepted, big - jnp.arange(hw, dtype=jnp.int32),
                        jnp.int32(0))
        # grids smaller than max_regions: top_k requires k <= size
        k_sel = min(max_regions, hw)
        _, top_roots = jax.lax.top_k(key, k_sel)
        region_sizes = jnp.where(
            jnp.arange(max_regions) < num_regions,
            sizes[jnp.pad(top_roots, (0, max_regions - k_sel))], 0)
    else:
        # --- seed pop priorities ---------------------------------------------
        s = seed_indices.shape[0]
        pop_pos = (s - 1) - jnp.arange(s, dtype=jnp.int32)  # last pops first
        if seed_valid is not None:
            pop_pos = jnp.where(seed_valid, pop_pos, inf)
        # eligibility of the seed point itself (pre-labeled seeds skipped,
        # segmentation.h:258-260)
        elig_cm = connectivity._lookup_colmajor(
            eligible, jnp.clip(seed_indices, 0, hw - 1).reshape(1, -1),
            h, w, False).reshape(-1)
        pop_pos = jnp.where(elig_cm, pop_pos, inf)

        prio_grid_flat_cm = jnp.full((hw,), inf, jnp.int32)
        prio_grid_flat_cm = prio_grid_flat_cm.at[
            jnp.clip(seed_indices, 0, hw - 1)].min(pop_pos)
        # convert to row-major grid to align with roots
        prio_grid = prio_grid_flat_cm.reshape(w, h).T

        min_prio = connectivity.segment_field(
            jnp.where(eligible, prio_grid, inf), roots, eligible, h, w,
            "min")

        accepted = (sizes >= config.min_region_inliers) & (min_prio < inf)

        # --- dense ids in acceptance order (ascending founding pop pos) -----
        sort_key = jnp.where(accepted, min_prio, inf)
        order = jnp.argsort(sort_key)                      # [HW]
        ranks_sorted = jnp.cumsum(accepted[order].astype(jnp.int32)) - 1
        region_id_by_root = jnp.full((hw,), -1, jnp.int32).at[order].set(
            jnp.where(accepted[order], ranks_sorted, -1))
        num_regions = jnp.sum(accepted.astype(jnp.int32))

        region_sizes = jnp.zeros((max_regions,), jnp.int32)
        valid_root = accepted & (region_id_by_root < max_regions) \
            & (region_id_by_root >= 0)
        region_sizes = region_sizes.at[
            jnp.where(valid_root, region_id_by_root, max_regions - 1)].add(
            jnp.where(valid_root, sizes, 0), mode="drop")

    point_region = region_id_by_root[jnp.clip(roots, 0, hw - 1)]
    point_region = jnp.where((roots < hw) & eligible, point_region, -1)
    new_labels = jnp.where(point_region >= 0,
                           point_region + initial_id_offset, labels)

    return ClusterResult(labels=new_labels, num_regions=num_regions,
                         region_sizes=region_sizes, roots=roots)


def gather_region_indices(labels, region_id, order="colmajor"):
    """Host helper: col-major linear indices of a region's members, ascending.

    The reference's inlier lists follow BFS discovery order; we normalize to
    ascending col-major index (documented divergence — the *set* is what the
    outputs depend on)."""
    import numpy as np
    lbl = np.asarray(labels)
    h = lbl.shape[0]
    rows, cols = np.nonzero(lbl == region_id)
    idx = cols * h + rows
    return np.sort(idx)
