"""Planar region growing — sequential-seed wavefront BFS on device.

Data-parallel reformulation of SegmentRegions<PlanarRegion>
(pointcloud_segmentation/segmentation.h:239-292 +
planar_region.h:89-465):

  * Seeds are consumed in the reference's pop order (back of the vector
    first); the next still-unlabeled seed is found with one vectorized
    gather+argmax per region attempt instead of per-seed queue iterations.
  * Each region grows as a parallel BFS wavefront: frontier dilation over
    the 4-neighborhood (planar_region.h:236-254), inlier gate
    |plane . p| < max_plane_distance (planar_region.h:168), rejected
    candidates retestable in later waves when they gain a newly accepted
    neighbor — matching the reference's reset-to-kUnlabeled semantics
    (planar_region.h:181).
  * The plane is re-estimated from the accumulated moments whenever the
    inlier count crosses a multiple of plane_model_reestimation_period
    (planar_region.h:172-177). Divergence vs the reference: the reference
    re-estimates mid-queue at the exact 30th inlier, we re-estimate at the
    wave boundary that crosses it; within the >=99% agreement budget.
  * Quarantine semantics are exact: regions failing min_region_inliers mark
    their members kAlreadyExamedPoint for the remainder of the call, then
    reset to kUnlabeled (segmentation.h:277-291).
  * Area / extent / hull checks (planar_region.h:205-223) are deferred to a
    host post-pass (models/boundary.py): rejected-there regions revert to
    kUnlabeled and surviving ids are compacted — final labels are identical
    because accepted and quarantined regions block later growth the same
    way during the call.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from pcseg_tpu.models.config import (
    UNLABELED, EXAMINED, PlanarRegionConfig)
from pcseg_tpu.ops import geom, nansafe, plane_fit
from pcseg_tpu.ops.normals import _shift


class PlanarRegions(NamedTuple):
    """Bounded per-frame region table (capacity = config.max_regions)."""
    labels: jnp.ndarray      # [H, W] int32 final device labels
    num_regions: jnp.ndarray  # scalar int32 — device-accepted count
    planes: jnp.ndarray      # [R, 4] final plane coeffs (estimator solve)
    centroids: jnp.ndarray   # [R, 3]
    curvatures: jnp.ndarray  # [R]
    counts: jnp.ndarray      # [R] int32 inlier counts
    seed_indices: jnp.ndarray  # [R] int32 col-major seed index
    moments: plane_fit.PlaneMoments  # batched [R] — mergeable across shards
    overflow: jnp.ndarray    # scalar bool — attempts or regions hit capacity


def _gather_cm(grid, idx):
    """grid[H, W(,C)] values at col-major linear indices idx (any shape)."""
    h, w = grid.shape[0], grid.shape[1]
    r = idx % h
    c = idx // h
    flat = grid.reshape((h * w,) + grid.shape[2:])
    return flat[(r * w + c).reshape(-1)].reshape(
        idx.shape + grid.shape[2:])


def _dilate4(mask):
    return (_shift(mask, 1, 0, False) | _shift(mask, -1, 0, False)
            | _shift(mask, 0, 1, False) | _shift(mask, 0, -1, False))


def grow_planar_regions(points: jnp.ndarray,
                        normals: jnp.ndarray,
                        labels: jnp.ndarray,
                        seed_indices: jnp.ndarray,
                        seed_valid: jnp.ndarray,
                        config: PlanarRegionConfig = PlanarRegionConfig(),
                        initial_id_offset: int = 0,
                        max_attempts: int = 256) -> PlanarRegions:
    """Grow planar regions from ranked seeds (fully jitted).

    Args:
      points/normals: [H, W, 3] (NaN invalid).
      labels: [H, W] int32; only UNLABELED points can be claimed.
      seed_indices: [S] col-major linear seeds in reference vector order
        (popped back-to-front).
      seed_valid: [S] bool for padded seed arrays.
      config: planar region parameters (area checks happen on host later).
      initial_id_offset: added to assigned ids (segmentation.h:271).
      max_attempts: static bound on region attempts (accepted + rejected).
    """
    h, w = points.shape[0], points.shape[1]
    dtype = points.dtype
    r_cap = config.max_regions
    tau = jnp.asarray(config.max_plane_distance, dtype)
    period = config.plane_model_reestimation_period
    min_inliers = config.min_region_inliers

    s = seed_indices.shape[0]
    seed_order = jnp.arange(s, dtype=jnp.int32)

    empty_regions = PlanarRegions(
        labels=labels,
        num_regions=jnp.int32(0),
        planes=jnp.zeros((r_cap, 4), dtype),
        centroids=jnp.zeros((r_cap, 3), dtype),
        curvatures=jnp.zeros((r_cap,), dtype),
        counts=jnp.zeros((r_cap,), jnp.int32),
        seed_indices=jnp.zeros((r_cap,), jnp.int32),
        moments=plane_fit.empty((r_cap,), dtype),
        overflow=jnp.bool_(False),
    )

    def grow_one(labels_in, seed_idx):
        """Grow a single region; returns (member_mask, plane, moments,
        count, solution)."""
        seed_point = _gather_cm(points, seed_idx[None])[0]
        seed_normal = _gather_cm(normals, seed_idx[None])[0]
        plane0 = geom.plane_from_normal_point(seed_normal, seed_point)
        m0 = plane_fit.set_normal_orientation(
            plane_fit.empty((), dtype), seed_normal)

        seed_r = seed_idx % h
        seed_c = seed_idx // h
        frontier0 = jnp.zeros((h, w), bool).at[seed_r, seed_c].set(True)
        member0 = jnp.zeros((h, w), bool)

        # finite mask is explicit and bit-level: NaN `dist < tau` is
        # not a trustworthy exclusion inside fused programs (ops/nansafe.py)
        eligible = (labels_in == UNLABELED) & nansafe.all_finite(points)

        def cond(state):
            member, frontier, plane, m, count, it, first = state
            return (jnp.any(frontier) | first) & (it < config.max_growth_iters)

        def body(state):
            member, frontier, plane, m, count, it, first = state
            # wave 0 candidates = the seed itself (tested like any candidate,
            # planar_region.h:158 pushes it through the same queue)
            cand = jnp.where(first, frontier,
                             _dilate4(frontier) & eligible & ~member)
            dist = jnp.abs(
                jnp.sum(plane[:3] * points, axis=-1) + plane[3])
            accepted = cand & (dist < tau)  # NaN fails

            new_member = member | accepted
            dm_s2, dm_s1, dm_w = plane_fit.moments_of_points(
                jnp.where(accepted[..., None], points, 0.0).reshape(-1, 3),
                accepted.astype(dtype).reshape(-1))
            new_m = m._replace(s2=m.s2 + dm_s2, s1=m.s1 + dm_s1,
                               w=m.w + dm_w)
            new_count = count + jnp.sum(accepted.astype(jnp.int32))

            # Re-estimate when the count crosses a multiple of the period.
            crossed = (new_count // period) > (count // period)

            def reestimate(args):
                mm, pl = args
                sol = plane_fit.solve(mm)
                # sticky orientation: the estimator keeps the previous
                # normal's sign (plane_estimator.cc:209-213); our solve
                # already signs by normal_hint, so refresh the hint. On an
                # invalid fit the reference recenters the plane on the new
                # centroid keeping the old normal (plane_estimator.cc:224-227).
                new_hint = jnp.where(sol.valid, sol.normal, mm.normal_hint)
                recentered = geom.plane_from_normal_point(
                    mm.normal_hint, sol.centroid)
                return mm._replace(normal_hint=new_hint), \
                    jnp.where(sol.valid, sol.plane, recentered)

            new_m, new_plane = jax.lax.cond(
                crossed, reestimate, lambda a: a, (new_m, plane))

            # After a re-estimation the reference's queue still holds
            # candidates that are then tested against the NEW plane
            # (planar_region.h:172-177 mutates plane_ mid-queue); emulate by
            # re-expanding the frontier to the whole member set so adjacent
            # candidates get retested under the updated plane.
            next_frontier = jnp.where(crossed, new_member, accepted)

            return (new_member, next_frontier, new_plane, new_m, new_count,
                    it + 1, jnp.bool_(False))

        if config.growth_mode == "hybrid":
            warmup = jnp.int32(config.warmup_inliers)

            def cond_warm(state):
                member, frontier, plane, m, count, it, first = state
                return ((jnp.any(frontier) | first)
                        & (count < warmup)
                        & (it < config.max_growth_iters))

            member, frontier, plane, m, count, _, first = \
                jax.lax.while_loop(
                    cond_warm, body,
                    (member0, frontier0, plane0, m0, jnp.int32(0),
                     jnp.int32(0), jnp.bool_(True)))

            # Epoch phase: between re-fits the inlier gate is fixed, so the
            # reachable set is the 4-connected component of the gate mask
            # containing the members — computed in O(log diameter) rounds.
            from pcseg_tpu.ops import connectivity

            def cond_epoch(state):
                member, plane, m, count, epoch, grew = state
                return grew & (epoch < config.max_growth_epochs)

            def body_epoch(state):
                member, plane, m, count, epoch, _ = state
                dist = jnp.abs(
                    jnp.sum(plane[:3] * points, axis=-1) + plane[3])
                gate = (eligible & (dist < tau)) | member
                reach = connectivity.reachable_from(gate, member)
                new_member = reach
                new_count = jnp.sum(new_member.astype(jnp.int32))
                s2, s1, wsum = plane_fit.moments_of_points(
                    jnp.where(new_member[..., None], points,
                              0.0).reshape(-1, 3),
                    new_member.astype(dtype).reshape(-1))
                new_m = m._replace(s2=s2, s1=s1, w=wsum)
                sol = plane_fit.solve(new_m)
                new_hint = jnp.where(sol.valid, sol.normal, m.normal_hint)
                new_m = new_m._replace(normal_hint=new_hint)
                recentered = geom.plane_from_normal_point(
                    m.normal_hint, sol.centroid)
                new_plane = jnp.where(sol.valid, sol.plane, recentered)
                grew = new_count > count
                return (new_member, new_plane, new_m, new_count,
                        epoch + 1, grew)

            member, plane, m, count, _, _ = jax.lax.while_loop(
                cond_epoch, body_epoch,
                (member, plane, m, count, jnp.int32(0),
                 jnp.bool_(True)))
            return member, plane, m, count

        member, _, plane, m, count, _, _ = jax.lax.while_loop(
            cond, body,
            (member0, frontier0, plane0, m0, jnp.int32(0), jnp.int32(0),
             jnp.bool_(True)))
        return member, plane, m, count

    def attempt_cond(state):
        regions, consumed, attempts = state
        seed_labels = _gather_cm(regions.labels, seed_indices)
        available = (seed_valid & ~consumed
                     & (seed_labels == UNLABELED))
        return jnp.any(available) & (attempts < max_attempts) \
            & (regions.num_regions < r_cap)

    def attempt_body(state):
        regions, consumed, attempts = state
        seed_labels = _gather_cm(regions.labels, seed_indices)
        available = (seed_valid & ~consumed
                     & (seed_labels == UNLABELED))
        # pop order: highest vector position first
        pos = jnp.where(available, seed_order, -1)
        pick = jnp.argmax(pos)
        seed_idx = seed_indices[pick]
        consumed = consumed.at[pick].set(True)

        member, plane, m, count = grow_one(regions.labels, seed_idx)

        accept = count >= min_inliers
        rid = regions.num_regions
        label_val = jnp.where(accept, rid + initial_id_offset,
                              jnp.int32(EXAMINED))
        new_labels = jnp.where(member, label_val, regions.labels)

        sol = plane_fit.solve(m._replace(
            normal_hint=plane[:3]))  # final lazy solve keeps last sign

        def write(r):
            return r._replace(
                num_regions=rid + 1,
                planes=r.planes.at[rid].set(
                    jnp.where(sol.valid, sol.plane, plane)),
                centroids=r.centroids.at[rid].set(sol.centroid),
                curvatures=r.curvatures.at[rid].set(sol.curvature),
                counts=r.counts.at[rid].set(count),
                seed_indices=r.seed_indices.at[rid].set(seed_idx),
                moments=plane_fit.PlaneMoments(
                    s2=r.moments.s2.at[rid].set(m.s2),
                    s1=r.moments.s1.at[rid].set(m.s1),
                    w=r.moments.w.at[rid].set(m.w),
                    normal_hint=r.moments.normal_hint.at[rid].set(
                        m.normal_hint)),
            )

        regions = jax.lax.cond(
            accept, write, lambda r: r, regions._replace(labels=new_labels))
        return regions, consumed, attempts + 1

    regions, consumed, attempts = jax.lax.while_loop(
        attempt_cond, attempt_body,
        (empty_regions, jnp.zeros((s,), bool), jnp.int32(0)))

    # kAlreadyExamedPoint -> kUnlabeled at call end (segmentation.h:287-291)
    final_labels = jnp.where(regions.labels == EXAMINED, UNLABELED,
                             regions.labels)
    overflow = (attempts >= max_attempts) | (regions.num_regions >= r_cap)
    return regions._replace(labels=final_labels, overflow=overflow)
