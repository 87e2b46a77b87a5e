"""End-to-end frame segmentation pipeline (the reference's composition).

The reference library has no driver; its tests and downstream robot code
compose: normals -> seed finding -> planar region growing -> classification
-> euclidean clustering -> detected-object extraction (SURVEY.md §3). This
module provides that composition as a ``Segmenter``:

  * ``device_forward``: the fully-jittable device portion (normals, seed
    ranking, planar growth, cluster closure) — one XLA program, the
    benchmark / graft entry point.
  * ``segment_frame``: the complete pipeline including the host finalize
    (boundary/hull/area gates), classification, a second device pass for
    clustering over the finalized labels, and detected-object extraction.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from pcseg_tpu.models import boundary, classify, cluster, extract, planar
from pcseg_tpu.models.config import (
    UNLABELED, ClusterMethod, ClusterRegionConfig, ComputeNormalsParams,
    MeanShiftParams, PlaneClassificationConfig, PlanarRegionConfig,
    SeedsFromPlaneSupportParams, SeedsFromAverageNormalsParams,
    SEMANTIC_UNKNOWN)
from pcseg_tpu.ops import normals as normals_op
from pcseg_tpu.ops import seeds as seeds_op


@dataclasses.dataclass(frozen=True)
class SegmenterConfig:
    normals: ComputeNormalsParams = ComputeNormalsParams()
    seed_method: str = "plane_support"  # or "average_normals"
    plane_support_seeds: SeedsFromPlaneSupportParams = \
        SeedsFromPlaneSupportParams()
    average_normal_seeds: SeedsFromAverageNormalsParams = \
        SeedsFromAverageNormalsParams()
    planar: PlanarRegionConfig = PlanarRegionConfig()
    cluster: ClusterRegionConfig = ClusterRegionConfig()
    classification: PlaneClassificationConfig = PlaneClassificationConfig()
    up_direction: tuple = (0.0, 0.0, 1.0)
    known_floor_point: tuple = (0.0, 0.0, -1.0)
    run_clustering: bool = True
    max_region_attempts: int = 256
    # ClusterMethod.MEAN_SHIFT (region_segmentation_config.proto:23-29)
    # knobs: the reference's SlidingMeanShift takes the iteration count as a
    # call argument (mean_shift_segmentation.h:209); constants from
    # mean_shift_segmentation.h:31-51.
    mean_shift: MeanShiftParams = MeanShiftParams()
    mean_shift_iterations: int = 5


class FrameMetrics(NamedTuple):
    """Per-stage counters (the observability pytree; SURVEY.md §5)."""
    num_seeds: int
    num_device_planar_regions: int
    num_planar_regions: int
    num_clusters: int
    planar_overflow: bool


@dataclasses.dataclass
class FrameResult:
    labels: np.ndarray                 # [H, W] final label grid
    # None: normals stay on device — the discontinuity stencil (their only
    # host consumer) moved into the device program (ops/discontinuity.py),
    # so [H, W, 3] f32 never crosses the host link. Use
    # ops.normals.compute_normals_organized directly if you need them.
    normals: Optional[np.ndarray]
    planar_regions: List               # PlanarRegionRecord (classified)
    num_clusters: int
    cluster_sizes: np.ndarray
    objects: List[extract.DetectedObject]
    metrics: FrameMetrics
    classification_summary: classify.ClassificationDebugSummary


class Segmenter:
    """Stateless jitted pipeline over organized [H, W] clouds."""

    def __init__(self, config: SegmenterConfig = SegmenterConfig()):
        self.config = config
        self._planar_stage = jax.jit(self._planar_payload_impl)
        self._planar_stage_temporal = jax.jit(
            self._planar_payload_temporal_impl)
        self._cluster_stage = jax.jit(self._cluster_payload_impl)
        self._forward = jax.jit(self._forward_impl)
        self._full_stage = jax.jit(self._full_payload_impl)
        self._full_stage_temporal = jax.jit(self._full_payload_temporal_impl)

    # -- device programs ----------------------------------------------------

    def _rank_seeds(self, points, normals):
        """(seed_idx, seed_valid, rank_grid-or-None). The plane-support
        finder supplies a dense rank grid (every qualifying seed, no
        max_seeds cap — the reference's seed list is unbounded); the
        average-normal finder emits its bounded list."""
        cfg = self.config
        if cfg.seed_method == "plane_support":
            ranked = seeds_op.seeds_from_plane_support(
                points, normals, cfg.plane_support_seeds)
            return ranked.indices, ranked.valid, ranked.rank_grid
        mask = seeds_op.seeds_from_average_normals(
            normals, cfg.average_normal_seeds)
        # The list is in the reference's emit order; the growing driver pops
        # back-to-front exactly like SegmentRegions (segmentation.h:254-255).
        idx, valid = seeds_op.average_normal_seed_list(
            mask, cfg.plane_support_seeds.max_seeds)
        return idx, valid, None

    def _grow(self, points, nrm, labels0, seed_idx, seed_valid,
              rank_grid=None):
        cfg = self.config
        if cfg.planar.growth_mode == "batched":
            from pcseg_tpu.models import planar_batched
            return planar_batched.grow_planar_regions_batched(
                points, nrm, labels0, seed_idx, seed_valid, cfg.planar,
                initial_id_offset=0, seed_rank_grid=rank_grid)
        return planar.grow_planar_regions(
            points, nrm, labels0, seed_idx, seed_valid, cfg.planar,
            initial_id_offset=0, max_attempts=cfg.max_region_attempts)

    def _planar_stage_impl(self, points, sensor_origin, labels0=None):
        cfg = self.config
        with jax.named_scope("normals"):
            nrm = normals_op.compute_normals_organized(
                points, sensor_origin, cfg.normals)
        with jax.named_scope("seeds"):
            seed_idx, seed_valid, rank_grid = self._rank_seeds(points, nrm)
        if labels0 is None:
            labels0 = jnp.full(points.shape[:2], UNLABELED, jnp.int32)
        with jax.named_scope("grow"):
            dev = self._grow(points, nrm, labels0, seed_idx, seed_valid,
                             rank_grid)
        num_seeds = jnp.sum(seed_valid.astype(jnp.int32)) \
            if rank_grid is None \
            else jnp.sum((rank_grid < seeds_op.SEED_RANK_INF)
                         .astype(jnp.int32))
        return nrm, dev, num_seeds

    def _planar_stage_temporal_impl(self, points, sensor_origin, labels0,
                                    prev_centroids, prev_normals,
                                    prev_counts, prev_valid, pose_quat,
                                    pose_trans):
        """Planar stage with temporal seed transfer: seeds from the previous
        frame's regions (FindSeedPointsFromLastPlanarRegions,
        planar_region.h:478-519) are APPENDED to the ranked vector — the
        driver pops back-to-front, so they are tried first, largest
        previous region first (multimap ascending order, appended last)."""
        from pcseg_tpu.ops import geom
        cfg = self.config
        nrm = normals_op.compute_normals_organized(
            points, sensor_origin, cfg.normals)
        seed_idx, seed_valid, rank_grid = self._rank_seeds(points, nrm)
        t_idx, t_found = seeds_op.seeds_from_last_regions(
            points, nrm, prev_centroids, prev_normals, prev_counts,
            prev_valid, geom.Pose(pose_quat, pose_trans),
            cfg.planar.max_distance_for_seed_point,
            cfg.planar.max_normal_difference_angle_for_seed_point)
        num_seeds = jnp.sum(t_found.astype(jnp.int32))
        if rank_grid is None:
            seed_idx = jnp.concatenate([seed_idx, t_idx])
            seed_valid = jnp.concatenate([seed_valid, t_found])
            num_seeds = num_seeds + jnp.sum(seed_valid.astype(jnp.int32))
        else:
            rank_grid = seeds_op.append_temporal_to_rank_grid(
                rank_grid, t_idx, t_found)
            # temporal cells are already < INF in the merged grid
            num_seeds = jnp.sum(
                (rank_grid < seeds_op.SEED_RANK_INF).astype(jnp.int32))
        dev = self._grow(points, nrm, labels0, seed_idx, seed_valid,
                         rank_grid)
        return nrm, dev, num_seeds

    def _compact_payload(self, points, nrm, dev, num_seeds, rot_robot,
                         cres=None):
        """The D2H pytree of segment_frame, sized for the host link: int8
        label grids (region ids are < 128 by the static max_regions
        bounds), the per-region tables, and the device-computed
        discontinuity bit grid (ops/discontinuity.py) INSTEAD of the full
        [H, W, 3] normals (3.7 MB per VGA frame)."""
        from pcseg_tpu.ops import discontinuity
        with jax.named_scope("discontinuity"):
            disc = discontinuity.discontinuity_flags(
                points, nrm, dev.labels, rot_robot, self.config.planar)
        out = dict(
            dev_labels=dev.labels.astype(jnp.int8),
            planes=dev.planes, centroids=dev.centroids,
            curvatures=dev.curvatures, counts=dev.counts,
            seed_indices=dev.seed_indices, num_regions=dev.num_regions,
            overflow=dev.overflow, num_seeds=num_seeds, disc=disc)
        if cres is not None:
            out.update(cres_labels=cres.labels.astype(jnp.int8),
                       cres_num=cres.num_regions,
                       cres_sizes=cres.region_sizes)
        return out

    def _planar_payload_impl(self, points, sensor_origin, labels0,
                             rot_robot):
        nrm, dev, num_seeds = self._planar_stage_impl(points, sensor_origin,
                                                      labels0)
        return self._compact_payload(points, nrm, dev, num_seeds, rot_robot)

    def _planar_payload_temporal_impl(self, points, sensor_origin, labels0,
                                      rot_robot, *targs):
        nrm, dev, num_seeds = self._planar_stage_temporal_impl(
            points, sensor_origin, labels0, *targs)
        return self._compact_payload(points, nrm, dev, num_seeds, rot_robot)

    def _full_payload_impl(self, points, sensor_origin, labels0, rot_robot):
        """Planar stage + optimistic euclidean clustering in ONE program:
        segment_frame reuses the cluster result whenever the host finalize
        accepts every device-accepted region (the common case), avoiding a
        second dispatch + label round trip over the host link."""
        nrm, dev, num_seeds = self._planar_stage_impl(points, sensor_origin,
                                                      labels0)
        cres = self._cluster_stage_impl(points, dev.labels)
        return self._compact_payload(points, nrm, dev, num_seeds, rot_robot,
                                     cres)

    def _full_payload_temporal_impl(self, points, sensor_origin, labels0,
                                    rot_robot, *targs):
        nrm, dev, num_seeds = self._planar_stage_temporal_impl(
            points, sensor_origin, labels0, *targs)
        cres = self._cluster_stage_impl(points, dev.labels)
        return self._compact_payload(points, nrm, dev, num_seeds, rot_robot,
                                     cres)

    def _cluster_payload_impl(self, points, labels):
        # callers may ship labels as int8 over the link (ids < 128)
        cres = self._cluster_stage_impl(points, labels.astype(jnp.int32))
        return dict(cres_labels=cres.labels.astype(jnp.int8),
                    cres_num=cres.num_regions, cres_sizes=cres.region_sizes)

    def _cluster_stage_impl(self, points, labels):
        # every point is a clustering seed, popped in ascending col-major
        # order (the convention of clustering_test.cc:56-59)
        hw = points.shape[0] * points.shape[1]
        seed_vec = jnp.arange(hw - 1, -1, -1, dtype=jnp.int32)
        with jax.named_scope("cluster"):
            return cluster.segment_clusters(
                points, labels, seed_vec, self.config.cluster,
                initial_id_offset=0, canonical_seeds=True)

    def _forward_impl(self, points, sensor_origin, labels0=None,
                      need_sizes=True):
        """Pure-device forward: normals + planar growth + cluster closure.

        Uses device-side planar acceptance (min-inlier gate only) and
        offsets cluster ids by the device planar count — the benchmarkable
        single-program path. ``labels0`` (optional [H, W] int32) carries
        input masking: MASKED_EGO / MASKED_OUT cells are never claimed by
        growth or clustering (the reference's caller-prepared label grid,
        segmentation.h:36-45 + segmentation.cc:21-26) and survive into the
        output labels."""
        nrm, dev, num_seeds = self._planar_stage_impl(points, sensor_origin,
                                                      labels0)
        hw = points.shape[0] * points.shape[1]
        seed_vec = jnp.arange(hw - 1, -1, -1, dtype=jnp.int32)
        with jax.named_scope("cluster"):
            cres = cluster.segment_clusters(
                points, dev.labels, seed_vec, self.config.cluster,
                initial_id_offset=0, canonical_seeds=True,
                need_sizes=need_sizes)
        # cluster ids follow the planar ids
        final = jnp.where(
            (cres.labels >= 0) & (dev.labels == UNLABELED),
            cres.labels + dev.num_regions, cres.labels)
        return final, nrm, dev, cres

    def device_forward(self, points, sensor_origin, input_mask=None):
        return self._forward(points, sensor_origin, input_mask)

    def device_forward_batched(self, points_batch, sensor_origins):
        """Streaming batch (BASELINE config 4): vmap the full device
        forward over a [B, H, W, 3] stack of frames — one compiled program,
        amortized dispatch, batched region tables."""
        if not hasattr(self, "_forward_batched"):
            self._forward_batched = jax.jit(
                jax.vmap(self._forward_impl, in_axes=(0, 0)))
        return self._forward_batched(points_batch, sensor_origins)

    def _stream_impl(self, depth_u16, rays, sensor_origin, depth_scale):
        """One frame of the production streaming path: u16 range image in,
        compact labels out (see ops/unproject.py for the payload design)."""
        from pcseg_tpu.ops import unproject
        with jax.named_scope("unproject"):
            points = unproject.unproject_range(depth_u16, rays, depth_scale)
        # need_sizes=False: the wire format reports region counts only, so
        # the serving path skips the per-region size table (a 307k-segment
        # scatter + top_k)
        final, nrm, dev, cres = self._forward_impl(points, sensor_origin,
                                                   need_sizes=False)
        # uint8 label wire format: 255 = unlabeled/invalid; planar region
        # ids then cluster ids are dense and bounded by
        # planar.max_regions + cluster.max_regions <= 254.
        labels_u8 = jnp.where(final >= 0, final, 255).astype(jnp.uint8)
        return labels_u8, dev.num_regions, cres.num_regions, dev.planes

    def device_forward_stream(self, depth_batch_u16, rays, sensor_origin,
                              depth_scale):
        """Serving path: [B, H, W] u16 range frames -> ([B, H, W] uint8
        labels, per-frame region counts, [B, K, 4] planes). One compiled
        program per batch; 2 bytes/px in, 1 byte/px out — sized for
        host<->device links."""
        if not hasattr(self, "_forward_stream"):
            self._forward_stream = jax.jit(
                jax.vmap(self._stream_impl, in_axes=(0, None, None, None)),
                static_argnums=(3,))
        return self._forward_stream(depth_batch_u16, rays, sensor_origin,
                                    depth_scale)

    # -- full pipeline ------------------------------------------------------

    def segment_frame(self, points, sensor_origin,
                      rot_robot: Optional[np.ndarray] = None,
                      prev_regions: Optional[List] = None,
                      pose_cur_prev=None,
                      input_mask: Optional[np.ndarray] = None) -> FrameResult:
        """Full pipeline on one frame.

        Args:
          points/sensor_origin: the organized cloud.
          rot_robot: optional 3x3 robot-frame rotation for discontinuity z
            checks.
          prev_regions: optional list of PlanarRegionRecord from the
            previous frame — enables temporal seed transfer
            (FindSeedPointsFromLastPlanarRegions, planar_region.h:478-519).
            Requires planar.max_distance_for_seed_point > 0 (the reference
            has no default; max_normal_difference_angle_for_seed_point is
            in radians, matching the reference's cosf).
          pose_cur_prev: geom.Pose mapping previous-frame coordinates into
            the current frame (identity if None).
          input_mask: optional [H, W] int32 initial label grid carrying
            MASKED_EGO / MASKED_OUT sentinels (segmentation.h:36-45);
            masked cells are never claimed and survive into the output.
        """
        from pcseg_tpu.models import planar as planar_model
        from pcseg_tpu.ops import geom
        cfg = self.config
        points_j = jnp.asarray(points)
        if input_mask is not None:
            labels0 = jnp.asarray(input_mask, jnp.int32)
        else:
            labels0 = jnp.full(points_j.shape[:2], UNLABELED, jnp.int32)
        rot_np = np.eye(3, dtype=np.float32) if rot_robot is None \
            else np.asarray(rot_robot, np.float32)
        rot_j = jnp.asarray(rot_np)
        # Euclidean clustering rides in the SAME program as the planar stage
        # (optimistic: valid whenever the host finalize accepts every
        # device-accepted region) — saving a second dispatch + label round
        # trip over the host link.
        dev_cluster = (cfg.run_clustering
                       and cfg.cluster.cluster_method
                       != ClusterMethod.MEAN_SHIFT)
        if prev_regions is not None and len(prev_regions) > 0:
            cap = cfg.planar.max_regions
            cents = np.zeros((cap, 3), np.float32)
            norms = np.zeros((cap, 3), np.float32)
            counts = np.zeros((cap,), np.int32)
            valid = np.zeros((cap,), bool)
            for i, rec in enumerate(prev_regions[:cap]):
                cents[i] = np.asarray(rec.centroid, np.float32)
                norms[i] = np.asarray(rec.plane[:3], np.float32)
                counts[i] = int(rec.count)
                valid[i] = True
            pose = pose_cur_prev if pose_cur_prev is not None \
                else geom.Pose.identity()
            targs = (points_j, jnp.asarray(sensor_origin), labels0, rot_j,
                     jnp.asarray(cents), jnp.asarray(norms),
                     jnp.asarray(counts), jnp.asarray(valid), pose.quat,
                     pose.trans)
            payload = (self._full_stage_temporal(*targs) if dev_cluster
                       else self._planar_stage_temporal(*targs))
        elif dev_cluster:
            payload = self._full_stage(
                points_j, jnp.asarray(sensor_origin), labels0, rot_j)
        else:
            payload = self._planar_stage(
                points_j, jnp.asarray(sensor_origin), labels0, rot_j)
        points_np = np.asarray(points, np.float32)
        # re-dispatch labels travel as int8 (ids < 128, sentinels >= -5)
        return self._host_finalize(
            points_np, payload, dev_cluster, rot_robot,
            lambda labels: self._cluster_stage(
                points_j, jnp.asarray(labels.astype(np.int8))))

    def segment_frame_stream(self, depth_u16, rays, sensor_origin,
                             depth_scale: float = None,
                             rot_robot: Optional[np.ndarray] = None
                             ) -> FrameResult:
        """Full pipeline from the production u16 ingest payload.

        Same result contract as :func:`segment_frame`, but the device
        program unprojects the [H, W] u16 range frame against ``rays``
        on device (2 bytes/px over the host link instead of 12 — see
        ops/unproject.py) and the host reconstructs the identical f32
        point grid locally (unproject_range_np: the same IEEE multiply
        chain), so the float cloud never crosses the wire in either
        direction. Temporal seeding / input masks are not plumbed through
        this variant — use segment_frame for those.
        """
        from pcseg_tpu.ops import unproject
        cfg = self.config
        if depth_scale is None:
            depth_scale = unproject.DEFAULT_DEPTH_SCALE
        rot_np = np.eye(3, dtype=np.float32) if rot_robot is None \
            else np.asarray(rot_robot, np.float32)
        dev_cluster = (cfg.run_clustering
                       and cfg.cluster.cluster_method
                       != ClusterMethod.MEAN_SHIFT)
        if not hasattr(self, "_stream_payload"):
            def impl(d, rays_j, origin, rot_j, scale):
                p = unproject.unproject_range(d, rays_j, scale)
                labels0 = jnp.full(p.shape[:2], UNLABELED, jnp.int32)
                if dev_cluster:
                    return self._full_payload_impl(p, origin, labels0,
                                                   rot_j)
                return self._planar_payload_impl(p, origin, labels0, rot_j)

            self._stream_payload = jax.jit(impl, static_argnums=(4,))

            def cimpl(d, rays_j, labels_i8, scale):
                p = unproject.unproject_range(d, rays_j, scale)
                return self._cluster_payload_impl(
                    p, labels_i8.astype(jnp.int32))

            self._stream_cluster = jax.jit(cimpl, static_argnums=(3,))

        d_j = jnp.asarray(depth_u16)
        # the ray table is per-camera-intrinsics constant: keep it resident
        # on device instead of re-uploading [H, W, 3] f32 per frame (which
        # would cost the u16 variant more than it saves)
        cache = getattr(self, "_rays_device", None)
        if cache is None or cache[0] is not rays:
            cache = (rays, jnp.asarray(rays))
            self._rays_device = cache
        rays_j = cache[1]
        payload = self._stream_payload(
            d_j, rays_j, jnp.asarray(sensor_origin), jnp.asarray(rot_np),
            float(depth_scale))
        rays_np = rays if isinstance(rays, np.ndarray) \
            else np.asarray(rays, np.float32)
        points_np = unproject.unproject_range_np(
            np.asarray(depth_u16), rays_np, float(depth_scale))
        # re-dispatch labels travel as int8 (region ids < 128 by the
        # static max_regions bounds; sentinels >= -5)
        return self._host_finalize(
            points_np, payload, dev_cluster, rot_robot,
            lambda labels: self._stream_cluster(
                d_j, rays_j, jnp.asarray(labels.astype(np.int8)),
                float(depth_scale)))

    def _host_finalize(self, points_np, payload, dev_cluster, rot_robot,
                       cluster_redispatch):
        from pcseg_tpu.models import planar as planar_model
        cfg = self.config
        # ONE D2H of the compact payload (int8 label grids + per-region
        # tables + the discontinuity bit grid — see _compact_payload):
        # device_get issues every copy async before blocking, so the
        # transfers overlap instead of paying one round trip per
        # np.asarray/int() conversion.
        payload = jax.device_get(payload)
        num_seeds = payload["num_seeds"]
        dev = planar_model.PlanarRegions(
            labels=payload["dev_labels"].astype(np.int32),
            num_regions=payload["num_regions"],
            planes=payload["planes"], centroids=payload["centroids"],
            curvatures=payload["curvatures"], counts=payload["counts"],
            seed_indices=payload["seed_indices"], moments=None,
            overflow=payload["overflow"])
        cres = None
        if dev_cluster:
            cres = dict(labels=payload["cres_labels"].astype(np.int32),
                        num=int(payload["cres_num"]),
                        sizes=payload["cres_sizes"])

        labels, records = boundary.finalize_planar_regions(
            points_np, None, dev, cfg.planar, 0, rot_robot,
            disc_flags=payload["disc"])
        summary = classify.ClassificationDebugSummary()
        classify.classify_regions(records, cfg.classification,
                                  cfg.up_direction, cfg.known_floor_point,
                                  summary)

        num_planar = len(records)
        num_clusters = 0
        cluster_sizes = np.zeros((0,), np.int32)
        objects: List[extract.DetectedObject] = []
        labels_final = labels

        if cfg.run_clustering:
            if cfg.cluster.cluster_method == ClusterMethod.MEAN_SHIFT:
                # SlidingMeanShift path (mean_shift_segmentation.h:207-330):
                # labels mutated in place, region ids follow the planar ids.
                # The native runtime runs modes + growth in one call with
                # no device dispatch (exact vs the FIFO port; tested);
                # fall back to the device fixed point without it.
                from pcseg_tpu import native as _native
                from pcseg_tpu.models import mean_shift
                labels_final = labels.copy()
                growth = "native" if _native.load_hostops() is not None \
                    else "device"
                ms_regions = mean_shift.sliding_mean_shift(
                    points_np, labels_final, cfg.cluster,
                    cfg.mean_shift_iterations, num_planar, cfg.mean_shift,
                    growth=growth)
                num_clusters = len(ms_regions)
                cluster_sizes = np.asarray(
                    [len(r.inlier_indices) for r in ms_regions], np.int32)
            else:
                if cres is None or num_planar != int(dev.num_regions):
                    # host finalize rejected a device-accepted region (its
                    # cells reverted to UNLABELED and are clusterable, the
                    # reference's quarantine-then-reset) — rerun clustering
                    # on the corrected label grid
                    c2 = jax.device_get(cluster_redispatch(labels))
                    cres = dict(labels=c2["cres_labels"].astype(np.int32),
                                num=int(c2["cres_num"]),
                                sizes=c2["cres_sizes"])
                cl = cres["labels"]
                # shift cluster ids above the planar ids
                mask = (cl >= 0) & (labels == UNLABELED)
                labels_final = labels.copy()
                labels_final[mask] = cl[mask] + num_planar
                num_clusters = cres["num"]
                cluster_sizes = np.asarray(cres["sizes"])[:num_clusters]

        indexer = extract.RegionIndexer(labels_final) \
            if (records or num_clusters) else None
        for rec in records:
            objects.append(extract.planar_detected_object_from_labels(
                points_np, labels_final, rec, indexer=indexer))
        for cid in range(num_clusters):
            objects.append(extract.cluster_detected_object(
                points_np, labels_final, num_planar + cid,
                SEMANTIC_UNKNOWN, indexer=indexer))

        metrics = FrameMetrics(
            num_seeds=int(num_seeds),
            num_device_planar_regions=int(dev.num_regions),
            num_planar_regions=num_planar,
            num_clusters=num_clusters,
            planar_overflow=bool(dev.overflow),
        )
        return FrameResult(labels=labels_final, normals=None,
                           planar_regions=records,
                           num_clusters=num_clusters,
                           cluster_sizes=cluster_sizes,
                           objects=objects, metrics=metrics,
                           classification_summary=summary)
