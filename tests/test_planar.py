"""Planar region growing: device wavefront + host finalize vs oracle."""

import numpy as np
import jax
import jax.numpy as jnp

from pcseg_tpu.models.config import (
    UNLABELED, PlanarRegionConfig, SeedsFromPlaneSupportParams)
from pcseg_tpu.models import planar, boundary
from pcseg_tpu.ops import seeds as seeds_op
from pcseg_tpu import oracle
from tests import fixtures


def _scene(n=40, seed=2):
    pts, origin = fixtures.synthetic_room_cloud(n, n, f=float(n), seed=seed)
    normals = oracle.compute_normals_organized(pts, origin)
    return pts, normals


def run_device(points, normals, config=None, offset=0,
            seed_params=SeedsFromPlaneSupportParams()):
    import dataclasses
    if config is None:
        config = PlanarRegionConfig()
    if config.growth_mode == "batched":
        # this suite pins the sequential hybrid path; the batched path has
        # its own suite (test_planar_batched.py)
        config = dataclasses.replace(config, growth_mode="hybrid")
    ranked = seeds_op.seeds_from_plane_support(
        jnp.asarray(points), jnp.asarray(normals), seed_params)
    labels0 = jnp.full(points.shape[:2], UNLABELED, jnp.int32)
    fn = jax.jit(lambda p, n, l, si, sv: planar.grow_planar_regions(
        p, n, l, si, sv, config, offset))
    dev = fn(jnp.asarray(points), jnp.asarray(normals), labels0,
             ranked.indices, ranked.valid)
    labels, records = boundary.finalize_planar_regions(
        points, normals, dev, config, offset)
    return labels, records, dev


def run_oracle(points, normals, config=PlanarRegionConfig(), offset=0,
               seed_params=SeedsFromPlaneSupportParams()):
    seeds = oracle.find_seed_points_from_plane_support(
        points, normals, seed_params.neighborhood_size,
        seed_params.max_plane_distance, seed_params.min_num_support_points)
    labels = oracle.prepare_unlabeled_labels(points)
    region = oracle.PlanarRegionOracle(config)
    regions = oracle.segment_regions(
        region, {"points": points, "normals": normals}, seeds, labels,
        offset)
    return labels, regions


class TestPlanarParity:
    def test_room_scene(self):
        pts, normals = _scene(40)
        got_labels, records, dev = run_device(pts, normals)
        want_labels, want_regions = run_oracle(pts, normals)

        agreement = (got_labels == want_labels).mean()
        assert agreement >= 0.99, agreement
        assert len(records) == len(want_regions)
        # planes should match the oracle's per-region estimates
        for rec, want in zip(records, want_regions):
            dot = abs(float(rec.plane[:3] @ want.plane[:3]))
            assert dot > 0.999, (rec.plane, want.plane)
            assert abs(rec.area - want.area) / max(want.area, 1e-6) < 0.05

    def test_full_grid_region_rejected_like_reference(self):
        """A plane covering the whole grid has no in-bounds boundary
        predecessor, so the reference rejects it (planar_region.h:316-318);
        both paths must agree."""
        pts = fixtures.analytic_plane_cloud(20, 20, normal=(0, 0, 1), d=1.0,
                                            step=0.1)
        normals = oracle.compute_normals_organized(
            pts, np.array([0, 0, 5.0], np.float32))
        got_labels, records, dev = run_device(pts, normals)
        want_labels, want_regions = run_oracle(pts, normals)
        assert int(dev.num_regions) == 1  # grown, then host-rejected
        assert len(records) == len(want_regions) == 0
        assert (got_labels == want_labels).all()

    def test_bordered_plane_single_region(self):
        pts = np.full((24, 24, 3), np.nan, np.float32)
        pts[2:22, 2:22] = fixtures.analytic_plane_cloud(
            20, 20, normal=(0, 0, 1), d=1.0, step=0.1)
        normals = oracle.compute_normals_organized(
            pts, np.array([0, 0, 5.0], np.float32))
        got_labels, records, dev = run_device(pts, normals)
        want_labels, want_regions = run_oracle(pts, normals)
        assert len(records) == len(want_regions) == 1
        agreement = (got_labels == want_labels).mean()
        assert agreement >= 0.99, agreement

    def test_empty_seed_list(self):
        pts, normals = _scene(40)
        labels0 = jnp.full(pts.shape[:2], UNLABELED, jnp.int32)
        dev = planar.grow_planar_regions(
            jnp.asarray(pts), jnp.asarray(normals), labels0,
            jnp.zeros((8,), jnp.int32), jnp.zeros((8,), bool))
        assert int(dev.num_regions) == 0
        assert (np.asarray(dev.labels) == UNLABELED).all()

    def test_min_area_rejection_resets_labels(self):
        """A tiny isolated plane patch must be rejected by min_region_area
        and its pixels returned to UNLABELED."""
        rng = np.random.default_rng(4)
        pts = rng.uniform(-20, 20, (24, 24, 3)).astype(np.float32)
        # small flat patch 6x6 at z=1, but tiny extent (area < 0.05 m^2)
        patch = fixtures.analytic_plane_cloud(6, 6, normal=(0, 0, 1), d=-1.0,
                                              step=0.02)
        pts[4:10, 4:10] = patch
        normals = oracle.compute_normals_organized(
            pts, np.array([0, 0, 5.0], np.float32))
        got_labels, records, dev = run_device(pts, normals)
        want_labels, want_regions = run_oracle(pts, normals)
        assert len(records) == len(want_regions)
        agreement = (got_labels == want_labels).mean()
        assert agreement >= 0.99, agreement


class TestMooreTrace:
    def test_trace_matches_oracle(self):
        mask = np.zeros((12, 12), bool)
        mask[2:9, 3:10] = True
        mask[4, 5] = False  # a hole (outer trace unaffected)
        mask[5:6, 10:12] = True  # protrusion to the edge
        labels = np.where(mask, 7, UNLABELED).astype(np.int32)

        start = boundary.find_outer_start(mask)
        got = boundary.moore_trace(mask, start)

        # oracle trace from the same start for a like-for-like comparison
        cfg = PlanarRegionConfig()
        reg = oracle.PlanarRegionOracle(cfg)
        pts = np.zeros((12, 12, 3), np.float32)
        nrm = np.zeros((12, 12, 3), np.float32)
        ok = reg.find_labeled_region_boundary(
            start, {"points": pts, "normals": nrm}, labels, use8=True)
        assert ok
        assert got == reg.boundary_indices

    def test_full_grid_region_rejected(self):
        mask = np.ones((8, 8), bool)
        assert boundary.find_outer_start(mask) is None
