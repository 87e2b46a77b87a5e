"""Validate the NumPy oracle against goldens ported from the C++ tests.

These tests pin the oracle itself to the reference's behavior; the device path
is then validated against the oracle on larger random clouds.
"""

import numpy as np
import pytest

from pcseg_tpu import oracle
from pcseg_tpu.models.config import (
    UNLABELED, ClusterRegionConfig, PlanarRegionConfig)
from tests import fixtures


class TestClusteringGolden:
    """clustering_test.cc:115-152 — the exact end-to-end fixture."""

    def test_exact_label_grid_and_sizes(self):
        points = fixtures.clustering_fixture_cloud()
        seeds = fixtures.clustering_fixture_seeds()
        labels = np.full((10, 10), UNLABELED, np.int32)
        region = oracle.ClusterRegionOracle(ClusterRegionConfig())
        regions = oracle.segment_regions(
            region, {"points": points}, seeds, labels,
            initial_id_offset=1)

        np.testing.assert_array_equal(
            labels, fixtures.CLUSTERING_EXPECTED_LABELS)
        assert [len(r.inlier_indices) for r in regions] == \
            fixtures.CLUSTERING_EXPECTED_SIZES


class TestSeedsGolden:
    """segmentation_test.cc:28-53."""

    def test_plane_support_seed_counts(self):
        points, normals = fixtures.flat_grid_fixture(5)
        seeds = oracle.find_seed_points_from_plane_support(
            points, normals, 3, 0.05, 6)
        assert len(seeds) == 5 * 5 - 4

        seeds = oracle.find_seed_points_from_plane_support(
            points, normals, 5, 0.05, 16)
        assert len(seeds) == (5 - 2) * (5 - 2)


class TestPlaneEstimatorOracle:
    """plane_estimator_test.cc behaviors."""

    def test_analytic_plane_recovery(self):
        pts = fixtures.analytic_plane_cloud(60, 60, normal=(1.0, 2.0, 3.0),
                                            d=-2.0)
        est = oracle.PlaneEstimatorOracle()
        est.set_normal_orientation(np.array([1.0, 2.0, 3.0], np.float32))
        for p in pts.reshape(-1, 3):
            est.add_point(p)
        assert est.plane_valid()
        n_expect = np.array([1.0, 2.0, 3.0]) / np.sqrt(14.0)
        assert np.allclose(est.get_plane()[:3], n_expect, atol=1e-4)
        assert abs(est.get_plane()[3] - (-2.0)) < 1e-3

    def test_degenerate_single_point(self):
        est = oracle.PlaneEstimatorOracle()
        est.add_point(np.array([1.0, 2.0, 3.0]))
        assert not est.plane_valid()
        assert np.allclose(est.get_centroid(), [1.0, 2.0, 3.0])
        assert np.all(np.isfinite(est.get_plane()))

    def test_corner_cases_line_then_plane(self):
        """plane_estimator_test.cc:76-144 — repeated point and a collinear
        set (dyadic-exact values) stay invalid; a 4th point makes a plane."""
        est = oracle.PlaneEstimatorOracle()
        est.set_normal_orientation(np.array([0.1, 0.1, 0.98], np.float32))
        for _ in range(3):
            est.add_point(np.array([1.0, 2.0, 3.0]))
        assert not est.plane_valid()
        assert np.allclose(est.get_plane()[:3], [0.1, 0.1, 0.98], atol=1e-5)
        est.add_point(np.array([0.0, 2.0, 3.0]))  # line along x
        assert not est.plane_valid()
        assert np.allclose(est.get_centroid(), [0.75, 2.0, 3.0], atol=1e-5)
        est.add_point(np.array([0.0, 0.0, 3.0]))  # now a plane z=3
        assert est.plane_valid()
        assert np.allclose(est.get_plane()[:3], [0.0, 0.0, 1.0], atol=1e-5)
        assert abs(est.get_plane()[3] - (-3.0)) < 1e-5
        # Flip via orientation hint on a valid plane
        est.set_normal_orientation(np.array([0.1, 0.1, -0.98], np.float32))
        assert np.allclose(est.get_plane()[:3], [0.0, 0.0, -1.0], atol=1e-5)
        assert abs(est.get_plane()[3] - 3.0) < 1e-5

    def test_merge_equals_joint(self):
        pts = fixtures.analytic_plane_cloud(30, 30, normal=(0, 0, 1), d=-1.0,
                                            noise=0.01, seed=3)
        flat = pts.reshape(-1, 3)
        e1, e2, joint = (oracle.PlaneEstimatorOracle() for _ in range(3))
        for p in flat[:400]:
            e1.add_point(p)
            joint.add_point(p)
        for p in flat[400:]:
            e2.add_point(p)
            joint.add_point(p)
        e1.merge(e2)
        assert np.allclose(e1.get_plane(), joint.get_plane(), atol=1e-4)


class TestNormalsOracle:
    def test_flat_grid_normals_point_up(self):
        pts = fixtures.analytic_plane_cloud(20, 20, normal=(0, 0, 1), d=1.0,
                                            step=0.15)
        # sensor above the plane (z=...) so normals orient to +z
        normals = oracle.compute_normals_organized(
            pts, np.array([0.0, 0.0, 5.0], np.float32))
        valid = np.all(np.isfinite(normals), axis=-1)
        assert valid.mean() > 0.8
        assert np.allclose(normals[valid], [0, 0, 1], atol=1e-3)

    def test_nan_center_invalid(self):
        pts = fixtures.analytic_plane_cloud(10, 10, step=0.15)
        pts[5, 5] = np.nan
        normals = oracle.compute_normals_organized(
            pts, np.array([0.0, 0.0, 5.0], np.float32))
        assert not np.any(np.isfinite(normals[5, 5]))
