"""Mean-shift clustering: device fixed point + host growth vs oracle."""

import numpy as np
import jax.numpy as jnp

from pcseg_tpu.models.config import (
    UNLABELED, ClusterRegionConfig, MeanShiftParams)
from pcseg_tpu.models import mean_shift
from pcseg_tpu import oracle


def blob_cloud(h=24, w=24, seed=3):
    """Two dense blobs + scattered far outliers."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-30, 30, (h, w, 3)).astype(np.float32)
    pts[2:14, 2:14] = np.array([0, 0, 0]) \
        + rng.normal(0, 0.15, (12, 12, 3)).astype(np.float32)
    pts[10:22, 12:24] = np.array([5, 5, 0]) \
        + rng.normal(0, 0.15, (12, 12, 3)).astype(np.float32)
    pts[rng.random((h, w)) < 0.03] = np.nan
    return pts


class TestMeanShiftModes:
    def test_shift_matches_oracle(self):
        pts = blob_cloud()
        h, w = pts.shape[:2]
        labels = np.full((h, w), UNLABELED, np.int32)
        iterations = 5

        state = mean_shift.mean_shift_modes(
            jnp.asarray(pts), jnp.asarray(labels), iterations)

        # oracle shift phase (reuse its internals by running the full thing
        # with zero growth — replicate just the shift loop here)
        seeds = []
        for index in range(h * w):
            if not np.any(np.isnan(oracle.at_lin(pts, index))):
                r, c = oracle.to_rc(index, h)
                seeds.append([oracle.at_lin(pts, index).astype(
                    np.float32).copy(), np.array([r, c], np.float32), index])
        params = MeanShiftParams()
        valid = {s[2]: True for s in seeds}
        for _ in range(iterations):
            for srec in seeds:
                pos, idx2, index = srec
                if not valid[index]:
                    continue
                row, col = int(round(float(idx2[0]))), \
                    int(round(float(idx2[1])))
                shifts = []
                for dc in range(-5, 6):
                    for dr in range(-5, 6):
                        r2, c2 = row + dr, col + dc
                        if not (0 <= r2 < h and 0 <= c2 < w):
                            continue
                        if np.any(np.isnan(pts[r2, c2])):
                            continue
                        dp = pts[r2, c2].astype(np.float32) - pos
                        if float(dp @ dp) > 1.0:
                            continue
                        shifts.append((dp, np.array([r2, c2], np.float32)
                                       - idx2))
                total = float(len(shifts))
                if total < params.min_support:
                    valid[index] = False
                    continue
                srec[0] = pos + np.sum([s[0] for s in shifts], 0) \
                    / np.float32(total)
                srec[1] = idx2 + np.sum([s[1] for s in shifts], 0) \
                    / np.float32(total)

        got_pos = np.asarray(state.pos)
        got_valid = np.asarray(state.valid)
        # row-major flat index of device state
        for pos, idx2, index in seeds:
            r, c = oracle.to_rc(index, h)
            flat = r * w + c
            assert got_valid[flat] == valid[index], (r, c)
            if valid[index]:
                np.testing.assert_allclose(got_pos[flat], pos, atol=1e-4)


class TestSlidingMeanShiftEndToEnd:
    def test_matches_oracle(self):
        pts = blob_cloud()
        h, w = pts.shape[:2]
        cfg = ClusterRegionConfig()

        labels_dev = np.full((h, w), UNLABELED, np.int32)
        regions_dev = mean_shift.sliding_mean_shift(
            pts, labels_dev, cfg, iterations=5, initial_region_id_offset=1)

        labels_oracle = np.full((h, w), UNLABELED, np.int32)
        regions_oracle = oracle.sliding_mean_shift(
            pts, cfg, 5, 1, labels_oracle)

        agreement = (labels_dev == labels_oracle).mean()
        assert agreement >= 0.99, agreement
        assert len(regions_dev) == len(regions_oracle)
        for a, b in zip(regions_dev, regions_oracle):
            assert a.label_id == b.label_id
            assert len(a.inlier_indices) == len(b.inlier_indices)

    def test_respects_existing_labels(self):
        pts = blob_cloud()
        h, w = pts.shape[:2]
        labels = np.full((h, w), UNLABELED, np.int32)
        labels[:6, :6] = 0  # pre-claimed by a planar region
        before = labels.copy()
        mean_shift.sliding_mean_shift(
            pts, labels, ClusterRegionConfig(), iterations=3,
            initial_region_id_offset=1)
        np.testing.assert_array_equal(labels[:6, :6], before[:6, :6])


class TestDeviceGrowth:
    def test_device_matches_host_growth(self):
        """Closure growth (production) vs the exact FIFO port on blobs."""
        pts = blob_cloud(seed=7)
        h, w = pts.shape[:2]
        cfg = ClusterRegionConfig()
        la = np.full((h, w), UNLABELED, np.int32)
        ra = mean_shift.sliding_mean_shift(pts, la, cfg, 5, 0,
                                           growth="device")
        lb = np.full((h, w), UNLABELED, np.int32)
        rb = mean_shift.sliding_mean_shift(pts, lb, cfg, 5, 0, growth="host")
        assert (la == lb).mean() >= 0.99
        assert len(ra) == len(rb)

    def test_batched_matches_permode_exactly(self):
        """The one-dispatch all-modes program must reproduce the per-mode
        dispatch path bit-exactly (same closure, same order, same
        suppression) on scenes with multiple modes and rejections."""
        for seed in (3, 7, 11):
            pts = blob_cloud(seed=seed)
            h, w = pts.shape[:2]
            cfg = ClusterRegionConfig()
            la = np.full((h, w), UNLABELED, np.int32)
            ra = mean_shift.sliding_mean_shift(pts, la, cfg, 5, 2,
                                               growth="device")
            lb = np.full((h, w), UNLABELED, np.int32)
            rb = mean_shift.sliding_mean_shift(pts, lb, cfg, 5, 2,
                                               growth="device_permode")
            np.testing.assert_array_equal(la, lb)
            assert len(ra) == len(rb)
            for a, b in zip(ra, rb):
                assert a.label_id == b.label_id
                np.testing.assert_array_equal(a.inlier_indices,
                                              b.inlier_indices)
                np.testing.assert_allclose(a.seed, b.seed, atol=0)


class TestPipelineMeanShift:
    def test_segment_frame_mean_shift(self):
        """ClusterMethod.MEAN_SHIFT end to end through Segmenter
        (region_segmentation_config.proto:23-29)."""
        import dataclasses
        from pcseg_tpu.models import pipeline
        from pcseg_tpu.models.config import ClusterMethod

        pts = blob_cloud(h=32, w=32, seed=4)
        cfg = pipeline.SegmenterConfig(
            cluster=dataclasses.replace(
                ClusterRegionConfig(),
                cluster_method=ClusterMethod.MEAN_SHIFT))
        seg = pipeline.Segmenter(cfg)
        res = seg.segment_frame(pts, np.zeros(3, np.float32))
        assert res.metrics.num_clusters >= 2
        # cluster ids follow planar ids and are dense
        ids = np.unique(res.labels[res.labels >= 0])
        assert len(ids) == res.metrics.num_planar_regions \
            + res.metrics.num_clusters

    def test_unorganized_mean_shift(self):
        from pcseg_tpu.models import unorganized
        rng = np.random.default_rng(0)
        blobs = np.concatenate([
            c + rng.normal(0, 0.3, (4000, 3)).astype(np.float32)
            for c in np.array([[0, 0, 0], [12, 0, 0], [0, 14, 0]],
                              np.float32)])
        # cell_size must keep >=50 occupied cells inside the 1 m ball of a
        # mode (the reference's support gate, mean_shift_segmentation.h:
        # 244-249, assumes dense organized grids): 0.1 m cells put ~300
        # cells in the ball of each blob.
        res = unorganized.cluster_unorganized_mean_shift(
            jnp.asarray(blobs),
            ClusterRegionConfig(min_region_inliers=7),
            cell_size=0.1, grid_shape=(192, 192))
        assert int(res.num_regions) == 3
        labeled = np.asarray(res.point_labels) >= 0
        assert labeled.mean() > 0.95


def test_native_growth_matches_host_port():
    """growth='native' (hostops modes + growth, no device dispatch) must
    reproduce the exact FIFO port on an organized blob scene with
    pre-labeled planar cells."""
    from pcseg_tpu import native
    from pcseg_tpu.models import mean_shift
    from pcseg_tpu.models.config import ClusterRegionConfig, UNLABELED

    if native.load_hostops() is None:
        import pytest
        pytest.skip("native hostops unavailable")

    rng = np.random.default_rng(2)
    h, w = 120, 140
    pts = np.full((h, w, 3), np.nan, np.float32)
    for k, (cy, cx) in enumerate([(30, 30), (30, 100), (85, 40),
                                  (90, 110)]):
        rr, cc = np.meshgrid(range(-14, 15), range(-14, 15), indexing="ij")
        m = rr ** 2 + cc ** 2 <= 14 ** 2
        ys, xs = cy + rr[m], cx + cc[m]
        pts[ys, xs] = np.stack(
            [xs * 0.05, ys * 0.05, np.full(m.sum(), k * 3.0)], -1) \
            + rng.normal(0, 0.01, (m.sum(), 3))
    labels0 = np.full((h, w), UNLABELED, np.int32)
    labels0[:8, :] = 0  # pre-labeled planar band must be honored
    cfg = ClusterRegionConfig()

    la = labels0.copy()
    ra = mean_shift.sliding_mean_shift(pts, la, cfg, 5, 2, growth="host")
    lb = labels0.copy()
    rb = mean_shift.sliding_mean_shift(pts, lb, cfg, 5, 2, growth="native")
    assert len(ra) == len(rb)
    assert (la == lb).mean() > 0.999
    for x, y in zip(ra, rb):
        assert x.label_id == y.label_id
        assert len(x.inlier_indices) == len(y.inlier_indices)
