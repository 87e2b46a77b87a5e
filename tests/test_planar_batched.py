"""Batched planar growth vs the sequential device path and the oracle."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pcseg_tpu.models.config import (
    UNLABELED, PlanarRegionConfig, SeedsFromPlaneSupportParams)
from pcseg_tpu.models import planar_batched, boundary
from pcseg_tpu.ops import seeds as seeds_op
from pcseg_tpu import oracle
from tests import fixtures
from tests.test_planar import run_oracle


def run_batched(points, normals, config=PlanarRegionConfig(), offset=0):
    ranked = seeds_op.seeds_from_plane_support(
        jnp.asarray(points), jnp.asarray(normals))
    labels0 = jnp.full(points.shape[:2], UNLABELED, jnp.int32)
    fn = jax.jit(lambda p, n, l, si, sv:
                 planar_batched.grow_planar_regions_batched(
                     p, n, l, si, sv, config, offset))
    dev = fn(jnp.asarray(points), jnp.asarray(normals), labels0,
             ranked.indices, ranked.valid)
    labels, records = boundary.finalize_planar_regions(
        np.asarray(points, np.float32), np.asarray(normals), dev, config,
        offset)
    return labels, records, dev


def _scene(n=40, seed=2):
    pts, origin = fixtures.synthetic_room_cloud(n, n, f=float(n), seed=seed)
    normals = oracle.compute_normals_organized(pts, origin)
    return pts, normals


class TestBatchedGrowth:
    def test_room_scene_vs_oracle(self):
        pts, normals = _scene(40)
        got_labels, records, dev = run_batched(pts, normals)
        want_labels, want_regions = run_oracle(pts, normals)
        agreement = (got_labels == want_labels).mean()
        assert agreement >= 0.99, agreement
        assert len(records) == len(want_regions)
        for rec, want in zip(records, want_regions):
            dot = abs(float(rec.plane[:3] @ want.plane[:3]))
            assert dot > 0.999

    def test_multi_plane_discovery_across_epochs(self):
        """Walls hidden behind the dominant floor's seed crowd must be
        found via founder reassignment."""
        pts, normals = _scene(48, seed=5)
        cfg = dataclasses.replace(PlanarRegionConfig(), max_regions=8)
        got_labels, records, dev = run_batched(pts, normals, cfg)
        want_labels, want_regions = run_oracle(pts, normals)
        assert len(records) == len(want_regions)
        agreement = (got_labels == want_labels).mean()
        assert agreement >= 0.99, agreement
        for rec, want in zip(records, want_regions):
            assert rec.count == len(want.inlier_indices)
            assert abs(float(rec.plane[:3] @ want.plane[:3])) > 0.999

    def test_bordered_plane(self):
        pts = np.full((24, 24, 3), np.nan, np.float32)
        pts[2:22, 2:22] = fixtures.analytic_plane_cloud(
            20, 20, normal=(0, 0, 1), d=1.0, step=0.1)
        normals = oracle.compute_normals_organized(
            pts, np.array([0, 0, 5.0], np.float32))
        got_labels, records, dev = run_batched(pts, normals)
        want_labels, want_regions = run_oracle(pts, normals)
        assert len(records) == len(want_regions) == 1
        agreement = (got_labels == want_labels).mean()
        assert agreement >= 0.99, agreement

    def test_empty_seeds(self):
        pts, normals = _scene(24)
        labels0 = jnp.full(pts.shape[:2], UNLABELED, jnp.int32)
        dev = planar_batched.grow_planar_regions_batched(
            jnp.asarray(pts), jnp.asarray(normals), labels0,
            jnp.zeros((4,), jnp.int32), jnp.zeros((4,), bool))
        assert int(dev.num_regions) == 0


def _bfs_reach(gate, sources):
    """NumPy reference: cells of each [H, W] gate slice 4-connected to a
    source cell of that slice (plain breadth-first search)."""
    from collections import deque
    reach = np.zeros_like(gate)
    k, h, w = gate.shape
    for s in range(k):
        todo = deque(zip(*np.nonzero(sources[s] & gate[s])))
        for r, c in todo:
            reach[s, r, c] = True
        while todo:
            r, c = todo.popleft()
            for rr, cc in ((r + 1, c), (r - 1, c), (r, c + 1), (r, c - 1)):
                if (0 <= rr < h and 0 <= cc < w and gate[s, rr, cc]
                        and not reach[s, rr, cc]):
                    reach[s, rr, cc] = True
                    todo.append((rr, cc))
    return reach


class TestFloodFill:
    @pytest.mark.parametrize("max_run", [None, 9])
    def test_matches_numpy_bfs(self, max_run):
        """The packed segmented-scan flood must reach exactly the cells a
        BFS reaches, over more slots than one 32-bit word holds; with
        ``max_run`` the gate's runs are capped at 9 by construction."""
        rng = np.random.default_rng(5 if max_run is None else 8)
        k, h, w = 40, 48, 64
        gate = rng.random((k, h, w)) < 0.55
        if max_run is not None:
            gate[:, ::max_run, :] = False
            gate[:, :, ::max_run] = False
        src = rng.random((k, h, w)) < 0.02
        got = planar_batched.flood_fill_static(
            jnp.asarray(gate), jnp.asarray(src), h * w, max_run=max_run)
        np.testing.assert_array_equal(np.asarray(got), _bfs_reach(gate, src))


class TestVmappedGrower:
    def test_vmapped_matches_per_frame(self):
        """The grower over a leading frame axis (the stream path's shape,
        at a size where the patched stage A is active) must give every
        frame the per-frame grower's regions."""
        scenes = [_scene(128, seed=s) for s in (3, 7)]

        def one(p, n):
            ranked = seeds_op.seeds_from_plane_support(p, n)
            labels0 = jnp.full(p.shape[:2], UNLABELED, jnp.int32)
            dev = planar_batched.grow_planar_regions_batched(
                p, n, labels0, ranked.indices, ranked.valid,
                PlanarRegionConfig(), 0, seed_rank_grid=ranked.rank_grid)
            return dev.labels, dev.num_regions, dev.planes

        pts_b = jnp.asarray(np.stack([s[0] for s in scenes]))
        nrm_b = jnp.asarray(np.stack([s[1] for s in scenes]))
        got_labels, got_n, got_planes = jax.jit(jax.vmap(one))(pts_b, nrm_b)
        single = jax.jit(one)
        for b in range(len(scenes)):
            labels, n, planes = single(pts_b[b], nrm_b[b])
            assert int(got_n[b]) == int(n) > 0
            np.testing.assert_array_equal(np.asarray(got_labels[b]),
                                          np.asarray(labels))
            np.testing.assert_allclose(np.asarray(got_planes[b, :int(n)]),
                                       np.asarray(planes[:int(n)]),
                                       rtol=0, atol=1e-4)
