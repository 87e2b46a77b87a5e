"""Seed finders: device dense ops vs the sequential oracle."""

import numpy as np
import jax
import jax.numpy as jnp

from pcseg_tpu.models.config import (
    SeedsFromAverageNormalsParams, SeedsFromPlaneSupportParams)
from pcseg_tpu.ops import seeds as seeds_op
from pcseg_tpu import oracle
from tests import fixtures


def _room(n=40):
    pts, origin = fixtures.synthetic_room_cloud(n, n, f=float(n), seed=2)
    normals = oracle.compute_normals_organized(pts, origin)
    return pts, normals


class TestPlaneSupportSeeds:
    def test_golden_counts(self):
        """segmentation_test.cc:28-53 fixture counts."""
        points, normals = fixtures.flat_grid_fixture(5)
        r = seeds_op.seeds_from_plane_support(
            jnp.asarray(points), jnp.asarray(normals),
            SeedsFromPlaneSupportParams(neighborhood_size=3,
                                        max_plane_distance=0.05,
                                        min_num_support_points=6))
        assert int(r.valid.sum()) == 25 - 4
        r = seeds_op.seeds_from_plane_support(
            jnp.asarray(points), jnp.asarray(normals),
            SeedsFromPlaneSupportParams(neighborhood_size=5,
                                        max_plane_distance=0.05,
                                        min_num_support_points=16))
        assert int(r.valid.sum()) == 9

    def test_exact_order_vs_oracle(self):
        pts, normals = _room(40)
        params = SeedsFromPlaneSupportParams()
        r = jax.jit(lambda p, n: seeds_op.seeds_from_plane_support(
            p, n, params))(jnp.asarray(pts), jnp.asarray(normals))
        got = np.asarray(r.indices)[np.asarray(r.valid)]
        want = oracle.find_seed_points_from_plane_support(
            pts, normals, params.neighborhood_size,
            params.max_plane_distance, params.min_num_support_points)
        np.testing.assert_array_equal(got, np.asarray(want, np.int32))

    def test_small_grid_returns_empty(self):
        pts = np.zeros((4, 4, 3), np.float32)
        r = seeds_op.seeds_from_plane_support(
            jnp.asarray(pts), jnp.asarray(pts))
        assert int(r.valid.sum()) == 0


class TestAverageNormalSeeds:
    def test_exact_vs_oracle_flat(self):
        pts, normals = fixtures.flat_grid_fixture(9)
        m = seeds_op.seeds_from_average_normals(jnp.asarray(normals))
        got_list, got_valid = seeds_op.average_normal_seed_list(m, 256)
        got = np.asarray(got_list)[np.asarray(got_valid)]
        want = oracle.find_seed_points_from_average_normals(pts, normals)
        np.testing.assert_array_equal(got, np.asarray(want, np.int32))

    def test_exact_vs_oracle_room(self):
        pts, normals = _room(40)
        params = SeedsFromAverageNormalsParams()
        m = jax.jit(lambda n: seeds_op.seeds_from_average_normals(
            n, params))(jnp.asarray(normals))
        got_list, got_valid = seeds_op.average_normal_seed_list(m, 4096)
        got = np.asarray(got_list)[np.asarray(got_valid)]
        want = oracle.find_seed_points_from_average_normals(
            pts, normals, params.neighborhood_size,
            params.min_num_valid_normals, params.min_avg_normal_length)
        np.testing.assert_array_equal(got, np.asarray(want, np.int32))

    def test_nan_poisoning_replicated(self):
        """A window whose first row has no valid normals is rejected even if
        the total count passes (segmentation.h:112-116 0/0 semantics)."""
        pts, normals = fixtures.flat_grid_fixture(9)
        normals = normals.copy()
        # knock out a full transposed-window first-row stripe
        normals[3, :] = np.nan
        m = seeds_op.seeds_from_average_normals(jnp.asarray(normals))
        got_list, got_valid = seeds_op.average_normal_seed_list(m, 256)
        got = np.asarray(got_list)[np.asarray(got_valid)]
        want = oracle.find_seed_points_from_average_normals(pts, normals)
        np.testing.assert_array_equal(got, np.asarray(want, np.int32))


def test_rank_grid_closed_form_matches_scatter():
    """plane_support_rank_grid's scatter-free closed form must equal the
    original scatter formulation on every layout: natural, square
    transposed, wide/tall transposed (incl. the clip-into-last-cell case
    of tall grids)."""
    import jax
    import jax.numpy as jnp
    from pcseg_tpu.ops import seeds as seeds_op

    def scatter_impl(count, qualifies, h, w, cmax):
        rows = jax.lax.broadcasted_iota(jnp.int32, count.shape, 0)
        cols = jax.lax.broadcasted_iota(jnp.int32, count.shape, 1)
        lin_idx = cols * h + rows
        hw = h * w
        rank = (cmax - count) * hw + (hw - 1 - lin_idx)
        flat = jnp.full((hw,), seeds_op.SEED_RANK_INF, jnp.int32)
        flat = flat.at[jnp.clip(lin_idx, 0, hw - 1).reshape(-1)].min(
            jnp.where(qualifies, rank,
                      seeds_op.SEED_RANK_INF).reshape(-1))
        return jnp.swapaxes(flat.reshape(w, h), 0, 1)

    rng = np.random.default_rng(0)
    for (h, w, transposed) in [(24, 24, True), (20, 28, False),
                               (20, 28, True), (28, 20, True),
                               (7, 30, True), (30, 7, True)]:
        shape = (w, h) if transposed else (h, w)
        count = rng.integers(0, 82, shape).astype(np.int32)
        qual = rng.random(shape) < 0.5
        a = np.asarray(scatter_impl(jnp.asarray(count), jnp.asarray(qual),
                                    h, w, 83))
        b = np.asarray(seeds_op.plane_support_rank_grid(
            jnp.asarray(count), jnp.asarray(qual), h, w, 83))
        np.testing.assert_array_equal(a, b, err_msg=str((h, w, transposed)))

