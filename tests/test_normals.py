"""Device normals op vs the sequential oracle (per-pixel parity)."""

import numpy as np
import jax
import jax.numpy as jnp

from pcseg_tpu.models.config import ComputeNormalsParams
from pcseg_tpu.ops import normals as normals_op
from pcseg_tpu import oracle
from tests import fixtures


def _compare(points, origin, params=ComputeNormalsParams(), angle_tol_deg=0.1,
             min_agree=1.0):
    got = np.asarray(jax.jit(
        lambda p: normals_op.compute_normals_organized(
            p, jnp.asarray(origin), params))(jnp.asarray(points)))
    want = oracle.compute_normals_organized(points, origin, params)
    valid_got = np.all(np.isfinite(got), axis=-1)
    valid_want = np.all(np.isfinite(want), axis=-1)
    validity_agree = (valid_got == valid_want).mean()
    both = valid_got & valid_want
    if both.any():
        dots = np.clip(np.abs(np.sum(got[both] * want[both], axis=-1)), 0, 1)
        ang = np.degrees(np.arccos(dots))
        sign = np.sum(got[both] * want[both], axis=-1) > 0
    else:
        ang = np.zeros(0)
        sign = np.ones(0, bool)
    agree = ((validity_agree >= min_agree)
             and (ang.max(initial=0.0) <= angle_tol_deg)
             and sign.all())
    return agree, validity_agree, ang.max(initial=0.0), sign.mean() if len(sign) else 1.0


class TestNormalsParity:
    def test_flat_plane(self):
        pts = fixtures.analytic_plane_cloud(24, 24, normal=(0, 0, 1), d=1.0,
                                            step=0.15)
        ok, va, ang, sg = _compare(pts, np.array([0, 0, 5], np.float32))
        assert ok, (va, ang, sg)

    def test_tilted_plane_with_noise(self):
        pts = fixtures.analytic_plane_cloud(24, 24, normal=(1, 1, 2), d=-2.0,
                                            step=0.15, noise=0.005, seed=2)
        ok, va, ang, sg = _compare(pts, np.zeros(3, np.float32),
                                   angle_tol_deg=0.2)
        assert ok, (va, ang, sg)

    def test_nan_holes(self):
        pts = fixtures.analytic_plane_cloud(24, 24, normal=(0, 0, 1), d=1.0,
                                            step=0.15)
        rng = np.random.default_rng(0)
        holes = rng.random(pts.shape[:2]) < 0.1
        pts[holes] = np.nan
        ok, va, ang, sg = _compare(pts, np.array([0, 0, 5], np.float32))
        assert ok, (va, ang, sg)

    def test_room_scene(self):
        pts, origin = fixtures.synthetic_room_cloud(40, 56, f=40.0, seed=1)
        ok, va, ang, sg = _compare(pts, origin, angle_tol_deg=0.5,
                                   min_agree=0.995)
        assert ok, (va, ang, sg)

    def test_range_restriction(self):
        pts = fixtures.analytic_plane_cloud(24, 24, step=0.15)
        full = np.asarray(normals_op.compute_normals_organized(
            jnp.asarray(pts), jnp.array([0, 0, 5.0]),
            row_range=(5, 15), col_range=(3, 20)))
        inside = full[5:15, 3:20]
        assert np.all(np.isfinite(inside[2:-2, 2:-2]))
        outside_mask = np.ones(pts.shape[:2], bool)
        outside_mask[5:15, 3:20] = False
        assert not np.any(np.isfinite(full[outside_mask]))

    def test_no_diagonals_param(self):
        params = ComputeNormalsParams(include_diagonal_neighbors=False)
        pts = fixtures.analytic_plane_cloud(16, 16, step=0.15)
        ok, va, ang, sg = _compare(pts, np.array([0, 0, 5.0], np.float32),
                                   params)
        assert ok, (va, ang, sg)

    def test_support_counts_match_oracle(self):
        pts, origin = fixtures.synthetic_room_cloud(24, 32, f=24.0, seed=3)
        params = ComputeNormalsParams()
        sup = normals_op.find_normal_support(jnp.asarray(pts), params)
        count = np.asarray(sup.count)
        for row in range(0, 24, 5):
            for col in range(0, 32, 7):
                nbrs = oracle.find_normal_support_neighbors(
                    pts, col, row, params.min_neighbor_distance,
                    params.max_neighbor_distance, True)
                assert count[row, col] == len(nbrs), (row, col)
