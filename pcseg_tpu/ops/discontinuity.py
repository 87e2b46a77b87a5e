"""Device-side geometric discontinuity stencil.

The reference flags boundary points of a planar region as discontinuous
via per-pixel checks against same-label 4-neighbors
(planar_region.h:356-417): range gate, all-4-neighbors-in-bounds, then a
point is discontinuous unless the step to some same-label neighbor is
"smooth" (normal angle < 5 deg AND robot-frame |dz| < 0.05 m) or a
"shadow" (|dz|/||delta|| < 0.7).

The host finalize used to run this over each region's boundary list after
fetching the full [H, W, 3] normals grid (3.7 MB per VGA frame over the
host link). The math is pure per-pixel stencil work
(SURVEY §7.7), so this module computes the flag for EVERY pixel on device
inside the same program as the growth; the host intersects the bit grid
with each accepted region's boundary — normals never leave the device.

Validity vs the host path: the host pass runs after rejected regions
revert to UNLABELED, but a rejected region's cells carried a DIFFERENT
label than any accepted region's, so the same-label neighbor tests of
accepted-region pixels are identical under device-time labels (tested
against models/boundary.discontinuous_boundary).

Known divergence (documented): the host/NumPy port widens |dz| and
||delta|| to f64 (matching the C++ double intermediates,
planar_region.h:390-405); on device they stay f32. The gates (0.05 m,
ratio 0.7) sit ~6 orders of magnitude above the f32/f64 difference on
metre-scale deltas; the parity tests assert exact flag agreement on the
room scenes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from pcseg_tpu.models.config import PlanarRegionConfig
from pcseg_tpu.ops import nansafe
from pcseg_tpu.ops.normals import _shift


def discontinuity_flags(points: jnp.ndarray,
                        normals: jnp.ndarray,
                        labels: jnp.ndarray,
                        rot_robot: jnp.ndarray,
                        config: PlanarRegionConfig) -> jnp.ndarray:
    """[H, W] bool: pixel fails every same-label smooth/shadow test.

    Mirrors models/boundary.discontinuous_boundary (planar_region.h:356-417)
    for every pixel at once; the caller intersects with boundary sets.
    ``labels``: the device label grid at growth time. ``rot_robot``: [3, 3]
    rotation of robot_pose_point_cloud.
    """
    h, w = points.shape[0], points.shape[1]
    dtype = points.dtype
    min_sq = jnp.asarray(config.discontinuity_min_range ** 2, dtype)
    max_sq = jnp.asarray(config.discontinuity_max_range ** 2, dtype)

    rows = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)

    p = points
    sq = jnp.sum(p * p, axis=-1)
    # kNSkipCycles: all 4 neighbors in bounds (planar_region.h:368-371)
    cand = ((sq > min_sq) & (sq < max_sq)
            & (rows > 0) & (rows < h - 1) & (cols > 0) & (cols < w - 1))
    rot = rot_robot.astype(dtype)
    angle_gate = jnp.asarray(config.discontinuity_normal_angle_diff, dtype)
    z_gate = jnp.asarray(config.discontinuity_z_diff, dtype)
    ratio_gate = jnp.asarray(config.discontinuity_z_ratio, dtype)

    p_valid = nansafe.isfinite(p[..., 2])
    disc = jnp.zeros((h, w), bool)
    for d_row, d_col in ((0, -1), (-1, 0), (0, 1), (1, 0)):
        pn = _shift(points, -d_row, -d_col, jnp.nan)
        nn = _shift(normals, -d_row, -d_col, jnp.nan)
        ln = _shift(labels, -d_row, -d_col, -(2 ** 30))
        ok = (cand & p_valid
              & nansafe.isfinite(pn[..., 2])
              & (ln == labels))
        delta = p - pn
        delta_r = jnp.einsum("ij,hwj->hwi", rot, delta,
                             precision=jax.lax.Precision.HIGHEST)
        cosang = jnp.sum(normals * nn, axis=-1)
        ang_ok = nansafe.isfinite(cosang) & (cosang >= -1.0) & (cosang <= 1.0)
        ang = jnp.abs(jnp.degrees(jnp.arccos(jnp.clip(cosang, -1.0, 1.0))))
        dz = jnp.abs(delta_r[..., 2])
        smooth = ang_ok & (ang < angle_gate) & (dz < z_gate)
        norm = jnp.sqrt(jnp.sum(delta_r * delta_r, axis=-1))
        shadow = (norm > 0) & (dz / jnp.where(norm > 0, norm, 1.0)
                               < ratio_gate)
        disc = disc | (ok & ~smooth & ~shadow)
    return disc
