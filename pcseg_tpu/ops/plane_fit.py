"""Batched incremental-PCA plane fitting (the reference's PlaneEstimator).

The reference keeps a running plane fit in 10 scalars: six second moments
(upper-triangular sum of x_i x_j), a 3-vector centroid sum, and a weight sum
(pointcloud_segmentation/plane_estimator.h:112-119). Merging
two estimators is accumulator addition (plane_estimator.cc:128-133) and
transforming to a new frame conjugates the covariance by the rotation
(plane_estimator.cc:142-182). The plane itself is the eigenvector of the
smallest eigenvalue of the 3x3 covariance (plane_estimator.cc:184-229).

Here the estimator state is a pytree of arrays batched over arbitrary leading
axes, so the same module serves:
  * per-pixel normal estimation (batch = H*W pixels),
  * per-region plane re-estimation (batch = region capacity, filled via
    masked segment sums),
  * cross-shard merges (``merge`` under ``psum`` — exact, since the merge
    algebra is addition).

Moments are accumulated in float32 by default matching the reference; the
reference's own tests accept 1e-4 normal error from accumulation-order
nondeterminism (plane_estimator_test.cc:34-36).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from pcseg_tpu.ops import geom


class PlaneMoments(NamedTuple):
    """Accumulator state. Shapes share leading batch dims ``[...]``.

    s2: [..., 6] second moments (xx, xy, xz, yy, yz, zz) — same packing as
        the reference accumulator_ (plane_estimator.cc:55-65).
    s1: [..., 3] weighted point sum.
    w:  [...]    weight sum.
    normal_hint: [..., 3] sticky normal orientation (plane_estimator.cc:113-126).
    """
    s2: jnp.ndarray
    s1: jnp.ndarray
    w: jnp.ndarray
    normal_hint: jnp.ndarray


def empty(batch_shape=(), dtype=jnp.float32) -> PlaneMoments:
    """Cleared estimator; normal_hint = +x like the reference Clear()
    (plane_estimator.cc:46-53 sets coeffs to (1, 0, 0, 0))."""
    hint = jnp.zeros(batch_shape + (3,), dtype).at[..., 0].set(1.0)
    return PlaneMoments(
        s2=jnp.zeros(batch_shape + (6,), dtype),
        s1=jnp.zeros(batch_shape + (3,), dtype),
        w=jnp.zeros(batch_shape, dtype),
        normal_hint=hint,
    )


def moments_of_points(points, weights=None) -> tuple:
    """(s2, s1, w) contributions of a point set, reduced over the N axis.

    points: [..., N, 3]; weights: optional [..., N] (0 masks a point out).
    Returns (s2 [..., 6], s1 [..., 3], w [...]).
    """
    if weights is None:
        weights = jnp.ones(points.shape[:-1], points.dtype)
    x = points[..., 0]
    y = points[..., 1]
    z = points[..., 2]
    wts = weights
    s2 = jnp.stack([
        jnp.sum(x * x * wts, axis=-1),
        jnp.sum(x * y * wts, axis=-1),
        jnp.sum(x * z * wts, axis=-1),
        jnp.sum(y * y * wts, axis=-1),
        jnp.sum(y * z * wts, axis=-1),
        jnp.sum(z * z * wts, axis=-1),
    ], axis=-1)
    s1 = jnp.sum(points * wts[..., None], axis=-2)
    w = jnp.sum(wts, axis=-1)
    return s2, s1, w


def add_points(m: PlaneMoments, points, weights=None) -> PlaneMoments:
    """Add (masked, weighted) points; points [..., N, 3] batched like m."""
    s2, s1, w = moments_of_points(points, weights)
    return m._replace(s2=m.s2 + s2, s1=m.s1 + s1, w=m.w + w)


def merge(a: PlaneMoments, b: PlaneMoments) -> PlaneMoments:
    """Accumulator addition (plane_estimator.cc:128-133). Keeps a's hint."""
    return PlaneMoments(a.s2 + b.s2, a.s1 + b.s1, a.w + b.w, a.normal_hint)


def set_normal_orientation(m: PlaneMoments, hint) -> PlaneMoments:
    """Store the orientation hint used to sign the computed normal."""
    return m._replace(normal_hint=hint)


def _covariance_c(m: PlaneMoments):
    """Mean-centered covariance components and centroid from the
    accumulators (mirrors plane_estimator.cc:187-199). Component-grid form
    — the layout used by the production solve path."""
    w_safe = jnp.where(m.w > 0, m.w, 1.0)
    centroid = m.s1 / w_safe[..., None]
    accu = m.s2 / w_safe[..., None]
    cx, cy, cz = centroid[..., 0], centroid[..., 1], centroid[..., 2]
    c00 = accu[..., 0] - cx * cx
    c01 = accu[..., 1] - cx * cy
    c02 = accu[..., 2] - cx * cz
    c11 = accu[..., 3] - cy * cy
    c12 = accu[..., 4] - cy * cz
    c22 = accu[..., 5] - cz * cz
    return (c00, c01, c02, c11, c12, c22), centroid


def _covariance(m: PlaneMoments):
    """Matrix-layout wrapper of :func:`_covariance_c` (transform() needs
    the full 3x3 for the rotation conjugation)."""
    (c00, c01, c02, c11, c12, c22), centroid = _covariance_c(m)
    row0 = jnp.stack([c00, c01, c02], axis=-1)
    row1 = jnp.stack([c01, c11, c12], axis=-1)
    row2 = jnp.stack([c02, c12, c22], axis=-1)
    cov = jnp.stack([row0, row1, row2], axis=-2)
    return cov, centroid


class PlaneSolution(NamedTuple):
    plane: jnp.ndarray      # [..., 4] coeffs (n, d)
    centroid: jnp.ndarray   # [..., 3]
    curvature: jnp.ndarray  # [...]
    valid: jnp.ndarray      # [...] bool
    normal: jnp.ndarray     # [..., 3] convenience alias of plane[..., :3]
    # middle-eigenvalue fraction lambda_1 / trace: ~0 for a rank-deficient
    # (collinear) point set, O(0.01..0.5) for a genuine 2-D surface patch.
    # The reference's FLT_MIN validity gate sits *inside* f32 rounding
    # noise for collinear sets (its own tests call collinear fits invalid,
    # plane_estimator_test.cc:76-144, yet rounding can produce a "valid"
    # noise-direction fit) — this ratio is the noise-robust classifier.
    mid_ratio: jnp.ndarray = None


def solve(m: PlaneMoments) -> PlaneSolution:
    """Closed-form plane solve, batched (plane_estimator.cc:184-229).

    Validity gate: second-smallest covariance eigenvalue > FLT_MIN and at
    least one point (w > 0). Invalid entries return a plane through the
    centroid with the (sticky) hint normal — mirroring the reference's
    invalid branch (plane_estimator.cc:224-228).
    """
    (c00, c01, c02, c11, c12, c22), centroid = _covariance_c(m)
    evals, vec = geom.eigh3x3_smallest_c(
        c00, c01, c02, c11, c12, c22, prev_normal=m.normal_hint)

    valid = (m.w > 0) & (evals[..., 1] > geom.FLT_MIN)

    normal = jnp.where(valid[..., None], vec, m.normal_hint)
    plane = geom.plane_from_normal_point(normal, centroid)

    trace = c00 + c11 + c22
    lam0 = evals[..., 0]
    curv_ok = (trace > lam0) & (lam0 > geom.FLT_MIN) & valid
    curvature = jnp.where(curv_ok, jnp.abs(lam0 / jnp.where(trace != 0, trace, 1.0)), 0.0)
    mid_ratio = jnp.where(trace > 0,
                          evals[..., 1] / jnp.where(trace > 0, trace, 1.0),
                          0.0)

    return PlaneSolution(plane=plane, centroid=centroid,
                         curvature=curvature, valid=valid, normal=normal,
                         mid_ratio=mid_ratio)


def transform(m: PlaneMoments, pose: geom.Pose) -> PlaneMoments:
    """Re-express the accumulators in a new frame (plane_estimator.cc:142-182).

    cov' = R cov R^T on the mean-centered covariance; centroid moves by the
    full pose; moments reassembled so merge-after-transform is exact.
    """
    cov, centroid = _covariance(m)
    rot = pose.rotation_matrix()
    hi = jax.lax.Precision.HIGHEST
    cov_t = jnp.matmul(jnp.matmul(rot, cov, precision=hi),
                       jnp.swapaxes(rot, -1, -2), precision=hi)
    new_centroid = pose.apply(centroid)
    cx, cy, cz = new_centroid[..., 0], new_centroid[..., 1], new_centroid[..., 2]
    s2 = jnp.stack([
        cov_t[..., 0, 0] + cx * cx,
        cov_t[..., 0, 1] + cx * cy,
        cov_t[..., 0, 2] + cx * cz,
        cov_t[..., 1, 1] + cy * cy,
        cov_t[..., 1, 2] + cy * cz,
        cov_t[..., 2, 2] + cz * cz,
    ], axis=-1) * m.w[..., None]
    s1 = new_centroid * m.w[..., None]
    # The sticky normal hint rotates with the frame.
    hint = pose.rotate(m.normal_hint)
    return PlaneMoments(s2=s2, s1=s1, w=m.w, normal_hint=hint)


# ---------------------------------------------------------------------------
# Serialization (parity with PlaneEstimatorProto, plane_estimator.proto:22-32)
# ---------------------------------------------------------------------------

def to_dict(m: PlaneMoments) -> dict:
    return {
        "covariance_accumulator": m.s2,
        "cumulative_centroid": m.s1,
        "cumulative_weights": m.w,
        "normal": m.normal_hint,
    }


def from_dict(d: dict) -> PlaneMoments:
    return PlaneMoments(
        s2=jnp.asarray(d["covariance_accumulator"]),
        s1=jnp.asarray(d["cumulative_centroid"]),
        w=jnp.asarray(d["cumulative_weights"]),
        normal_hint=jnp.asarray(d["normal"]),
    )
