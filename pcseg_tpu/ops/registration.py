"""Point-cloud registration: nearest neighbors, Kabsch, ICP.

Data-parallel reimplementation of the registration toolbox in
pointcloud_segmentation/algorithms.h:
  * NearestNeighbors (:612-631) — the reference's O(N*M) brute force
    becomes a single distance matrix whose cross term is one matmul.
  * ComputeRigidTransform (:554-607) — Kabsch via SVD of the 3x3 cross
    covariance with the det(R) = -1 mirror correction.
  * IterativeClosestPoint (:637-684) — bounded iteration with the same
    mean-error tolerance early-out, as a lax.while_loop.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from pcseg_tpu.ops import geom


def _mm(a, b):
    """Full-f32 matmul: without a precision, float32 contractions may run
    as TF32 on tensor-core GPUs (10-bit mantissa)."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def nearest_neighbors(source: jnp.ndarray, dest: jnp.ndarray,
                      tile: Optional[int] = None) -> jnp.ndarray:
    """Index into ``dest`` of the closest point for each source point.

    source: [N, 3], dest: [M, 3] -> [N] int32. The -2 s.d^T cross term is a
    [N,3]x[3,M] matmul; squared norms are rank-1 corrections.
    ``tile`` bounds the distance-matrix working set for large N.
    """
    # accumulate in at least f32 without truncating f64 inputs
    # (algorithms_test.cc:406-428 exercises the double-typed suite)
    acc_t = jnp.promote_types(source.dtype, jnp.float32)

    def block(src):
        cross = jnp.dot(src, dest.T, preferred_element_type=acc_t,
                        precision=jax.lax.Precision.HIGHEST)
        d2 = (jnp.sum(src * src, axis=-1, keepdims=True)
              - 2.0 * cross
              + jnp.sum(dest * dest, axis=-1)[None, :])
        return jnp.argmin(d2, axis=-1).astype(jnp.int32)

    if tile is None or source.shape[0] <= tile:
        return block(source)
    n = source.shape[0]
    pad = (-n) % tile
    padded = jnp.concatenate(
        [source, jnp.zeros((pad, 3), source.dtype)], axis=0)
    blocks = padded.reshape(-1, tile, 3)
    out = jax.lax.map(block, blocks).reshape(-1)
    return out[:n]


class RigidTransform(NamedTuple):
    rotation: jnp.ndarray     # [3, 3]
    translation: jnp.ndarray  # [3]

    def apply(self, points):
        return _mm(points, self.rotation.T) + self.translation


def compute_rigid_transform(source: jnp.ndarray, dest: jnp.ndarray,
                            weights: Optional[jnp.ndarray] = None
                            ) -> RigidTransform:
    """Best-fit rotation+translation mapping source onto dest (paired
    points) — Kabsch/SVD (algorithms.h:554-607), optionally weighted."""
    if weights is None:
        weights = jnp.ones(source.shape[:-1], source.dtype)
    wsum = jnp.maximum(jnp.sum(weights), geom.FLT_MIN)
    c_s = jnp.sum(source * weights[:, None], axis=0) / wsum
    c_d = jnp.sum(dest * weights[:, None], axis=0) / wsum
    s = (source - c_s) * weights[:, None]
    d = dest - c_d
    # SD^T accumulated as a 3x3 matmul (algorithms.h:576-581); accumulate
    # in at least f32 without truncating f64 inputs
    sdt = jnp.dot(s.T, d,
                  preferred_element_type=jnp.promote_types(
                      source.dtype, jnp.float32),
                  precision=jax.lax.Precision.HIGHEST)
    u, _, vt = jnp.linalg.svd(sdt, full_matrices=True)
    v = vt.T
    det = jnp.linalg.det(u) * jnp.linalg.det(v)
    sign = jnp.stack([jnp.ones_like(det), jnp.ones_like(det), det])
    # R = V S U^T with S = diag(1, 1, det) (mirror correction, :593-601)
    r = _mm(v * sign[None, :], u.T)
    t = c_d - _mm(r, c_s)
    return RigidTransform(rotation=r, translation=t)


class ICPResult(NamedTuple):
    transform: RigidTransform
    mean_error: jnp.ndarray
    iterations: jnp.ndarray


def iterative_closest_point(source: jnp.ndarray, dest: jnp.ndarray,
                            max_iterations: int = 20,
                            tolerance: float = 1e-3) -> ICPResult:
    """ICP (algorithms.h:637-684): NN match, Kabsch, accumulate, stop when
    the mean error change drops below tolerance."""
    eye = RigidTransform(jnp.eye(3, dtype=source.dtype),
                         jnp.zeros(3, source.dtype))

    def cond(state):
        transformed, acc_r, acc_t, prev_err, err, it, done = state
        return (~done) & (it < max_iterations)

    def body(state):
        transformed, acc_r, acc_t, prev_err, _, it, _ = state
        nn = nearest_neighbors(transformed, dest)
        matched = dest[nn]
        step = compute_rigid_transform(transformed, matched)
        new_transformed = step.apply(transformed)
        err = jnp.mean(jnp.linalg.norm(new_transformed - matched, axis=-1))
        new_r = _mm(step.rotation, acc_r)
        new_t = _mm(step.rotation, acc_t) + step.translation
        done = jnp.abs(prev_err - err) < tolerance
        return (new_transformed, new_r, new_t, err, err, it + 1, done)

    init = (source, eye.rotation, eye.translation,
            jnp.asarray(0.0, source.dtype), jnp.asarray(0.0, source.dtype),
            jnp.int32(0), jnp.bool_(False))
    _, r, t, _, err, it, _ = jax.lax.while_loop(cond, body, init)
    return ICPResult(transform=RigidTransform(r, t), mean_error=err,
                     iterations=it)
