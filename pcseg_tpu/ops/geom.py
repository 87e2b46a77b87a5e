"""Core batched geometry: symmetric 3x3 eigensolver, planes, SE(3) poses.

Array-native reimplementation of the reference library's L0 math dependencies
(eigenmath Pose3/Plane3, Eigen SelfAdjointEigenSolver::computeDirect).

All functions are pure jnp, batched over arbitrary leading axes, f32 by
default, and safe under jit/vmap/shard_map.

Reference parity notes:
  * Planes follow the Eigen ``Hyperplane`` convention used throughout the
    reference: ``coeffs = (normal, offset)`` with ``offset = -normal . point``
    so ``signed_distance(x) = normal . x + offset``
    (see pointcloud_segmentation/plane_estimator.cc:52,210).
  * ``eigh3x3_smallest`` replicates the semantics of Eigen's closed-form
    ``computeDirect`` (shift/scale + trigonometric roots + cross-product
    kernel extraction) used by the reference plane estimator
    (plane_estimator.cc:202-207), including ascending eigenvalue order.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# float32 smallest normalized positive value; the reference uses
# std::numeric_limits<float>::min() as its eigenvalue validity gate
# (plane_estimator.cc:205).
FLT_MIN = 1.1754944e-38


# ---------------------------------------------------------------------------
# Symmetric 3x3 eigendecomposition (closed form, batched)
# ---------------------------------------------------------------------------

def _roots_of_depressed_characteristic_c(m00, m01, m02, m11, m12, m22):
    """Eigenvalues (ascending, as a 3-tuple of [...] arrays) of a symmetric
    3x3 batch given as scalar component grids — the component-grid layout
    (every array tiles as a plain [...] grid; no [..., 3, 3] trailing dims).
    Mirrors the structure of Eigen's ``computeRoots`` on the already
    shifted/scaled matrix."""
    c0 = (m00 * m11 * m22
          + 2.0 * m01 * m02 * m12
          - m00 * m12 * m12
          - m11 * m02 * m02
          - m22 * m01 * m01)
    c1 = (m00 * m11 - m01 * m01
          + m00 * m22 - m02 * m02
          + m11 * m22 - m12 * m12)
    c2 = m00 + m11 + m22

    c2_over_3 = c2 * (1.0 / 3.0)
    a_over_3 = jnp.maximum((c2 * c2_over_3 - c1) * (1.0 / 3.0), 0.0)
    half_b = 0.5 * (c0 + c2_over_3 * (2.0 * c2_over_3 * c2_over_3 - c1))
    q = jnp.maximum(a_over_3 * a_over_3 * a_over_3 - half_b * half_b, 0.0)

    rho = jnp.sqrt(a_over_3)
    theta = jnp.arctan2(jnp.sqrt(q), half_b) * (1.0 / 3.0)
    cos_t = jnp.cos(theta)
    sin_t = jnp.sin(theta)
    sqrt3 = jnp.asarray(1.7320508075688772, m00.dtype)

    e2 = c2_over_3 + 2.0 * rho * cos_t
    e0 = c2_over_3 - rho * (cos_t + sqrt3 * sin_t)
    e1 = c2_over_3 - rho * (cos_t - sqrt3 * sin_t)
    return e0, e1, e2


def eigh3x3_smallest_c(c00, c01, c02, c11, c12, c22, prev_normal=None):
    """Component-grid form of :func:`eigh3x3_smallest` — the production
    path. Every input/intermediate is a plain [...] array (no gathers,
    pure fusable elementwise ops); the f32 arithmetic
    and op order are identical to the matrix form, so the computeDirect
    knife-edge parity (plane_estimator.cc:202-207) carries over.

    Returns ((e0, e1, e2) ascending, vec [..., 3]).
    """
    dtype = c00.dtype
    eps = jnp.asarray(1.1920929e-07 if dtype == jnp.float32 else 2.22e-16,
                      dtype)
    trace = c00 + c11 + c22
    shift = trace * (1.0 / 3.0)
    s00 = c00 - shift
    s11 = c11 - shift
    s22 = c22 - shift
    scale = jnp.maximum(
        jnp.maximum(jnp.maximum(jnp.abs(s00), jnp.abs(s11)),
                    jnp.maximum(jnp.abs(s22), jnp.abs(c01))),
        jnp.maximum(jnp.abs(c02), jnp.abs(c12)))
    safe_scale = jnp.where(scale > 0, scale, 1.0)
    # true division (not reciprocal-multiply): bit-matches the matrix form
    # and the oracle's f32 knife edges
    a00, a11, a22 = s00 / safe_scale, s11 / safe_scale, s22 / safe_scale
    a01, a02, a12 = c01 / safe_scale, c02 / safe_scale, c12 / safe_scale

    ev0, ev1, ev2 = _roots_of_depressed_characteristic_c(
        a00, a01, a02, a11, a12, a22)
    evals = jnp.stack([ev0 * safe_scale + shift,
                       ev1 * safe_scale + shift,
                       ev2 * safe_scale + shift], axis=-1)

    def extract_kernel(lam):
        """Null-space direction of (scaled - lam*I), Eigen's extract_kernel:
        representative = column with max |diagonal|, crossed with the other
        two columns, larger result wins. Returns (vec, representative) as
        component triples."""
        d0 = a00 - lam
        d1 = a11 - lam
        d2 = a22 - lam
        # columns of the symmetric matrix
        col0 = (d0, a01, a02)
        col1 = (a01, d1, a12)
        col2 = (a02, a12, d2)

        ad0, ad1, ad2 = jnp.abs(d0), jnp.abs(d1), jnp.abs(d2)
        # argmax over (ad0, ad1, ad2) with first-max-wins (argmax semantics)
        pick0 = (ad0 >= ad1) & (ad0 >= ad2)
        pick1 = (~pick0) & (ad1 >= ad2)

        def sel3(x0, x1, x2):
            return jnp.where(pick0, x0, jnp.where(pick1, x1, x2))

        # representative column c_i0 and the other two in (i0+1, i0+2) order
        ci0 = tuple(sel3(col0[i], col1[i], col2[i]) for i in range(3))
        cn1 = tuple(sel3(col1[i], col2[i], col0[i]) for i in range(3))
        cn2 = tuple(sel3(col2[i], col0[i], col1[i]) for i in range(3))

        def cross(u, v):
            return (u[1] * v[2] - u[2] * v[1],
                    u[2] * v[0] - u[0] * v[2],
                    u[0] * v[1] - u[1] * v[0])

        cr0 = cross(ci0, cn1)
        cr1 = cross(ci0, cn2)
        n0 = cr0[0] * cr0[0] + cr0[1] * cr0[1] + cr0[2] * cr0[2]
        n1 = cr1[0] * cr1[0] + cr1[1] * cr1[1] + cr1[2] * cr1[2]
        use0 = n0 > n1
        norm2 = jnp.maximum(jnp.maximum(n0, n1), FLT_MIN)
        r = jax.lax.rsqrt(norm2)
        best = tuple(jnp.where(use0, cr0[i], cr1[i]) * r for i in range(3))
        return best, ci0

    # Mirror Eigen computeDirect's eigenvector ordering: extract the most
    # separated extreme eigenvalue's vector first (well conditioned), then
    # the other extreme, falling back to the orthogonal complement of the
    # representative column when the remaining pair is numerically equal.
    dd0 = ev2 - ev1
    dd1 = ev1 - ev0
    k_is_two = dd0 > dd1        # lambda_0 ~ lambda_1: top is most distinct
    min_sep = jnp.minimum(dd0, dd1)
    max_sep = jnp.maximum(dd0, dd1)

    v0_direct, _ = extract_kernel(ev0)
    v2, repr2 = extract_kernel(ev2)

    # near-degenerate pair: orthogonalize the representative against v2
    dot_r = v2[0] * repr2[0] + v2[1] * repr2[1] + v2[2] * repr2[2]
    ortho = tuple(repr2[i] - dot_r * v2[i] for i in range(3))
    ortho_n2 = jnp.maximum(
        ortho[0] * ortho[0] + ortho[1] * ortho[1] + ortho[2] * ortho[2],
        FLT_MIN)
    r_o = jax.lax.rsqrt(ortho_n2)

    pair_equal = min_sep <= 2.0 * eps * max_sep
    degenerate = (ev2 - ev0) <= eps
    one = jnp.ones_like(ev0)
    zero = jnp.zeros_like(ev0)
    fallback = (one, zero, zero)
    comp = []
    for i in range(3):
        v0_ortho_i = ortho[i] * r_o
        v0_from_k2_i = jnp.where(pair_equal, v0_ortho_i, v0_direct[i])
        vec_i = jnp.where(k_is_two, v0_from_k2_i, v0_direct[i])
        comp.append(jnp.where(degenerate, fallback[i], vec_i))

    if prev_normal is not None:
        dot = (comp[0] * prev_normal[..., 0]
               + comp[1] * prev_normal[..., 1]
               + comp[2] * prev_normal[..., 2])
        flip = dot < 0.0
        comp = [jnp.where(flip, -c, c) for c in comp]
    vec = jnp.stack(comp, axis=-1)
    return evals, vec


def eigh3x3_smallest(cov, prev_normal=None):
    """Smallest-eigenvalue eigenvector of a batch of symmetric 3x3 matrices.

    Matrix-layout wrapper over :func:`eigh3x3_smallest_c` (same f32
    semantics; see there).

    Args:
      cov: [..., 3, 3] symmetric (covariance) matrices.
      prev_normal: optional [..., 3] orientation hint; the returned vector is
        sign-flipped so that ``dot(prev_normal, v) >= 0`` — mirroring the
        sticky normal orientation of the reference estimator
        (plane_estimator.cc:209-213, flipped convention: reference keeps the
        sign whose dot with the stored normal is positive).

    Returns:
      (eigenvalues [..., 3] ascending, eigenvector [..., 3] unit-norm for the
      smallest eigenvalue).
    """
    return eigh3x3_smallest_c(
        cov[..., 0, 0], cov[..., 0, 1], cov[..., 0, 2],
        cov[..., 1, 1], cov[..., 1, 2], cov[..., 2, 2], prev_normal)


# ---------------------------------------------------------------------------
# Planes (Eigen Hyperplane convention: coeffs = (n, d), d = -n.p)
# ---------------------------------------------------------------------------

def plane_from_normal_point(normal, point):
    """[..., 4] plane coeffs from unit normal and a point on the plane."""
    offset = -jnp.sum(normal * point, axis=-1, keepdims=True)
    return jnp.concatenate([normal, offset], axis=-1)


def plane_signed_distance(plane, x):
    """Signed distance n.x + d. plane: [..., 4], x: [..., 3] -> [...]."""
    return jnp.sum(plane[..., :3] * x, axis=-1) + plane[..., 3]


def plane_abs_distance(plane, x):
    return jnp.abs(plane_signed_distance(plane, x))


def plane_project(plane, x):
    """Orthogonal projection of x onto the plane."""
    d = plane_signed_distance(plane, x)
    return x - d[..., None] * plane[..., :3]


def pose_from_plane(plane):
    """(R, t) of a frame whose +z is the plane normal, origin on the plane.

    Mirrors eigenmath::PoseFromPlane used by PlanarConvexHull
    (algorithms.h:530): world_pose_plane maps plane-frame (x, y, 0) points
    into world. Returns rotation matrix [..., 3, 3] (columns = plane-frame
    axes in world) and translation [..., 3].
    """
    n = plane[..., :3]
    t = -plane[..., 3:4] * n  # closest point on plane to origin
    # Build an orthonormal basis with z = n (robust Frisvad-style choice).
    z = n
    # pick the world axis least aligned with n
    ax = jnp.abs(z)
    use_x = (ax[..., 0] <= ax[..., 1]) & (ax[..., 0] <= ax[..., 2])
    use_y = (~use_x) & (ax[..., 1] <= ax[..., 2])
    helper = jnp.where(
        use_x[..., None],
        jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0], plane.dtype), z.shape),
        jnp.where(
            use_y[..., None],
            jnp.broadcast_to(jnp.array([0.0, 1.0, 0.0], plane.dtype), z.shape),
            jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0], plane.dtype), z.shape)))
    x = jnp.cross(helper, z)
    x = x * jax.lax.rsqrt(jnp.maximum(
        jnp.sum(x * x, axis=-1, keepdims=True), FLT_MIN))
    y = jnp.cross(z, x)
    rot = jnp.stack([x, y, z], axis=-1)  # columns
    return rot, t


# ---------------------------------------------------------------------------
# SE(3) poses as (quaternion wxyz, translation)
# ---------------------------------------------------------------------------

def quat_identity(dtype=jnp.float32):
    return jnp.array([1.0, 0.0, 0.0, 0.0], dtype=dtype)


def quat_normalize(q):
    return q * jax.lax.rsqrt(jnp.maximum(
        jnp.sum(q * q, axis=-1, keepdims=True), FLT_MIN))


def quat_multiply(a, b):
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return jnp.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], axis=-1)


def quat_rotate(q, v):
    """Rotate vectors v [..., 3] by unit quaternions q [..., 4] (wxyz)."""
    qv = q[..., 1:4]
    uv = jnp.cross(qv, v)
    uuv = jnp.cross(qv, uv)
    return v + 2.0 * (q[..., 0:1] * uv + uuv)


def quat_to_matrix(q):
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = jnp.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], axis=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def matrix_to_quat(m):
    """Rotation matrix [..., 3, 3] -> unit quaternion wxyz (batched, robust)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def mk(w, x, y, z):
        return jnp.stack([w, x, y, z], axis=-1)

    q0 = mk(1.0 + tr, m21 - m12, m02 - m20, m10 - m01)
    q1 = mk(m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20)
    q2 = mk(m02 - m20, m01 + m10, 1.0 + m11 - m00 - m22, m12 + m21)
    q3 = mk(m10 - m01, m02 + m20, m12 + m21, 1.0 + m22 - m00 - m11)

    c0 = tr > 0
    c1 = (m00 >= m11) & (m00 >= m22)
    c2 = m11 >= m22
    q = jnp.where(c0[..., None], q0,
                  jnp.where(c1[..., None], q1,
                            jnp.where(c2[..., None], q2, q3)))
    return quat_normalize(q)


class Pose:
    """Lightweight SE(3) pose pytree: rotation quaternion (wxyz) + translation.

    Replaces eigenmath::Pose3d/Pose3f on device. Static methods keep
    it a plain (quat, trans) tuple-of-arrays friendly to jit.
    """

    __slots__ = ("quat", "trans")

    def __init__(self, quat=None, trans=None, dtype=jnp.float32):
        self.quat = quat_identity(dtype) if quat is None else jnp.asarray(quat)
        self.trans = (jnp.zeros(3, dtype) if trans is None
                      else jnp.asarray(trans))

    @staticmethod
    def identity(dtype=jnp.float32):
        return Pose(dtype=dtype)

    @staticmethod
    def from_matrix(rot, trans):
        return Pose(matrix_to_quat(rot), trans)

    def rotation_matrix(self):
        return quat_to_matrix(self.quat)

    def apply(self, points):
        return quat_rotate(self.quat, points) + self.trans

    def rotate(self, vectors):
        return quat_rotate(self.quat, vectors)

    def compose(self, other):
        """self * other (apply other first, then self)."""
        return Pose(quat_normalize(quat_multiply(self.quat, other.quat)),
                    quat_rotate(self.quat, other.trans) + self.trans)

    def inverse(self):
        qinv = self.quat * jnp.array([1.0, -1.0, -1.0, -1.0], self.quat.dtype)
        return Pose(qinv, -quat_rotate(qinv, self.trans))

    def astype(self, dtype):
        return Pose(self.quat.astype(dtype), self.trans.astype(dtype))


jax.tree_util.register_pytree_node(
    Pose,
    lambda p: ((p.quat, p.trans), None),
    lambda _, xs: Pose(xs[0], xs[1]),
)
