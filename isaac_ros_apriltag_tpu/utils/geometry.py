"""Batched geometry primitives: quaternions, homographies, small linear solves.

Everything here is shape-polymorphic over leading batch dims and jit-safe.
The reference does rotation->quaternion conversion with Eigen on host
(ref: isaac_ros_apriltag/src/apriltag_node.cpp:147-180, :409-427); here it is
a vectorized Shepperd conversion that runs on-device for all detections at
once.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# f32 contractions are pinned: a default-precision f32 dot may round its
# operands (to TF32 on the GPU).
_HI = jax.lax.Precision.HIGHEST


def quat_from_rotmat(R: jax.Array) -> jax.Array:
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4) as (w, x, y, z).

    Branch-free Shepperd's method: compute all four candidate quaternions and
    select the numerically best (largest pivot) with jnp.where.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    # Four candidates, each scaled by its pivot (all >= 0 under its branch).
    qw = jnp.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], -1)
    qx = jnp.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], -1)
    qy = jnp.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], -1)
    qz = jnp.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], -1)
    cands = jnp.stack([qw, qx, qy, qz], -2)  # (..., 4 candidates, 4 components)
    pivots = jnp.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                        1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], -1)
    best = jnp.argmax(pivots, axis=-1)
    q = jnp.take_along_axis(cands, best[..., None, None].repeat(4, -1), -2)[..., 0, :]
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    # Canonical sign: the largest-magnitude component is positive. (Canonical
    # w >= 0 is unstable when w ~ 0 — e.g. the golden fixture's 180-degree
    # flip q = (0, 0, 0, 1), ref: test/isaac_ros_apriltag_pol_test.py:164-175.)
    lead = jnp.take_along_axis(q, jnp.argmax(jnp.abs(q), -1)[..., None], -1)
    return q * jnp.where(lead < 0, -1.0, 1.0)


def rotmat_from_quat(q: jax.Array) -> jax.Array:
    """Unit quaternion (..., 4) (w, x, y, z) -> rotation matrix (..., 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return jnp.stack([
        jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        jnp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        jnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def homography_from_correspondences(src: jax.Array, dst: jax.Array) -> jax.Array:
    """Exact 4-point homography. src, dst: (..., 4, 2). Returns (..., 3, 3).

    Solves the standard 8x8 DLT system (batched). H maps
    src -> dst with H[2, 2] = 1.
    """
    # Hartley normalization of dst: raw pixel coords (~1e3) in the DLT matrix
    # destroy the f32 solve (cond ~1e6); in centered/scaled coords the system
    # is O(1)-conditioned. H = T @ H_norm with T the denormalizing transform.
    c = jnp.mean(dst, axis=-2, keepdims=True)          # (..., 1, 2)
    s = jnp.mean(jnp.abs(dst - c), axis=(-2, -1))      # (...,)
    s = jnp.maximum(s, 1e-6)
    dstn = (dst - c) / s[..., None, None]

    x, y = src[..., 0], src[..., 1]
    u, v = dstn[..., 0], dstn[..., 1]
    zeros = jnp.zeros_like(x)
    ones = jnp.ones_like(x)
    rows_u = jnp.stack([x, y, ones, zeros, zeros, zeros, -u * x, -u * y], -1)
    rows_v = jnp.stack([zeros, zeros, zeros, x, y, ones, -v * x, -v * y], -1)
    A = jnp.concatenate([rows_u, rows_v], -2)          # (..., 8, 8)
    b = jnp.concatenate([u, v], -1)[..., None]         # (..., 8, 1)
    h = jnp.linalg.solve(A, b)[..., 0]                 # (..., 8)
    Hn = jnp.concatenate([h, jnp.ones_like(h[..., :1])], -1)
    Hn = Hn.reshape(*h.shape[:-1], 3, 3)
    # denormalize: T = [[s, 0, cx], [0, s, cy], [0, 0, 1]]
    cx, cy = c[..., 0, 0], c[..., 0, 1]
    row01 = Hn[..., :2, :] * s[..., None, None]
    row01 = row01 + jnp.stack([cx, cy], -1)[..., None] * Hn[..., 2:3, :]
    return jnp.concatenate([row01, Hn[..., 2:3, :]], -2)


def apply_homography(H: jax.Array, pts: jax.Array) -> jax.Array:
    """H: (..., 3, 3); pts: (..., N, 2) -> (..., N, 2)."""
    ph = jnp.concatenate([pts, jnp.ones_like(pts[..., :1])], -1)
    q = jnp.einsum("...ij,...nj->...ni", H, ph, precision=_HI)
    return q[..., :2] / q[..., 2:3]


def line_intersection(p1: jax.Array, d1: jax.Array, p2: jax.Array, d2: jax.Array) -> jax.Array:
    """Intersect lines (point p, direction d); all (..., 2). Returns (..., 2).

    Solves p1 + t*d1 = p2 + s*d2 via 2x2 Cramer's rule; degenerate (parallel)
    pairs return the midpoint of p1, p2.
    """
    det = d1[..., 0] * (-d2[..., 1]) - (-d2[..., 0]) * d1[..., 1]
    rhs = p2 - p1
    t = (rhs[..., 0] * (-d2[..., 1]) - (-d2[..., 0]) * rhs[..., 1]) / jnp.where(
        jnp.abs(det) < 1e-9, 1.0, det)
    pt = p1 + t[..., None] * d1
    mid = 0.5 * (p1 + p2)
    return jnp.where((jnp.abs(det) < 1e-9)[..., None], mid, pt)


def inverse3x3(M: jax.Array) -> jax.Array:
    """Closed-form batched 3x3 inverse (adjugate / det). No LAPACK — batched
    LAPACK factorizations are slow to compile and inaccurate in f32 on some
    backends; the adjugate is exact, vectorized, and fuses."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    Hh = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-20, 1e-20, det)
    adj = jnp.stack([jnp.stack([A, B, C], -1),
                     jnp.stack([D, E, F], -1),
                     jnp.stack([G, Hh, I], -1)], -2)
    return adj * inv_det[..., None, None]


def orthonormalize_rotation(M: jax.Array, iters: int = 4) -> jax.Array:
    """Project (..., 3, 3) with det > 0 onto SO(3) (nearest rotation).

    Newton polar iteration X <- (X + X^-T)/2, quadratically convergent for
    inputs near a rotation (our use case: homography-derived R columns).
    Closed-form 3x3 inverse keeps it fully batched/fused.
    """
    X = M
    for _ in range(iters):
        X = 0.5 * (X + jnp.swapaxes(inverse3x3(X), -1, -2))
    return X


def se3_exp(tau: jax.Array) -> tuple[jax.Array, jax.Array]:
    """se(3) exponential. tau: (..., 6) = (omega, v). Returns (R, t)."""
    omega, v = tau[..., :3], tau[..., 3:]
    theta = jnp.linalg.norm(omega, axis=-1, keepdims=True)
    theta = jnp.maximum(theta, 1e-12)
    k = omega / theta
    K = skew(k)
    st = jnp.sin(theta)[..., None]
    ct = jnp.cos(theta)[..., None]
    I = jnp.broadcast_to(jnp.eye(3), K.shape)
    KK = jnp.einsum("...ij,...jk->...ik", K, K, precision=_HI)
    R = I + st * K + (1 - ct) * KK
    th = theta[..., None]
    V = I + ((1 - ct) / th) * K + ((th - st) / th) * KK
    small = (theta < 1e-6)[..., None]
    R = jnp.where(small, I + skew(omega), R)
    t = jnp.where(small[..., 0], v, jnp.einsum("...ij,...j->...i", V, v,
                                                        precision=_HI))
    return R, t


def skew(w: jax.Array) -> jax.Array:
    """(..., 3) -> (..., 3, 3) cross-product matrix."""
    z = jnp.zeros_like(w[..., 0])
    return jnp.stack([
        jnp.stack([z, -w[..., 2], w[..., 1]], -1),
        jnp.stack([w[..., 2], z, -w[..., 0]], -1),
        jnp.stack([-w[..., 1], w[..., 0], z], -1),
    ], -2)
