"""Tag-map bundle adjustment: batched Gauss-Newton with Schur elimination.

No reference analog (the reference is a stateless per-frame detector); this
implements the BASELINE.json north-star SLAM layer. Problem structure:

  states:  keyframe camera poses T_w_cam (K of them), tag landmark poses
           T_w_tag (L of them), both as (R, t); increments in se(3).
  factors: one observation = all 4 corners of one tag seen from one keyframe;
           residual = reprojection error (8-dim) using the detector's corner
           convention (ops/pose.TAG_CORNERS).

The normal equations are bipartite: H = [[Hcc, W], [W^T, Hll]] with
block-diagonal Hcc (6x6 per keyframe) and Hll (6x6 per landmark). Landmarks
are eliminated by the Schur complement S = Hcc - W Hll^-1 W^T; S is small
(6K x 6K) and dense-solved; landmark updates back-substitute.

Everything is fixed-shape: observations are a capacity-O arrays with a valid
mask; Jacobians come from vmapped jax.jacfwd of the per-observation residual
(exact, no finite differences). The landmark axis is the sharding axis for
the distributed version (see dba.py): each shard computes its additive
contribution to S and g_c, reduced with psum over the 'map' mesh axis.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ...ops.pose import TAG_CORNERS
from ...utils.geometry import se3_exp

# Every f32 contraction is pinned: a default-precision f32 dot may round its
# operands (to TF32 on the GPU).
_HI = jax.lax.Precision.HIGHEST


def _mm(a, b):
    return jnp.matmul(a, b, precision=_HI)


class BAProblem(NamedTuple):
    # states
    cam_R: jax.Array      # (K, 3, 3) R_world_cam
    cam_t: jax.Array      # (K, 3)
    lm_R: jax.Array       # (L, 3, 3) R_world_tag
    lm_t: jax.Array       # (L, 3)
    # observations (fixed capacity O)
    obs_kf: jax.Array     # (O,) int32 keyframe index
    obs_lm: jax.Array     # (O,) int32 landmark index
    obs_uv: jax.Array     # (O, 4, 2) float32 observed corners (pixels)
    obs_valid: jax.Array  # (O,) bool
    # calibration
    K: jax.Array          # (3, 3) intrinsics
    tag_size: jax.Array   # () float32


def _project(K, pts_cam):
    z = jnp.maximum(pts_cam[..., 2:3], 1e-6)
    uv = pts_cam[..., :2] / z
    return jnp.stack([K[0, 0] * uv[..., 0] + K[0, 2],
                      K[1, 1] * uv[..., 1] + K[1, 2]], -1)


def _obs_residual(cam_inc, lm_inc, cam_R, cam_t, lm_R, lm_t, uv, K, tag_size):
    """8-dim reprojection residual for one observation, as a function of the
    se(3) increments (linearization point at zero)."""
    dRc, dtc = se3_exp(cam_inc)
    dRl, dtl = se3_exp(lm_inc)
    Rc = _mm(cam_R, dRc)
    tc = cam_t + _mm(cam_R, dtc)
    Rl = _mm(lm_R, dRl)
    tl = lm_t + _mm(lm_R, dtl)
    corners_tag = jnp.concatenate(
        [jnp.asarray(TAG_CORNERS) * tag_size * 0.5, jnp.zeros((4, 1))], -1)
    p_w = _mm(corners_tag, Rl.T) + tl                  # (4, 3)
    p_c = _mm(p_w - tc, Rc)                            # R_c^T (p - t): (4, 3)
    return (_project(K, p_c) - uv).reshape(8)


def _linearize(p: BAProblem):
    """Per-observation residuals + Jacobians at the current linearization
    point. Returns r (O, 8), Jc (O, 8, 6), Jl (O, 8, 6), masked."""
    cam_R = p.cam_R[p.obs_kf]
    cam_t = p.cam_t[p.obs_kf]
    lm_R = p.lm_R[p.obs_lm]
    lm_t = p.lm_t[p.obs_lm]

    def rfun(ci, li, CR, Ct, LR, Lt, uv):
        return _obs_residual(ci, li, CR, Ct, LR, Lt, uv, p.K, p.tag_size)

    z6 = jnp.zeros(6)
    r = jax.vmap(lambda CR, Ct, LR, Lt, uv: rfun(z6, z6, CR, Ct, LR, Lt, uv))(
        cam_R, cam_t, lm_R, lm_t, p.obs_uv)
    Jc = jax.vmap(lambda CR, Ct, LR, Lt, uv: jax.jacfwd(rfun, 0)(
        z6, z6, CR, Ct, LR, Lt, uv))(cam_R, cam_t, lm_R, lm_t, p.obs_uv)
    Jl = jax.vmap(lambda CR, Ct, LR, Lt, uv: jax.jacfwd(rfun, 1)(
        z6, z6, CR, Ct, LR, Lt, uv))(cam_R, cam_t, lm_R, lm_t, p.obs_uv)
    m = p.obs_valid.astype(r.dtype)
    return r * m[:, None], Jc * m[:, None, None], Jl * m[:, None, None]


def _sparse_terms(p: BAProblem, r, Jc, Jl, damping):
    """Assemble block-diagonal Hcc/Hll, gradients, and PER-OBSERVATION
    W blocks Wo (O, 6, 6). The (K, L, 6, 6) dense cross table of the first
    design is never materialized: at the BASELINE 10k-tag scale it is ~GBs
    and >99% structurally zero, while the observation list is exactly its
    nonzero support (one tag seen once per keyframe)."""
    Kn = p.cam_R.shape[0]
    Ln = p.lm_R.shape[0]
    Hcc = jnp.zeros((Kn, 6, 6)).at[p.obs_kf].add(
        jnp.einsum("oij,oik->ojk", Jc, Jc, precision=_HI))
    gc = jnp.zeros((Kn, 6)).at[p.obs_kf].add(
        jnp.einsum("oij,oi->oj", Jc, r, precision=_HI))
    Hll = jnp.zeros((Ln, 6, 6)).at[p.obs_lm].add(
        jnp.einsum("oij,oik->ojk", Jl, Jl, precision=_HI))
    gl = jnp.zeros((Ln, 6)).at[p.obs_lm].add(
        jnp.einsum("oij,oi->oj", Jl, r, precision=_HI))
    Wo = jnp.einsum("oij,oik->ojk", Jc, Jl, precision=_HI)     # (O, 6, 6)
    eye = jnp.eye(6)
    Hcc = Hcc + damping * eye
    Hll = Hll + damping * eye
    return Hcc, gc, Hll, gl, Wo


_GAUGE = 1e8  # prior stiffness pinning keyframe 0 (gauge freedom)


def _solve_reduced(Hcc_tot, gc_tot, Hll, gl, Wo, obs_kf, obs_lm, *,
                   fix_first_cam: bool, cg_iters: int, axis: str | None = None):
    """Solve the Schur-reduced camera system S dx_c = -b MATRIX-FREE.

    S = blockdiag(Hcc) - W Hll^-1 W^T is only ever applied to vectors:
    every term is a per-observation gather/einsum/scatter over the sparse
    observation list, so cost is O(O) per matvec independent of K*L.
    Solved by preconditioned CG (block-Jacobi: Hcc block inverses).
    With `axis`, the observation-sum terms are psum-reduced across the
    landmark shards (Hcc_tot/gc_tot must already be reduced).

    Returns (dx_c, Hll_inv).
    """
    Kn = Hcc_tot.shape[0]
    Hll_inv = jnp.linalg.inv(Hll)                        # (L, 6, 6) local
    gauge = jnp.zeros((Kn, 6, 6)).at[0].set(_GAUGE * jnp.eye(6)) \
        if fix_first_cam else jnp.zeros((Kn, 6, 6))
    Hcc_g = Hcc_tot + gauge

    def psum(v):
        return jax.lax.psum(v, axis) if axis is not None else v

    def matvec(x):                                        # x (K, 6)
        # W^T x per obs
        y = jnp.einsum("oij,oi->oj", Wo, x[obs_kf], precision=_HI)
        z = jnp.zeros_like(gl).at[obs_lm].add(y)          # (L, 6)
        z = jnp.einsum("lij,lj->li", Hll_inv, z, precision=_HI)
        # W z per obs
        u = jnp.einsum("oij,oj->oi", Wo, z[obs_lm], precision=_HI)
        wsum = psum(jnp.zeros_like(x).at[obs_kf].add(u))  # (K, 6)
        return jnp.einsum("kij,kj->ki", Hcc_g, x, precision=_HI) - wsum

    # b = gc - W Hll^-1 gl
    ygl = jnp.einsum("lij,lj->li", Hll_inv, gl, precision=_HI)
    b = gc_tot - psum(jnp.zeros((Kn, 6)).at[obs_kf].add(
        jnp.einsum("oij,oj->oi", Wo, ygl[obs_lm], precision=_HI)))

    Minv = jnp.linalg.inv(Hcc_g)                          # block-Jacobi

    def precond(x):
        return jnp.einsum("kij,kj->ki", Minv, x, precision=_HI)

    dx_c, _ = jax.scipy.sparse.linalg.cg(matvec, -b, M=precond,
                                         maxiter=cg_iters, tol=1e-10)
    return dx_c, Hll_inv


def _apply_step(p: BAProblem, dx_c, dx_l) -> BAProblem:
    dRc, dtc = se3_exp(dx_c)
    dRl, dtl = se3_exp(dx_l)
    return p._replace(
        cam_R=jnp.einsum("kij,kjm->kim", p.cam_R, dRc, precision=_HI),
        cam_t=p.cam_t + jnp.einsum("kij,kj->ki", p.cam_R, dtc, precision=_HI),
        lm_R=jnp.einsum("lij,ljm->lim", p.lm_R, dRl, precision=_HI),
        lm_t=p.lm_t + jnp.einsum("lij,lj->li", p.lm_R, dtl, precision=_HI),
    )


def _back_substitute(Hll_inv, gl, Wo, obs_lm, obs_kf, dx_c):
    """Hll dx_l = -gl - W^T dx_c, per-observation scatter (local shard)."""
    y = jnp.einsum("oij,oi->oj", Wo, dx_c[obs_kf], precision=_HI)  # (O, 6)
    rhs = -gl - jnp.zeros_like(gl).at[obs_lm].add(y)
    return jnp.einsum("lij,lj->li", Hll_inv, rhs, precision=_HI)


def gauss_newton_step(p: BAProblem, damping: float = 1e-4,
                      fix_first_cam: bool = True, cg_iters: int = 64
                      ) -> tuple[BAProblem, jax.Array]:
    """One damped GN step with matrix-free Schur elimination."""
    r, Jc, Jl = _linearize(p)
    Hcc, gc, Hll, gl, Wo = _sparse_terms(p, r, Jc, Jl, damping)
    dx_c, Hll_inv = _solve_reduced(Hcc, gc, Hll, gl, Wo, p.obs_kf, p.obs_lm,
                                   fix_first_cam=fix_first_cam,
                                   cg_iters=cg_iters)
    dx_l = _back_substitute(Hll_inv, gl, Wo, p.obs_lm, p.obs_kf, dx_c)
    new = _apply_step(p, dx_c, dx_l)
    nobs = jnp.maximum(jnp.sum(p.obs_valid), 1)
    rms = jnp.sqrt(jnp.sum(r * r) / (8.0 * nobs))
    return new, rms


def solve(p: BAProblem, iters: int = 10, damping: float = 1e-4) -> tuple[BAProblem, jax.Array]:
    """Run `iters` GN steps (static unroll via scan)."""
    def body(carry, _):
        prob = carry
        prob, rms = gauss_newton_step(prob, damping)
        return prob, rms

    p, rms_hist = jax.lax.scan(body, p, None, length=iters)
    return p, rms_hist
