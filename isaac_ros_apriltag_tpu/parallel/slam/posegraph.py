"""Pose-graph optimization over keyframe poses (SE(3) relative-pose factors).

Complements ba.py for loop-closure style corrections: nodes are keyframe
poses, edges are relative transforms (e.g. from tag co-observation). Dense
damped Gauss-Newton — the keyframe count is small (<=256), so the 6K x 6K
normal system is a single dense solve.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ...utils.geometry import se3_exp

# Every f32 contraction is pinned: a default-precision f32 dot may round its
# operands (to TF32 on the GPU).
_HI = jax.lax.Precision.HIGHEST


def _mm(a, b):
    return jnp.matmul(a, b, precision=_HI)


class PoseGraph(NamedTuple):
    R: jax.Array          # (K, 3, 3) node rotations R_world_node
    t: jax.Array          # (K, 3)
    edge_i: jax.Array     # (E,) int32
    edge_j: jax.Array     # (E,) int32
    edge_R: jax.Array     # (E, 3, 3) measured R_i_j
    edge_t: jax.Array     # (E, 3) measured t_i_j
    edge_valid: jax.Array  # (E,) bool


def _log_so3(R):
    """SO(3) log map (..., 3, 3) -> (..., 3), safe near identity."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos = jnp.clip((tr - 1.0) * 0.5, -1.0, 1.0)
    theta = jnp.arccos(cos)
    w = jnp.stack([R[..., 2, 1] - R[..., 1, 2],
                   R[..., 0, 2] - R[..., 2, 0],
                   R[..., 1, 0] - R[..., 0, 1]], -1)
    s = jnp.where(theta < 1e-6, 0.5, theta / (2.0 * jnp.sin(jnp.maximum(theta, 1e-6))))
    return w * s[..., None]


def _edge_residual(xi, xj, Ri, ti, Rj, tj, Rm, tm):
    """12 -> 6 residual: log( (T_i dXi)^-1 (T_j dXj) ) - measurement."""
    dRi, dti = se3_exp(xi)
    dRj, dtj = se3_exp(xj)
    Ri2 = _mm(Ri, dRi)
    ti2 = ti + _mm(Ri, dti)
    Rj2 = _mm(Rj, dRj)
    tj2 = tj + _mm(Rj, dtj)
    Rij = _mm(Ri2.T, Rj2)
    tij = _mm(Ri2.T, tj2 - ti2)
    r_rot = _log_so3(_mm(Rm.T, Rij))
    r_t = tij - tm
    return jnp.concatenate([r_rot, r_t])


def gauss_newton_step(g: PoseGraph, damping: float = 1e-6):
    Ri = g.R[g.edge_i]
    ti = g.t[g.edge_i]
    Rj = g.R[g.edge_j]
    tj = g.t[g.edge_j]
    z6 = jnp.zeros(6)

    r = jax.vmap(lambda a, b, c, d, e, f: _edge_residual(z6, z6, a, b, c, d, e, f))(
        Ri, ti, Rj, tj, g.edge_R, g.edge_t)
    Ji = jax.vmap(lambda a, b, c, d, e, f: jax.jacfwd(_edge_residual, 0)(
        z6, z6, a, b, c, d, e, f))(Ri, ti, Rj, tj, g.edge_R, g.edge_t)
    Jj = jax.vmap(lambda a, b, c, d, e, f: jax.jacfwd(_edge_residual, 1)(
        z6, z6, a, b, c, d, e, f))(Ri, ti, Rj, tj, g.edge_R, g.edge_t)
    m = g.edge_valid.astype(r.dtype)
    r = r * m[:, None]
    Ji = Ji * m[:, None, None]
    Jj = Jj * m[:, None, None]

    Kn = g.R.shape[0]
    H = jnp.zeros((Kn, 6, Kn, 6))
    def JtJ(A, B):
        return jnp.einsum("eij,eik->ejk", A, B, precision=_HI)

    H = H.at[g.edge_i, :, g.edge_i, :].add(JtJ(Ji, Ji))
    H = H.at[g.edge_j, :, g.edge_j, :].add(JtJ(Jj, Jj))
    H = H.at[g.edge_i, :, g.edge_j, :].add(JtJ(Ji, Jj))
    H = H.at[g.edge_j, :, g.edge_i, :].add(JtJ(Jj, Ji))
    b = jnp.zeros((Kn, 6))
    b = b.at[g.edge_i].add(jnp.einsum("eij,ei->ej", Ji, r, precision=_HI))
    b = b.at[g.edge_j].add(jnp.einsum("eij,ei->ej", Jj, r, precision=_HI))

    H = H.at[jnp.arange(Kn), :, jnp.arange(Kn), :].add(damping * jnp.eye(6))
    # gauge: pin node 0
    H = H.at[0, :, 0, :].add(1e8 * jnp.eye(6))

    dx = jnp.linalg.solve(H.reshape(Kn * 6, Kn * 6), -b.reshape(Kn * 6)).reshape(Kn, 6)
    dR, dt = se3_exp(dx)
    new = g._replace(R=jnp.einsum("kij,kjm->kim", g.R, dR, precision=_HI),
                     t=g.t + jnp.einsum("kij,kj->ki", g.R, dt, precision=_HI))
    nedge = jnp.maximum(jnp.sum(g.edge_valid), 1)
    rms = jnp.sqrt(jnp.sum(r * r) / (6.0 * nedge))
    return new, rms


def solve(g: PoseGraph, iters: int = 10, damping: float = 1e-6):
    out, rms = jax.lax.scan(lambda c, _: gauss_newton_step(c, damping), g,
                            None, length=iters)
    return out, rms
