"""Distributed bundle adjustment: landmark shards + Schur reduction via psum.

The BASELINE.json north-star component: tag landmarks and their observations
are partitioned into map blocks across the mesh 'map' axis; each device
linearizes only its local factors, computes its additive contribution to the
reduced camera system (Schur complement), and a single psum over the mesh
reduces the 6K x 6K system, which every device then solves redundantly (it is
tiny) before back-substituting its local landmarks. Camera states are
replicated; landmark states and observations are sharded.

Observation partitioning invariant: every observation must live on the shard
that owns its landmark (obs_lm indexes LOCAL landmark slots). The frontend
partitions by landmark id hash; partition_problem() below does it for tests.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .ba import (BAProblem, _apply_step, _back_substitute, _linearize,
                 _solve_reduced, _sparse_terms)


def _local_step(p: BAProblem, damping, axis: str, cg_iters: int = 64):
    """Runs inside shard_map: p has LOCAL landmarks/observations,
    REPLICATED cameras. The reduced camera system is solved matrix-free
    (ba._solve_reduced): every CG matvec's observation sum is psum-reduced
    over the landmark shards, so nothing larger than (K, 6) ever crosses
    the mesh and no shard materializes a (K, L) coupling table."""
    r, Jc, Jl = _linearize(p)
    Hcc, gc, Hll, gl, Wo = _sparse_terms(p, r, Jc, Jl, damping)

    # Hcc/gc accumulate per-shard (every obs contributes) -> psum.
    # NB damping*I was added per shard; renormalize after psum.
    nshards = jax.lax.psum(1, axis)
    extra = (nshards - 1) * damping
    Hcc_sum = jax.lax.psum(Hcc, axis) - extra * jnp.eye(6)
    gc_sum = jax.lax.psum(gc, axis)

    dx_c, Hll_inv = _solve_reduced(Hcc_sum, gc_sum, Hll, gl, Wo,
                                   p.obs_kf, p.obs_lm, fix_first_cam=True,
                                   cg_iters=cg_iters, axis=axis)
    dx_l = _back_substitute(Hll_inv, gl, Wo, p.obs_lm, p.obs_kf, dx_c)
    new = _apply_step(p, dx_c, dx_l)
    nobs = jnp.maximum(jax.lax.psum(jnp.sum(p.obs_valid), axis), 1)
    rms = jnp.sqrt(jax.lax.psum(jnp.sum(r * r), axis) / (8.0 * nobs))
    return new, rms


def make_distributed_solver(mesh: Mesh, iters: int = 10, damping: float = 1e-4,
                            axis: str = "map"):
    """Build a jitted sharded BA solver for `mesh`.

    Input BAProblem must be device-put with `problem_shardings(mesh)`.
    """
    pspec = _problem_pspecs(axis)

    def step_n(p: BAProblem):
        def body(carry, _):
            new, rms = _local_step(carry, damping, axis)
            return new, rms
        return jax.lax.scan(body, p, None, length=iters)

    sharded = jax.shard_map(step_n, mesh=mesh, in_specs=(pspec,),
                            out_specs=(pspec, P()), check_vma=False)
    return jax.jit(sharded)


def _problem_pspecs(axis: str = "map") -> BAProblem:
    return BAProblem(
        cam_R=P(), cam_t=P(),
        lm_R=P(axis), lm_t=P(axis),
        obs_kf=P(axis), obs_lm=P(axis), obs_uv=P(axis), obs_valid=P(axis),
        K=P(), tag_size=P(),
    )


def problem_shardings(mesh: Mesh, axis: str = "map") -> BAProblem:
    return jax.tree.map(lambda s: NamedSharding(mesh, s), _problem_pspecs(axis))


def partition_problem(p: BAProblem, nshards: int) -> BAProblem:
    """Host-side re-layout: pad landmarks/observations to shard multiples and
    re-index observations to (shard-local landmark slots), ordered so that a
    plain equal split over the leading axis respects the ownership invariant.
    """
    Ln = p.lm_R.shape[0]
    O = p.obs_kf.shape[0]
    Lpad = -(-Ln // nshards) * nshards
    per_shard_L = Lpad // nshards

    lm_R = np.zeros((Lpad, 3, 3), np.float32)
    lm_R[:, ] = np.eye(3)
    lm_R[:Ln] = np.asarray(p.lm_R)
    lm_t = np.zeros((Lpad, 3), np.float32)
    lm_t[:Ln] = np.asarray(p.lm_t)

    obs_kf = np.asarray(p.obs_kf)
    obs_lm = np.asarray(p.obs_lm)
    obs_uv = np.asarray(p.obs_uv)
    obs_valid = np.asarray(p.obs_valid)

    # landmark l lives on shard l // per_shard_L (contiguous blocks)
    owner = obs_lm // per_shard_L
    per_shard_O = int(max((np.bincount(owner[obs_valid], minlength=nshards)).max()
                          if obs_valid.any() else 1, 1))
    kf2 = np.zeros((nshards, per_shard_O), np.int32)
    lm2 = np.zeros((nshards, per_shard_O), np.int32)
    uv2 = np.zeros((nshards, per_shard_O, 4, 2), np.float32)
    va2 = np.zeros((nshards, per_shard_O), bool)
    fill = np.zeros(nshards, np.int32)
    for o in range(O):
        if not obs_valid[o]:
            continue
        s = int(owner[o])
        i = int(fill[s])
        kf2[s, i] = obs_kf[o]
        lm2[s, i] = obs_lm[o] % per_shard_L  # local slot
        uv2[s, i] = obs_uv[o]
        va2[s, i] = True
        fill[s] += 1
    return p._replace(
        lm_R=jnp.asarray(lm_R), lm_t=jnp.asarray(lm_t),
        obs_kf=jnp.asarray(kf2.reshape(-1)),
        obs_lm=jnp.asarray(lm2.reshape(-1)),
        obs_uv=jnp.asarray(uv2.reshape(-1, 4, 2)),
        obs_valid=jnp.asarray(va2.reshape(-1)),
    )
