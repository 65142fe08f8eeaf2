"""Connected-component labeling on the trinary image.

The reference's backends do this with a union-find CCL inside closed CUDA
kernels. Here CCL is built from dense array primitives that XLA compiles
as they stand, three per round (the scan-based GPU-CCL family; see
PAPERS.md refs — pattern only):

  1. **segmented min-scans** along rows and columns (forward + backward):
     a label propagates across an entire run of same-valued pixels in one
     associative scan, so straight edges converge in one pass and ring/spiral
     components in a handful of alternating rounds (naive neighbor
     propagation needs O(perimeter) rounds — measured failure mode on the
     tag border ring);
  2. one 8-neighbor min-propagation step (diagonal connectivity — applied to
     white pixels only, matching AprilTag 3's rule that keeps adjacent tags'
     black borders from merging diagonally);
  3. **pointer jumping** (label = label[label], a dense gather) to compress
     label chains — the `xla` oracle only.

`rounds` statically bounds the iteration for jit; 4 rounds converge every
scene we generate (rings included), 6 is the safe default.

The production path (`two_phase_ccl`) runs no pointer jumps: a phase of
scan rounds, a chain contraction on the compacted label set
(ops/resolve.resolve_roots_rank), and a short second phase of scan rounds
on the contracted rank labels.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _seg_min_scan(label: jax.Array, boundary: jax.Array, axis: int,
                  reverse: bool) -> jax.Array:
    """Segmented running-min of `label` along `axis`.

    boundary[i] = True means position i does NOT connect to position i-1
    (along scan direction); the running min resets there. Implemented with
    jax.lax.associative_scan over the (min, boundary-or) semiring.
    """
    if reverse:
        label = jnp.flip(label, axis)
        boundary = jnp.flip(boundary, axis)

    def op(a, b):
        m1, f1 = a
        m2, f2 = b
        return jnp.where(f2, m2, jnp.minimum(m1, m2)), f1 | f2

    m, _ = jax.lax.associative_scan(op, (label, boundary), axis=axis)
    if reverse:
        m = jnp.flip(m, axis)
    return m


def _shifted(x: jax.Array, dy: int, dx: int, fill) -> jax.Array:
    """out[y, x] = x[y+dy, x+dx], edges filled with `fill`."""
    out = jnp.roll(x, (-dy, -dx), (0, 1))
    if dy == 1:
        out = out.at[-1, :].set(fill)
    if dy == -1:
        out = out.at[0, :].set(fill)
    if dx == 1:
        out = out.at[:, -1].set(fill)
    if dx == -1:
        out = out.at[:, 0].set(fill)
    return out


_DIAGONALS = ((1, 1), (1, -1), (-1, 1), (-1, -1))


def connected_components(trinary: jax.Array, rounds: int = 6, jumps: int = 2,
                         jump_every: int = 1,
                         label0: jax.Array | None = None,
                         with_convergence: bool = False):
    """(H, W) uint8 trinary {0,127,255} -> (H, W) int32 component labels.

    Valid pixels get the min linear index of their component; 127 pixels keep
    their own index (self-loop singleton, excluded downstream).

    `jumps` pointer-jumping passes run only in rounds where
    (round+1) % jump_every == 0 (jumping is what converges snake-like
    percolation-noise components, but each pass is a full-image gather —
    the most expensive op in the loop — so it is rationed).

    `label0` overrides the initial label field (used by the spatial-sharded
    CCL, whose labels are GLOBAL flat indices and whose shards re-enter this
    function between halo exchanges; jumps must be 0 in that mode — label
    values then point outside the local gather table).

    `with_convergence=True` returns (labels, converged) where `converged`
    is True iff the FINAL round changed nothing — the non-convergence
    telemetry for adversarial scenes where `rounds` is too small (one extra
    elementwise compare; the iteration bound itself stays static).
    """
    if rounds < 1:
        # rounds=0 would otherwise run body(-1, .) after the empty fori_loop
        # on the with_convergence path.
        raise ValueError("rounds must be >= 1")
    H, W = trinary.shape
    idx = (jnp.arange(H * W, dtype=jnp.int32).reshape(H, W)
           if label0 is None else label0)
    valid = trinary != 127

    # Run boundaries: a pixel disconnects from its predecessor when either is
    # invalid or the binary value changes.
    left = _shifted(trinary, 0, -1, jnp.uint8(127))
    up = _shifted(trinary, -1, 0, jnp.uint8(127))
    row_b = (trinary != left) | ~valid
    col_b = (trinary != up) | ~valid
    # reverse-direction boundaries are the forward ones shifted by one
    row_b_rev = _shifted(row_b, 0, 1, True)
    col_b_rev = _shifted(col_b, 1, 0, True)

    # Diagonal connectivity masks (white pixels only), precomputed once.
    diag_conn = []
    for dy, dx in _DIAGONALS:
        nv = _shifted(trinary, dy, dx, jnp.uint8(127))
        diag_conn.append((nv == trinary) & valid & (trinary == 255))
    diag_conn = jnp.stack(diag_conn)

    # Materialize the loop-invariant masks ONCE. Without this barrier XLA
    # recomputation-fuses the whole threshold+boundary chain into every step
    # of every associative scan below (a >1000x slowdown and minutes of
    # compilation when composed with the threshold stage).
    row_b, row_b_rev, col_b, col_b_rev, diag_conn = (
        jax.lax.optimization_barrier(
            (row_b, row_b_rev, col_b, col_b_rev, diag_conn)))

    def body(r, label):
        # Round order: row scans -> diag hop -> col scans -> jumps.
        label = _seg_min_scan(label, row_b, 1, False)
        label = _seg_min_scan(label, row_b_rev, 1, True)
        # one diagonal hop (white only), all neighbors from the pre-hop label
        m = label
        for k, (dy, dx) in enumerate(_DIAGONALS):
            nl = _shifted(label, dy, dx, jnp.int32(H * W))
            m = jnp.minimum(m, jnp.where(diag_conn[k], nl, label))
        label = _seg_min_scan(m, col_b, 0, False)
        label = _seg_min_scan(label, col_b_rev, 0, True)

        def jump(lab):
            flat = lab.reshape(-1)
            for _ in range(jumps):
                flat = flat[flat]
            return flat.reshape(H, W)

        if jumps == 0:
            return label
        return jax.lax.cond((r + 1) % jump_every == 0, jump,
                            lambda lab: lab, label)

    if not with_convergence:
        return jax.lax.fori_loop(0, rounds, body, idx, unroll=False)

    # converged = the FINAL round changed nothing; running rounds-1 in the
    # loop and the last round explicitly costs one compare total instead of
    # one per round.
    label = jax.lax.fori_loop(0, rounds - 1, body, idx, unroll=False)
    new = body(rounds - 1, label)
    return new, ~jnp.any(new != label)


def component_sizes(label: jax.Array) -> jax.Array:
    """(H, W) labels -> (H*W,) int32 size of the component rooted at each index."""
    flat = label.reshape(-1)
    sizes = jnp.zeros(flat.shape, jnp.int32)
    return sizes.at[flat].add(1)


def two_phase_ccl(trinary: jax.Array, phase1_rounds: int, phase2_rounds: int,
                  *, max_components: int, contraction_steps: int):
    """The production CCL: scan rounds -> rank-space contraction -> scan.

    (H, W) uint8 trinary -> (label, converged, rank_table, overflow).
    Phase 1 is `phase1_rounds` jump-free scan rounds on flat-index labels.
    With `phase2_rounds` > 0, ops/resolve.resolve_roots_rank replaces every
    label by the compacted rank of its chain fixpoint (16-bit ranks,
    order-isomorphic to root flat indices) and phase 2 scans those ranks;
    `label` is then in rank space, `rank_table` maps ranks to root flat
    indices and `overflow` flags a contraction over capacity. With
    `phase2_rounds` == 0 both are None and `label` holds flat indices.
    `converged` is True iff the last scan round changed nothing.
    """
    from .resolve import resolve_roots_rank

    label, converged = connected_components(
        trinary, phase1_rounds, jumps=0, with_convergence=True)
    if phase2_rounds == 0:
        return label, converged, None, None
    label = jax.lax.optimization_barrier(label)
    with jax.named_scope("contraction"):
        rank_img, rank_table, overflow = resolve_roots_rank(
            label, trinary != 127, max_components=max_components,
            chain_steps=contraction_steps)
    label, converged = connected_components(
        trinary, phase2_rounds, jumps=0,
        label0=jax.lax.optimization_barrier(rank_img), with_convergence=True)
    return label, converged, rank_table, overflow
