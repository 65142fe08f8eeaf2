"""Sort-based component resolution: labels -> gated dense component ids.

Replaces three per-pixel passes of a jump-based CCL with one sort-centric
stage: the CCL pointer-jump gathers (`label = label[label]` over the whole
image), `component_sizes` (a full-image scatter-add) and the dense relabel
gather inside cluster extraction.

The idea: a scan-only CCL (ops/ccl.two_phase_ccl) leaves each pixel's label
pointing at SOME pixel of its component, with short parent chains
(label[label[...]] strictly decreases to the component's min flat index).
Chains are resolved here on the COMPACTED set of distinct labels — tens of
thousands, not half a million — where the gathers are small. All
full-image work is sorts and scans.

Pipeline:
  1. sort pixels by label (invalid pixels carry a sentinel key and sink to
     the end); group starts mark the distinct labels;
  2. a second sort compacts the group-start positions into a static
     (max_components,) table: D_k = k-th distinct label, P_k = its position
     in the sorted pixel stream, cnt_k = pixels holding it directly;
  3. chain resolution: par_k = flat_label[D_k], then `chain_steps` pointer
     DOUBLINGS of the compacted map (each an (R,)-gather; depth 2^steps).
     Labels strictly decrease along chains, so the fixpoint is the
     component's min flat index — the label a fully-converged CCL (the XLA
     oracle with pointer jumps) assigns. (Spatially under-converged SPLITS
     — two sub-regions with no pointer path, only possible in sprawling
     percolation-noise components — are NOT merged here; tag-sized
     components converge inside the scan rounds, and detection only needs
     labels CONSISTENT within each tag border, not globally equal to the
     oracle's: tests/test_resolve.py asserts detection-level parity on
     noisy scenes);
  4. component sizes: segmented-sum of cnt_k grouped by root (one tiny
     sort); AprilTag's component-area gate (>= min_component_pixels) and
     the dense ranking of eligible roots happen here — the rank order
     (ascending root flat index) is that of a plain gather-based relabel;
  5. the dense id is broadcast back to pixels with a seed-scatter at the
     P_k positions + ONE plain cummax over (group rank << 16 | id+1) —
     the rank high bits make group boundaries implicit, so no segmented
     pair-scan is needed — then un-sorted to image order with one final
     sort.

The reference hides its equivalent (union-find inside cuAprilTags/VPI
binaries) behind closed calls (ref: isaac_ros_apriltag/src/
apriltag_node.cpp:491-493, :290-293).

The R-length table passes (par gather, inv scatter, seed scatter) are kept
over sort-joins on the pixel stream: an (N+R)-element multi-operand sort
per pass was the costlier form where it was tried (chosen on the earlier
accelerator; not measured on the H100).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

_KBITS = 15                  # dense component ids: [0, 2^15); pair key fits int32
_KMAX = (1 << _KBITS) - 1    # sentinel dense id for ineligible components


def _seg_scan(vals, first, op):
    """Inclusive segmented associative scan along axis 0.

    first: (E, 1) bool — True starts a new segment. op combines values
    within a segment (segmented-scan semiring: a segment-start on the right
    wins outright)."""
    def comb(a, b):
        va, fa = a
        vb, fb = b
        return jnp.where(fb, vb, op(va, vb)), fa | fb

    out, _ = jax.lax.associative_scan(comb, (vals, first), axis=0)
    return out


class ResolvedComponents(NamedTuple):
    dense: jax.Array        # (H, W) int32 in [0, _KMAX]; _KMAX = gated out
    n_eligible: jax.Array   # () int32 components passing the area gate
    overflow: jax.Array     # () bool — a static capacity was exceeded
    converged: jax.Array    # () bool — parent chains fully resolved
    roots: jax.Array | None  # (H, W) int32 min-flat-index root per pixel
    #   (only when with_roots=True; equals a fully-converged CCL labeling)


def resolve_components(label: jax.Array, valid: jax.Array, *,
                       min_component_pixels: int,
                       max_components: int = 1 << 16,
                       chain_steps: int = 4,
                       with_roots: bool = False,
                       rank_table: jax.Array | None = None
                       ) -> ResolvedComponents:
    """(H, W) CCL labels + validity mask -> area-gated dense component ids.

    `label` must satisfy the scan-CCL invariants: label[p] is the flat index
    of a pixel in p's component with label[p] <= p, and repeated application
    reaches a chain fixpoint (`chain_steps` pointer doublings resolve chains
    up to depth 2^chain_steps — `converged` reports whether that sufficed).

    With `rank_table` (shape (R,), from resolve_roots_rank), `label` is in
    COMPACTED-RANK space instead: label[p] is a rank r with rank_table[r]
    the flat index of a pixel in p's component, ranks ascending in root
    flat index. Chains then resolve through 256 KB rank-sized tables
    instead of the 2 MB flat-label tables (the vmap-batched scatter/gather
    cost center under vmap), and the resulting dense ids are
    IDENTICAL to the flat-space form (the rank map is order-isomorphic).
    """
    H, W = label.shape
    N = H * W
    R = min(max_components, N)
    if R > (1 << 16):
        # The packed-cummax broadcast carries the group rank in 16 high
        # bits; groups ranked past 2^16 would silently share high bits and
        # leak a neighbor's dense id across the boundary (overflow could
        # stay False since n_groups <= R). DetectorConfig enforces the same
        # bound; this guards direct callers.
        raise ValueError("max_components must be <= 65536")
    if rank_table is not None:
        if with_roots:
            raise ValueError("with_roots is unsupported in rank-space mode")
        if rank_table.shape[0] != R:
            raise ValueError("rank_table capacity mismatch: "
                             f"{rank_table.shape[0]} != {R}")
    # Sentinel label value: one past the largest possible label.
    SENT = R if rank_table is not None else N
    flat = label.reshape(-1)
    vflat = valid.reshape(-1)
    idx = jnp.arange(N, dtype=jnp.int32)

    # --- sort 1: pixels grouped by label; invalid sink to the end ----------
    # (Rank mode: over-capacity pixels already carry rank R == SENT and
    # sink with the invalid.)
    key = jnp.where(vflat, flat, SENT)
    lab_s, idx_s = jax.lax.sort((key, idx), num_keys=1)
    prev = jnp.concatenate([jnp.full((1,), -1, jnp.int32), lab_s[:-1]])
    bnd = lab_s != prev                 # segment boundary (incl. invalid tail)
    vs = lab_s != SENT
    first = vs & bnd                    # start of a distinct VALID label group
    rank = jnp.cumsum(first.astype(jnp.int32)) - 1
    n_groups = rank[-1] + 1
    n_valid_pix = jnp.sum(vs.astype(jnp.int32))

    # --- compact group starts into the (R,) table --------------------------
    ckey = jnp.where(first, rank, N)
    _, P, D = jax.lax.sort((ckey, idx, lab_s), num_keys=1)
    P, D = P[:R], D[:R]
    ks = jnp.arange(R, dtype=jnp.int32)
    kvalid = ks < n_groups
    D = jnp.where(kvalid, D, SENT)
    nxt = jnp.concatenate([P[1:], jnp.zeros((1,), jnp.int32)])
    nxt = jnp.where(ks == n_groups - 1, n_valid_pix, nxt)
    cnt = jnp.where(kvalid, nxt - P, 0)

    # --- chain resolution on the compacted labels (pointer DOUBLING) -------
    # Measured chain depth after 16 scan rounds on noisy scenes: up to ~14.
    # Composing the compacted parent map with itself halves the remaining
    # depth per step, so `chain_steps` doublings resolve depth 2^chain_steps
    # with one (R,)-gather per step. flatp[SENT] == SENT keeps sentinels
    # fixed.
    # NB: do NOT pass indices_are_sorted/unique_indices hints here. They
    # hold per frame, but under vmap the batched scatter/gather sees the
    # hint on the COMBINED index set, where it is false.
    flatp = jnp.concatenate([flat, jnp.full((1,), SENT, jnp.int32)])
    if rank_table is not None:
        # parent of rank group v = the (post-scan) rank label AT v's root
        # pixel rank_table[v]: two R-length gathers, both through rank-sized
        # or label tables.
        D_u = jnp.where(kvalid, D, (R + 1) + ks)     # unique; pads OOB
        Tp = jnp.concatenate([rank_table, jnp.full((1,), N, jnp.int32)])
        root_pix = Tp.at[D_u].get(mode="fill", fill_value=N)
        par = flatp.at[root_pix].get(mode="fill", fill_value=SENT)
        inv = (jnp.full((R + 2,), R, jnp.int32)
               .at[D_u].set(ks)[:R + 1])
    else:
        D_u = jnp.where(kvalid, D, (N + 1) + ks)     # unique, ascending; pads OOB
        par = flatp.at[D_u].get(mode="fill", fill_value=N)
        # inv: label value -> compacted index; sentinel labels -> self-looping
        # extra slot R. (Invalid slots' pad indices fall out of bounds -> drop.)
        inv = (jnp.full((N + 2,), R, jnp.int32)
               .at[D_u].set(ks)[:N + 1])
    parx = jnp.concatenate([inv[par], jnp.full((1,), R, jnp.int32)])
    prev = parx
    for _ in range(max(chain_steps, 1)):
        prev = parx
        parx = parx[parx]
    converged = jnp.all(parx == prev)
    Dx = jnp.concatenate([D, jnp.full((1,), SENT, jnp.int32)])
    root = jnp.where(kvalid, Dx[parx[:R]], SENT)

    # --- component sizes + area gate + dense ranking (root order) ----------
    rkey, rcnt, korder = jax.lax.sort((root, cnt, ks), num_keys=1)
    rprev = jnp.concatenate([jnp.full((1,), -1, jnp.int32), rkey[:-1]])
    rfirst = rkey != rprev
    run = _seg_scan(rcnt[:, None], rfirst[:, None], lambda a, b: a + b)[:, 0]
    nxt_first = jnp.concatenate([rfirst[1:], jnp.ones((1,), bool)])
    tot_at_last = jnp.where(nxt_first, run, 0)
    size_m = jnp.flip(_seg_scan(jnp.flip(tot_at_last)[:, None],
                                jnp.flip(nxt_first)[:, None],
                                lambda a, b: a), 0)[:, 0]
    eligible = (rkey != SENT) & (size_m >= min_component_pixels)
    new_comp = rfirst & eligible
    crank = jnp.cumsum(new_comp.astype(jnp.int32)) - 1
    n_eligible = crank[-1] + 1
    dense_m = jnp.where(eligible & (crank < _KMAX), crank, _KMAX)
    # back to k-order (one small sort); carry the root for with_roots
    _, dense_k, root_k = jax.lax.sort((korder, dense_m, rkey), num_keys=1)

    # --- broadcast to pixels: seed at P, packed cummax, un-sort ------------
    # Group-forward copy WITHOUT a segmented pair-scan: pack (group rank,
    # seeded value+1) into one uint32 whose high bits are the rank — a plain
    # cummax then carries each group's seed to its members (later groups
    # always win on the high bits), and unseeded positions read 0 low bits.
    # P is ascending+unique (group starts in sorted order); pad slots use
    # out-of-bounds indices, which scatter-drop. rank clamps to 16 bits:
    # groups past R are unseeded -> _KMAX regardless.
    seedpos = jnp.where(kvalid, P, (N + 1) + ks)
    rank16 = jnp.minimum(rank, (1 << 16) - 1).astype(jnp.uint32) << 16
    seed_d = (jnp.zeros((N + 1,), jnp.uint32)
              .at[seedpos].set((dense_k + 1).astype(jnp.uint32))[:N])
    carry_d = jax.lax.cummax(rank16 | seed_d) & jnp.uint32(0xFFFF)
    dense_sorted = jnp.where(vs & (carry_d > 0),
                             carry_d.astype(jnp.int32) - 1, _KMAX)
    if with_roots:
        # root values need up to 22 bits (N < 2^22 per the 2047x2047 image
        # guard): broadcast as two 11-bit chunks, each packed under the
        # 16-bit rank (rank<<12 | chunk+1 < 2^28).
        rank12 = jnp.minimum(rank, (1 << 16) - 1).astype(jnp.uint32) << 12
        rv = jnp.where(root_k >= 0, root_k, -1)
        chunks = []
        for shift in (0, 11):
            sd = (jnp.zeros((N + 1,), jnp.uint32)
                  .at[seedpos].set((((rv >> shift) & 0x7FF) + 1)
                                   .astype(jnp.uint32)
                                   * (rv >= 0).astype(jnp.uint32))[:N])
            chunks.append(jax.lax.cummax(rank12 | sd) & jnp.uint32(0xFFF))
        lo, hi = chunks
        seeded = (lo > 0) & (hi > 0)
        root_sorted = jnp.where(
            seeded, ((hi.astype(jnp.int32) - 1) << 11)
            | (lo.astype(jnp.int32) - 1), -1)
        _, dense_flat, root_flat = jax.lax.sort(
            (idx_s, dense_sorted, root_sorted), num_keys=1)
        # invalid / overflowed pixels keep their incoming label as root
        roots = jnp.where(valid & (root_flat.reshape(H, W) >= 0),
                          root_flat.reshape(H, W), label)
    else:
        _, dense_flat = jax.lax.sort((idx_s, dense_sorted), num_keys=1)
        roots = None

    overflow = (n_groups > R) | (n_eligible > _KMAX)
    return ResolvedComponents(dense=dense_flat.reshape(H, W),
                              n_eligible=n_eligible, overflow=overflow,
                              converged=converged, roots=roots)


def resolve_roots(label: jax.Array, valid: jax.Array, *,
                  max_components: int = 1 << 16,
                  chain_steps: int = 5) -> jax.Array:
    """(H, W) labels -> (H, W) chain-root labels (the contraction step).

    The compacted-cost equivalent of full-image pointer jumping: every
    pixel's label is replaced by its chain FIXPOINT, so a following scan
    phase propagates mins across formerly-split constant-label regions in
    O(region count) rounds. Used between the two scan phases of the
    production CCL in flat-label space (ops/ccl.two_phase_ccl uses the
    rank-space form, resolve_roots_rank) — the role full-image pointer
    jumps play in the oracle. Invalid/overflowed pixels keep their
    incoming label.
    """
    H, W = label.shape
    N = H * W
    R = min(max_components, N)
    if R > (1 << 16):
        raise ValueError("max_components must be <= 65536 "
                         "(16-bit group ranks in the packed broadcast)")
    flat = label.reshape(-1)
    idx = jnp.arange(N, dtype=jnp.int32)

    key = jnp.where(valid.reshape(-1), flat, N)
    lab_s, idx_s = jax.lax.sort((key, idx), num_keys=1)
    prev = jnp.concatenate([jnp.full((1,), -1, jnp.int32), lab_s[:-1]])
    bnd = lab_s != prev
    first = (lab_s != N) & bnd
    rank = jnp.cumsum(first.astype(jnp.int32)) - 1
    n_groups = rank[-1] + 1

    ckey = jnp.where(first, rank, N)
    _, P, D = jax.lax.sort((ckey, idx, lab_s), num_keys=1)
    P, D = P[:R], D[:R]
    ks = jnp.arange(R, dtype=jnp.int32)
    kvalid = ks < n_groups
    D = jnp.where(kvalid, D, N)

    flatp = jnp.concatenate([flat, jnp.full((1,), N, jnp.int32)])
    D_u = jnp.where(kvalid, D, (N + 1) + ks)
    par = flatp.at[D_u].get(mode="fill", fill_value=N)
    inv = (jnp.full((N + 2,), R, jnp.int32)
           .at[D_u].set(ks)[:N + 1])
    parx = jnp.concatenate([inv[par], jnp.full((1,), R, jnp.int32)])
    for _ in range(max(chain_steps, 1)):
        parx = parx[parx]
    Dx = jnp.concatenate([D, jnp.full((1,), N, jnp.int32)])
    root_k = jnp.where(kvalid, Dx[parx[:R]], -1)

    # Broadcast roots by packed cummax (see resolve_components): up-to-22-bit
    # root values ride as two 11-bit chunks under the 16-bit group rank.
    seedpos = jnp.where(kvalid, P, (N + 1) + ks)
    rank12 = jnp.minimum(rank, (1 << 16) - 1).astype(jnp.uint32) << 12
    chunks = []
    for shift in (0, 11):
        sd = (jnp.zeros((N + 1,), jnp.uint32)
              .at[seedpos].set((((root_k >> shift) & 0x7FF) + 1)
                               .astype(jnp.uint32)
                               * (root_k >= 0).astype(jnp.uint32))[:N])
        chunks.append(jax.lax.cummax(rank12 | sd) & jnp.uint32(0xFFF))
    lo, hi = chunks
    bcast = jnp.where((lo > 0) & (hi > 0),
                      ((hi.astype(jnp.int32) - 1) << 11)
                      | (lo.astype(jnp.int32) - 1), -1)
    _, root_flat = jax.lax.sort((idx_s, bcast), num_keys=1)
    roots = root_flat.reshape(H, W)
    return jnp.where(valid & (roots >= 0), roots, label)


def resolve_roots_rank(label: jax.Array, valid: jax.Array, *,
                       max_components: int = 1 << 16,
                       chain_steps: int = 5
                       ) -> tuple[jax.Array, jax.Array, jax.Array]:
    """(H, W) labels -> (rank_img, rank_table, overflowed): the contraction
    step in COMPACTED-RANK space.

    rank_img[p] = the compacted index ("rank") of p's chain-fixpoint label;
    rank_table[r] = that rank's label value — the root's flat pixel index,
    ASCENDING in r, so ranks are order-isomorphic to root flat indices and
    min-propagation over ranks (a following opaque-mode scan phase) is
    bit-isomorphic to propagation over root labels. resolve_components
    consumes the result via its rank_table parameter and produces dense ids
    IDENTICAL to the flat-space two-phase flow.

    Why rank space: ranks fit 16 bits, so the pixel broadcast is ONE packed
    cummax (16-bit group rank | 16-bit root rank) instead of resolve_roots'
    two 11-bit root chunks, and the downstream resolve's chain tables are
    R-sized (256 KB) instead of N-sized (2 MB).

    Invalid pixels and pixels of over-capacity groups (rank >= R — only
    under extreme percolation noise) get rank R, the rank-space sentinel:
    they are DROPPED from detection rather than kept as raw labels, and
    `overflowed` (n_groups > R) reports it to FrameStats.
    """
    H, W = label.shape
    N = H * W
    R = min(max_components, N)
    if R > (1 << 16):
        raise ValueError("max_components must be <= 65536 "
                         "(16-bit ranks in the packed broadcast)")
    flat = label.reshape(-1)
    idx = jnp.arange(N, dtype=jnp.int32)

    key = jnp.where(valid.reshape(-1), flat, N)
    lab_s, idx_s = jax.lax.sort((key, idx), num_keys=1)
    prev = jnp.concatenate([jnp.full((1,), -1, jnp.int32), lab_s[:-1]])
    vs = lab_s != N
    first = vs & (lab_s != prev)
    rank = jnp.cumsum(first.astype(jnp.int32)) - 1
    n_groups = rank[-1] + 1

    ckey = jnp.where(first, rank, N)
    _, P, D = jax.lax.sort((ckey, idx, lab_s), num_keys=1)
    P, D = P[:R], D[:R]
    ks = jnp.arange(R, dtype=jnp.int32)
    kvalid = ks < n_groups
    D = jnp.where(kvalid, D, N)

    flatp = jnp.concatenate([flat, jnp.full((1,), N, jnp.int32)])
    D_u = jnp.where(kvalid, D, (N + 1) + ks)
    par = flatp.at[D_u].get(mode="fill", fill_value=N)
    inv = (jnp.full((N + 2,), R, jnp.int32)
           .at[D_u].set(ks)[:N + 1])
    parx = jnp.concatenate([inv[par], jnp.full((1,), R, jnp.int32)])
    for _ in range(max(chain_steps, 1)):
        parx = parx[parx]
    root_rank = parx[:R]                     # fixpoint's compacted index

    # ONE-chunk broadcast: group rank (16 high bits) | root rank (16 low).
    # No +1 disambiguation is needed: every in-capacity group (rank < R) is
    # seeded at its OWN start position, so its members' cummax low bits are
    # exactly its seed; clamped groups (rank >= R) sort after all seeded
    # groups and are masked to R below.
    seedpos = jnp.where(kvalid, P, (N + 1) + ks)
    rank16 = jnp.minimum(rank, (1 << 16) - 1).astype(jnp.uint32) << 16
    seed = (jnp.zeros((N + 1,), jnp.uint32)
            .at[seedpos].set(root_rank.astype(jnp.uint32))[:N])
    carried = (jax.lax.cummax(rank16 | seed) & jnp.uint32(0xFFFF)
               ).astype(jnp.int32)
    rank_sorted = jnp.where(vs & (rank < R), carried, R)
    _, rank_flat = jax.lax.sort((idx_s, rank_sorted), num_keys=1)
    rank_img = jnp.where(valid, rank_flat.reshape(H, W), R)
    return rank_img, D, n_groups > R
