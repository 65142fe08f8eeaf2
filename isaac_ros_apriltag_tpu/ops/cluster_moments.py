"""Sort-centric boundary clustering: trinary+labels -> per-cluster angular
moments.

AprilTag 3 buckets black/white neighbor-pair midpoints by (black component,
white component) key, then fits each cluster's quad from an angular sweep of
its points. Quad fitting only ever consumes ANGULAR-BIN MOMENT SUMS
(ops/quadfit.py), which are order-free reductions — so the clustering stage
is formulated in sorts, plain scans and one-hot matmuls, with no per-pair
gather or scatter (a formulation chosen on the earlier accelerator, whose
per-element gathers serialized; not measured against segment_sum or
scatter-add on the H100).

Pipeline (no per-pair gathers or scatters anywhere):

  1. dense pair generation over 4 neighbor offsets (elementwise) from the
     area-gated dense component image produced by ops/resolve.py (which owns
     AprilTag's component-area gate — load-bearing under sensor noise:
     ungated speckle pairs inflate the stream several fold, drive the
     overflow stride up, and crush real tag clusters into the noise-count
     range; measured 673k vs ~200k pairs at noisy 1080p); on overflow of
     the pair budget E the stream is hash-decimated (uniform spatial
     subsample, not scan-order truncation);
  2. ONE sort of the full pair stream by the packed (black, white) dense-id
     key compacts valid pairs AND groups clusters contiguously;
  3. segment SIZES from positions alone (one reverse cummin: size =
     last_pos - first_pos + 1 — every pair in a segment is valid), feeding
     the top-`max_clusters` selection (one top_k); slot ids broadcast to
     members by one packed cummax. NO E-length moment scans: all moment
     work runs at the E2 budget (~6x smaller);
  4. a SECOND sort by slot id compacts the top-C clusters' pairs to
     E2 = C * max_cluster_points; at E2 every reduction is a one-hot
     matmul: per-cluster stats (centroid, scale, gradient polarity) are
     onehot^T @ fields, per-pair normalization parameters are re-fetched
     by the bit-exact onehot @ table form, and the (cluster, bin) moment
     cells collapse into one factored (C, E2) @ (E2, K*6) contraction —
     no third sort, no segmented scans, exact per-segment sums (off-slot
     products are exact zeros; precision=HIGHEST keeps f32).

The reference runs its equivalent inside closed CUDA binaries (ref:
isaac_ros_apriltag/src/apriltag_node.cpp:491-493, :290-293).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .resolve import _KBITS, _KMAX

_I32MAX = jnp.iinfo(jnp.int32).max
NBINS = 64                   # angular bins (matches ops/quadfit.py)

# Neighbor offsets (dx, dy), matching AprilTag 3's gradient_clusters scan
# (right, down, down-left, down-right).
_OFFSETS = ((1, 0), (0, 1), (-1, 1), (1, 1))


class ClusterMoments(NamedTuple):
    """Per-cluster angular moment tables (inputs to ops.quadfit.fit_quads_from_moments)."""

    # (C, NBINS) float32 per-bin sums over scale-normalized coords (sx, sy):
    bw: jax.Array     # sum of weights (point counts)
    bx: jax.Array     # sum sx
    by: jax.Array     # sum sy
    bxx: jax.Array    # sum sx*sx
    bxy: jax.Array    # sum sx*sy
    byy: jax.Array    # sum sy*sy
    # per-cluster scalars:
    count: jax.Array       # (C,) int32 boundary points (post-decimation)
    centroid: jax.Array    # (C, 2) float32 pixel coords
    scale: jax.Array       # (C,) float32 sqrt(mean r^2) in pixels
    dark_inside: jax.Array  # (C,) bool — quad interior darker than outside
    valid: jax.Array       # (C,) bool — slot holds a gated cluster
    # frame stats:
    num_clusters: jax.Array     # () int32 distinct (black, white) keys kept
    num_eligible: jax.Array     # () int32 segments passing the size gates
    num_edge_points: jax.Array  # () int32 boundary points in frame (pre-cap)
    edge_stride: jax.Array      # () int32 hash-decimation stride (1 = none)
    overflow: jax.Array         # () bool — a capacity was exceeded


def _shift(x: jax.Array, dy: int, dx: int, fill) -> jax.Array:
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


def _diamond_bin(dx: jax.Array, dy: jax.Array, nbins: int) -> jax.Array:
    """Monotone circular angle surrogate -> bin id in [0, nbins).

    Diamond angle t in [0, 4): piecewise-linear in (dx, dy), strictly
    monotone in true angle, no transcendentals. Quad fitting only needs a
    monotone circular parameterization (corners are error maxima; arcs are
    bin ranges), not uniform angular widths.
    """
    ax = jnp.abs(dx)
    ay = jnp.abs(dy)
    denom = jnp.maximum(ax + ay, 1e-12)
    t = jnp.where(dy >= 0,
                  jnp.where(dx >= 0, dy / denom, 1.0 + ax / denom),
                  jnp.where(dx < 0, 2.0 + ay / denom, 3.0 + dx / denom))
    return jnp.clip((t * (nbins / 4.0)).astype(jnp.int32), 0, nbins - 1)


def extract_cluster_moments(trinary: jax.Array, dense: jax.Array, *,
                            comp_overflow: jax.Array, max_edge_points: int,
                            max_clusters: int, min_cluster_pixels: int,
                            max_cluster_points: int = 1024) -> ClusterMoments:
    """trinary + area-gated dense component ids (ops/resolve.py) -> moments."""
    H, W = trinary.shape
    # The compaction slice can never exceed the raw pair-stream length
    # (tiny frames would otherwise mismatch downstream shapes).
    E = min(max_edge_points, 4 * H * W)
    C, K = max_clusters, NBINS
    if not (2 * W < (1 << 12) and 2 * H < (1 << 12)):
        raise ValueError(
            "packed coords support segmentation images up to 2047x2047; "
            f"got {H}x{W} — use quad_decimate for larger frames")

    # --- dense pair generation (4 offsets), elementwise ---------------------
    # Pairs join the stream only when BOTH components carry a dense id, i.e.
    # both passed resolve's area gate (AprilTag 3's same rule).
    key_all, pay_all, m_all = [], [], []
    xs = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    ys = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
    for dx, dy in _OFFSETS:
        v0 = trinary
        v1 = _shift(trinary, dy, dx, jnp.uint8(127))
        pair = (v0.astype(jnp.int32) + v1.astype(jnp.int32)) == 255
        d0, d1 = dense, _shift(dense, dy, dx, jnp.int32(_KMAX))
        p_black = v0 == 0
        db = jnp.where(p_black, d0, d1)
        dw = jnp.where(p_black, d1, d0)
        m = pair & (db != _KMAX) & (dw != _KMAX)
        # doubled coords: midpoint of the pair in half-pixel units; gradient
        # points black -> white along the offset. Packed into one int32.
        sgn = jnp.where(p_black, jnp.int32(1), jnp.int32(-1))
        g = (dx * sgn + 1) | ((dy * sgn + 1) << 2)
        key_all.append(jnp.where(m, (db << _KBITS) | dw, _I32MAX))
        pay_all.append((2 * xs + dx) | ((2 * ys + dy) << 12) | (g << 24))
        m_all.append(m)

    key = jnp.stack(key_all).reshape(-1)
    pay = jnp.stack(pay_all).reshape(-1)
    mask = jnp.stack(m_all).reshape(-1)
    key, pay, mask = jax.lax.optimization_barrier((key, pay, mask))

    # --- overflow decimation (hash gate, uniform spatial subsample) ---------
    # Stride is computed against a 90% budget so hash skew (the keep count is
    # only ~num_edge/stride) cannot push the kept stream past E, where the
    # post-sort [:E] slice would truncate the highest-key segments wholesale.
    num_edge = jnp.sum(mask.astype(jnp.int32))
    budget = (9 * E) // 10
    stride = jnp.maximum((num_edge + budget - 1) // budget, 1)
    # Multiplicative hash, HIGH bits: the low bits of pay*odd are not mixed
    # (bit 0 of the product equals bit 0 of pay = dx!), so `% stride` on the
    # raw product would decimate by edge ORIENTATION, deleting two whole
    # sides of every axis-aligned quad at stride 2.
    pay_hash = ((pay * jnp.int32(-1640531527)) >> 15) & jnp.int32(0xFFFF)
    keep = mask & (pay_hash % stride == 0)

    # --- sort 1: group by (black, white) dense-id pair (single int32 key) ---
    key_s = jnp.where(keep, key, _I32MAX)
    key_s, pay_s = jax.lax.sort((key_s, pay), num_keys=1)
    key_s, pay_s = key_s[:E], pay_s[:E]
    valid = key_s != _I32MAX

    prev_key = jnp.concatenate([jnp.full((1,), -1, jnp.int32), key_s[:-1]])
    first = valid & (key_s != prev_key)
    first1 = first[:, None]

    # --- per-segment counts from POSITIONS (one cummin; no E-length moment
    # scans). Every pair in a segment is valid (invalid pairs carry the
    # sentinel key and form the tail segment), so a segment's size is
    # last_pos - first_pos + 1; the nearest is_last at-or-after each
    # position is its own segment's last, found by a reverse cummin. The
    # per-cluster moment sums run at the E2 budget after sort 2.
    idxs = jnp.arange(E, dtype=jnp.int32)
    nxt_first = jnp.concatenate([first[1:], jnp.ones((1,), bool)])
    nxt_valid = jnp.concatenate([valid[1:], jnp.zeros((1,), bool)])
    is_last = valid & (nxt_first | ~nxt_valid)
    candl = jnp.where(is_last, idxs, E)
    last_at = jnp.flip(jax.lax.cummin(jnp.flip(candl)))           # (E,)
    cnt0 = last_at - idxs + 1

    # --- top-C segments by size (gates in true-pixel units) -----------------
    max_perimeter = 2 * (2 * W + 2 * H)
    count_at_start = jnp.where(first, cnt0, 0)
    true_size = count_at_start * stride
    eligible = (true_size >= min_cluster_pixels) & (true_size <= max_perimeter)
    gated = jnp.where(eligible, count_at_start, 0)
    # top-C by size as ONE stable 2-operand descending sort: identical
    # selection and tie order to lax.top_k (ties -> lower position first).
    neg_sizes, top_pos = jax.lax.sort((-gated, idxs), num_keys=1)
    top_sizes, top_pos = -neg_sizes[:C], top_pos[:C]
    cvalid = top_sizes > 0
    ccnt = jnp.where(cvalid, top_sizes, 0).astype(jnp.float32)

    # --- slot ids broadcast to members (C-scatter + ONE packed cummax) ------
    # Same packed-broadcast trick as ops/resolve.py: seeds sit exactly at
    # group starts, so a plain cummax over (group_rank << 8 | slot+1) carries
    # each group's seed to its members (a later group's rank high bits always
    # win; unseeded groups read 0 low bits -> slot -1). rank <= E <
    # 4*2047*2047 < 2^24 (the packed-coords image guard above) and
    # slot+1 <= C <= 128 <= 2^8 - 1, so the pack fits uint32. Replaces an
    # E-length segmented copy-scan with a custom combinator.
    if C > 128:
        raise ValueError("max_clusters must be <= 128 (8-bit slot packing)")
    rank = jnp.cumsum(first.astype(jnp.uint32)) << 8
    slot_seed = jnp.zeros((E + 1,), jnp.uint32).at[
        jnp.where(cvalid, top_pos, E)].set(
        jnp.arange(1, C + 1, dtype=jnp.uint32))[:E]
    slot = (jax.lax.cummax(rank | slot_seed) & jnp.uint32(0xFF)
            ).astype(jnp.int32) - 1

    # --- sort 2: compact the top-C clusters' pairs to the E2 budget ---------
    # TWO operands (slot key + packed coords). Pairs of the top-C clusters
    # sort to the front; everything downstream (per-cluster moment sums,
    # angular binning, per-bin reductions) runs at the tight per-cluster
    # budget E2 = C * max_cluster_points instead of E. The slice keeps the
    # lowest slots complete; a frame whose slot-pair total overflows E2
    # truncates the highest slots and raises `overflow` (truncation keeps
    # each surviving slot's pairs in stable stream order).
    key2 = jnp.where(valid & (slot >= 0), slot, C)
    E2 = min(C * max_cluster_points, E)
    n_slot_pairs = jnp.sum((key2 != C).astype(jnp.int32))
    slot_overflow = n_slot_pairs > E2
    key2, pay2 = jax.lax.sort((key2, pay_s), num_keys=1)
    key2, pay2 = key2[:E2], pay2[:E2]
    v2 = key2 != C
    slot2 = jnp.where(v2, key2, C)
    x2 = (pay2 & 0xFFF).astype(jnp.float32) * 0.5
    y2 = ((pay2 >> 12) & 0xFFF).astype(jnp.float32) * 0.5
    gp2 = pay2 >> 24
    gx2 = ((gp2 & 0x3) - 1).astype(jnp.float32)
    gy2 = (((gp2 >> 2) & 0x3) - 1).astype(jnp.float32)
    w2 = v2.astype(jnp.float32)

    # --- per-cluster stats at E2: ONE one-hot matmul reduction -------------
    # Per-slot sums are onehot^T @ fields — slots are <= 128 one-hot
    # columns, so one matmul does the segmented reduction (exact per
    # segment: off-slot products are exact zeros).
    # precision=HIGHEST throughout: a default-precision f32 matmul may round
    # its operands (to TF32 on the GPU).
    HI = jax.lax.Precision.HIGHEST
    F2 = jnp.stack([w2, x2 * w2, y2 * w2, (x2 * x2 + y2 * y2) * w2,
                    gx2 * w2, gy2 * w2, (x2 * gx2 + y2 * gy2) * w2], -1)
    onehot = (slot2[:, None] == jnp.arange(C, dtype=jnp.int32)[None, :]
              ).astype(jnp.float32)                               # (E2, C)
    ctot = jnp.matmul(onehot.T, F2, precision=HI)                 # (C, 7)
    # Normalization count: the E2-resident pair count (matches the sums it
    # normalizes; differs from `ccnt` only when slot_overflow truncated).
    safe = jnp.maximum(ctot[:, 0], 1.0)
    ccx = ctot[:, 1] / safe
    ccy = ctot[:, 2] / safe
    r2m = ctot[:, 3] / safe - ccx * ccx - ccy * ccy
    cscale = jnp.sqrt(jnp.maximum(r2m, 1e-12))
    mean_dot = (ctot[:, 6] - ccx * ctot[:, 4] - ccy * ctot[:, 5]) / safe
    dark = mean_dot > 0

    # --- per-pair angular bin about the cluster centroid --------------------
    # Per-pair normalization parameters are fetched from the tiny (C,)
    # tables with the same one-hot matrix — bit-exact: the one-hot row has
    # a single 1.0, so the accumulation adds exact zeros.
    paramC = jnp.stack([ccx, ccy, jnp.maximum(r2m, 1e-12)], -1)   # (C, 3)
    params = jnp.matmul(onehot, paramC, precision=HI)             # (E2, 3)
    cx2, cy2, r2_2 = params[:, 0], params[:, 1], params[:, 2]
    bins = _diamond_bin(x2 - cx2, y2 - cy2, K)
    inv2 = jax.lax.rsqrt(jnp.maximum(r2_2, 1e-12))
    sxn = (x2 - cx2) * inv2
    syn = (y2 - cy2) * inv2

    # --- (cluster, bin) cell tables: factored one-hot matmul ----------------
    # cell[s, b, f] = sum_e onehot[e, s] * oh_bin[e, b] * F3[e, f] — the
    # third sort + segmented scan + scatter of earlier revisions collapse
    # into one (C, E2) @ (E2, K*6) contraction (~6 GFLOP). Invalid rows
    # have an all-zero onehot row, so no masking of F3 is needed beyond w2
    # (kept explicit so non-finite garbage can never ride a 0*x product).
    F3 = jnp.stack([w2, sxn * w2, syn * w2, sxn * sxn * w2,
                    sxn * syn * w2, syn * syn * w2], -1)          # (E2, 6)
    oh_bin = (bins[:, None] == jnp.arange(K, dtype=jnp.int32)[None, :]
              ).astype(jnp.float32)                               # (E2, K)
    G = (oh_bin[:, :, None] * F3[:, None, :]).reshape(E2, K * 6)
    table = jnp.matmul(onehot.T, G, precision=HI).reshape(C, K, 6)
    bw, bx, by, bxx, bxy, byy = [table[..., i] for i in range(6)]

    n_clusters = jnp.sum(first.astype(jnp.int32))
    n_eligible = jnp.sum(eligible.astype(jnp.int32))
    return ClusterMoments(
        bw=bw, bx=bx, by=by, bxx=bxx, bxy=bxy, byy=byy,
        count=ccnt.astype(jnp.int32),
        centroid=jnp.stack([ccx, ccy], -1),
        scale=cscale, dark_inside=dark, valid=cvalid,
        num_clusters=n_clusters, num_eligible=n_eligible,
        num_edge_points=num_edge, edge_stride=stride,
        overflow=((num_edge > E) | comp_overflow | (n_eligible > C)
                  | slot_overflow))
