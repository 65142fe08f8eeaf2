"""Quad fitting: boundary clusters -> candidate quads (4 subpixel corners).

A dense reformulation of AprilTag 3's fit_quad. The original algorithm
sorts each cluster's points by angle and slides point-indexed windows around
the boundary; that formulation needs an argsort plus ~17 dynamically-indexed
gathers per cluster. Here the angular dimension is QUANTIZED into K=64
fixed bins instead:

  1. per-point angle about the centroid -> bin id (elementwise, computed
     upstream in ops/cluster_moments.py with the sort-centric grouping);
  2. per-(cluster, bin) moment sums (w, x, y, xx, xy, yy) arrive as the
     ClusterMoments tables;
  3. circular prefix sums over bins give O(1) weighted line fits over any
     angular arc via one-hot selector matmuls (all arc indices are
     static-modulo-K — no dynamic shapes, no serialized gathers);
  4. per-bin line-fit error over a +-2-bin window; circular local maxima are
     corner candidates (bin resolution 360/64 = 5.6 deg, comparable to the
     original's ~20-point windows on a ~1000-point boundary);
  5. exhaustive search over 4-subsets of the top-M candidate bins (cyclic
     order), scoring by total arc line-fit error — all C(M,4) combos dense;
  6. winning arcs re-fit -> 4 lines -> corners from intersections;
  7. geometric gates: arc MSE, corner angles, area, winding normalization.

Corner positions come from moment-based line fits over arcs (exact per-point
sums), so bin quantization only perturbs which points join each fit; the
subpixel result is equivalent in practice and refine_edges re-snaps edges on
the full-resolution image afterwards. The reference runs its equivalent
inside closed CUDA binaries (ref: isaac_ros_apriltag/src/apriltag_node.cpp:
491-493, :290-293).
"""

from __future__ import annotations

import itertools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


_NBINS = 64
_MAXIMA = 10
# All 4-subsets of the top-M maxima in cyclic (ascending angular) order.
_COMBOS = np.array(list(itertools.combinations(range(_MAXIMA), 4)), np.int32)


class Quads(NamedTuple):
    corners: jax.Array    # (C, 4, 2) float32 — pixel coords, cyclic order
    valid: jax.Array      # (C,) bool
    dark_inside: jax.Array  # (C,) bool — True if quad interior is dark
    fit_err: jax.Array    # (C,) float32 — total arc MSE of winning combo
    gates: jax.Array      # (C, 6) bool — [combo, mse, area, angle, finite, n>=8]


def _arc_sums(S_list, a: jax.Array, b: jax.Array):
    """Sums of per-bin values over the circular bin range [a, b] inclusive,
    for EVERY prefix table in S_list at once.

    Each S: (C, K+1) prefix sums; a, b int arrays (C, ...) with 0 <= a <= K,
    a-1 <= b < a + K (b < a yields an empty arc = 0); b may exceed K (wraps).

    The three prefix lookups per arc are fused into ONE one-hot matmul per
    table — (C, P, K+1) selector @ (C, K+1) — instead of take_along_axis
    (not yet timed against the gather on the H100).
    """
    C, K1 = S_list[0].shape
    K = K1 - 1
    shape = jnp.broadcast_shapes(a.shape, b.shape)
    shape = (C,) + tuple(shape[1:])
    a = jnp.broadcast_to(a, shape).reshape(C, -1)
    b = jnp.broadcast_to(b, shape).reshape(C, -1)
    wrap = (b >= K)[..., None]                              # (C, P, 1)

    iota = jnp.arange(K1, dtype=jnp.int32)                  # (K+1,)
    ia = jnp.clip(a, 0, K)[..., None]
    ib = jnp.clip(b + 1, 0, K)[..., None]
    iw = jnp.clip(b - K + 1, 0, K)[..., None]
    # combined selector: direct = S[ib] - S[ia]; wrapped = S[K] - S[ia] + S[iw]
    sel = jnp.where(wrap,
                    (iota == iw).astype(jnp.float32)
                    - (iota == ia).astype(jnp.float32)
                    + (iota == K).astype(jnp.float32),
                    (iota == ib).astype(jnp.float32)
                    - (iota == ia).astype(jnp.float32))      # (C, P, K+1)
    outs = []
    for S in S_list:
        # HIGHEST precision is load-bearing: arc sums are small differences
        # of large prefix values, which reduced-precision operand rounding
        # (bf16 or TF32) wipes out.
        o = jnp.einsum("cpk,ck->cp", sel, S,
                       precision=jax.lax.Precision.HIGHEST)
        outs.append(o.reshape(shape))
    return outs


def _arc_sum(S: jax.Array, a: jax.Array, b: jax.Array) -> jax.Array:
    return _arc_sums([S], a, b)[0]


def _line_fit(msums: tuple, W: jax.Array):
    """Given arc moment sums (Sx, Sy, Sxx, Sxy, Syy) and weight W, return
    (ex, ey, cxx, cxy, cyy, err) where err = smaller covariance eigenvalue."""
    Sx, Sy, Sxx, Sxy, Syy = msums
    Wf = jnp.maximum(W, 1e-6)
    ex, ey = Sx / Wf, Sy / Wf
    cxx = Sxx / Wf - ex * ex
    cxy = Sxy / Wf - ex * ey
    cyy = Syy / Wf - ey * ey
    disc = jnp.sqrt(jnp.maximum((cxx - cyy) ** 2 + 4 * cxy * cxy, 0.0))
    err = 0.5 * (cxx + cyy - disc)
    return ex, ey, cxx, cxy, cyy, err


def _line_dir(cxx, cxy, cyy):
    """Principal direction (largest-eigenvalue eigenvector) of the 2x2 cov."""
    disc = jnp.sqrt(jnp.maximum((cxx - cyy) ** 2 + 4 * cxy * cxy, 0.0))
    lam = 0.5 * (cxx + cyy + disc)
    v1 = jnp.stack([cxy, lam - cxx], -1)
    v2 = jnp.stack([lam - cyy, cxy], -1)
    n1 = jnp.sum(v1 * v1, -1, keepdims=True)
    n2 = jnp.sum(v2 * v2, -1, keepdims=True)
    v = jnp.where(n1 > n2, v1, v2)
    return v / jnp.sqrt(jnp.maximum(jnp.sum(v * v, -1, keepdims=True), 1e-12))


def fit_quads_from_moments(m, *, max_line_fit_mse: float = 10.0,
                           critical_cos: float = 0.985,
                           min_area: float = 64.0) -> Quads:
    """Sort-free entry: consumes ops.cluster_moments.ClusterMoments."""
    return _fit_quads_bins([m.bw, m.bx, m.by, m.bxx, m.bxy, m.byy],
                           m.centroid, m.scale, m.dark_inside, m.count,
                           m.valid, max_line_fit_mse=max_line_fit_mse,
                           critical_cos=critical_cos, min_area=min_area)


def _fit_quads_bins(B, centroid, scale, dark_inside, n, cluster_valid, *,
                    max_line_fit_mse: float, critical_cos: float,
                    min_area: float) -> Quads:
    """Shared bin-space quad fit. B = 6 (C, K) per-bin moment sums over
    scale-normalized coordinates; bins are any monotone circular angle
    parameterization about the centroid."""
    C, K = B[0].shape
    assert K == _NBINS, K
    cx = centroid[:, 0:1]
    cy = centroid[:, 1:2]
    scale = jnp.maximum(scale[:, None], 1e-6)          # (C, 1)
    # circular prefix sums: (C, K+1)
    S = [jnp.concatenate([jnp.zeros((C, 1), jnp.float32),
                          jnp.cumsum(b, -1)], -1) for b in B]
    Sw, Sx, Sy, Sxx, Sxy, Syy = S

    # --- per-bin corner error: line fit over a +-2-bin window ---------------
    kb = jnp.arange(K, dtype=jnp.int32)[None, :]       # (1, K)
    m = 2
    a = (kb - m) % K
    b = a + 2 * m
    *msums, Wn = _arc_sums((Sx, Sy, Sxx, Sxy, Syy, Sw), a, b)
    *_, errs = _line_fit(tuple(msums), Wn)             # (C, K)
    errs = jnp.where(Wn >= 4.0, errs, -jnp.inf)

    # --- circular local maxima -> top-M candidate bins ----------------------
    prev = jnp.roll(errs, 1, -1)
    nxt = jnp.roll(errs, -1, -1)
    is_max = (errs > prev) & (errs >= nxt) & jnp.isfinite(errs)
    max_errs = jnp.where(is_max, errs, -jnp.inf)
    top_vals, top_idx = jax.lax.top_k(max_errs, _MAXIMA)   # (C, M)
    cand_valid = jnp.isfinite(top_vals)
    cand_sorted = jnp.sort(jnp.where(cand_valid, top_idx, jnp.int32(2 * K)), -1)

    # --- score all 4-subsets -------------------------------------------------
    combos = jnp.asarray(_COMBOS)                      # (Ncomb, 4)
    cidx = cand_sorted[:, combos]                      # (C, Ncomb, 4) ascending
    combo_ok = jnp.all(cidx < K, -1)                   # all four candidates real
    # Arcs between consecutive corners in UNWRAPPED bin space: for the three
    # interior pairs the next corner is simply the next column; the last arc
    # wraps to the first corner + K. Corner bins themselves are excluded.
    c0 = cidx
    c1 = jnp.roll(cidx, -1, axis=-1)
    c1 = c1 + jnp.where(jnp.arange(4) == 3, K, 0)      # wrap the last pair
    arc_a = c0 + 1                                     # in [1, K]
    arc_b = c1 - 1                                     # empty arc -> a-1
    nbins_arc = arc_b - arc_a + 1
    *msums, Wn = _arc_sums((Sx, Sy, Sxx, Sxy, Syy, Sw), arc_a, arc_b)
    ex, ey, cxx, cxy, cyy, aerr = _line_fit(tuple(msums), Wn)  # each (C, Ncomb, 4)
    arc_ok = (nbins_arc >= 1) & (Wn >= 3.0)
    combo_err = jnp.where(combo_ok & jnp.all(arc_ok, -1),
                          jnp.sum(aerr, -1), jnp.inf)   # (C, Ncomb)
    best = jnp.argmin(combo_err, -1)                    # (C,)
    best_err = jnp.take_along_axis(combo_err, best[:, None], -1)[:, 0]
    have_combo = jnp.isfinite(best_err)

    take = lambda x: jnp.take_along_axis(x, best[:, None, None], 1)[:, 0]  # (C,4)
    ex, ey = take(ex), take(ey)
    cxx, cxy, cyy, aerr = take(cxx), take(cxy), take(cyy), take(aerr)

    # --- winning lines -> corners --------------------------------------------
    from ..utils.geometry import line_intersection
    pts = jnp.stack([ex, ey], -1)                       # (C, 4, 2) centroids
    dirs = _line_dir(cxx, cxy, cyy)                     # (C, 4, 2)
    p_prev = jnp.roll(pts, 1, 1)
    d_prev = jnp.roll(dirs, 1, 1)
    corners = line_intersection(p_prev, d_prev, pts, dirs)  # (C, 4, 2)
    corners = corners * scale[..., None] + jnp.stack([cx, cy], -1)

    # --- gates ----------------------------------------------------------------
    scale2 = (scale[..., 0]) ** 2
    mse_ok = jnp.max(aerr, -1) * scale2 <= max_line_fit_mse
    x0, y0 = corners[..., 0], corners[..., 1]
    x1, y1 = jnp.roll(x0, -1, -1), jnp.roll(y0, -1, -1)
    area2 = jnp.sum(x0 * y1 - x1 * y0, -1)
    area_ok = 0.5 * jnp.abs(area2) >= min_area
    e_in = corners - jnp.roll(corners, 1, 1)
    e_out = jnp.roll(corners, -1, 1) - corners
    cosang = jnp.sum(e_in * e_out, -1) / jnp.maximum(
        jnp.linalg.norm(e_in, axis=-1) * jnp.linalg.norm(e_out, axis=-1), 1e-9)
    ang_ok = jnp.all(jnp.abs(cosang) < critical_cos, -1)
    finite_ok = jnp.all(jnp.isfinite(corners), (-2, -1))

    # cluster_valid is redundant with n >= 8 today (invalid slots have count
    # zeroed upstream) but is gated explicitly so an upstream change that
    # leaves count nonzero for an invalid slot can never emit a quad from a
    # garbage moment table.
    gates = jnp.stack([have_combo, mse_ok, area_ok, ang_ok, finite_ok,
                       n >= 8, cluster_valid], -1)      # (C, 7)
    valid = jnp.all(gates, -1)

    # Normalize winding: force positive signed area (y-down CCW) so corner
    # order is consistent for decode; reverse 1<->3 if needed.
    flip = corners[:, jnp.array([0, 3, 2, 1])]
    corners = jnp.where((area2 < 0)[:, None, None], flip, corners)

    return Quads(corners=corners, valid=valid, dark_inside=dark_inside,
                 fit_err=best_err * scale2, gates=gates)
