"""Subpixel edge refinement: gradient-weighted line snap for quad edges.

Raw quads come from black/white pixel-pair midpoints, so every edge carries
up to +-0.5 px of quantization (worst for axis-aligned tags, where all points
on an edge share the same error). AprilTag 3 fixes this with refine_edges:
sample the image gradient along each edge's normal and shift the edge to the
gradient-weighted zero crossing. The reference invokes this inside its
closed detector binaries (cuAprilTags / VPI — ref:
isaac_ros_apriltag/src/apriltag_node.cpp:491-493, :290-293); this is a
dense reformulation: fixed sample/offset grids, bilinear gathers,
everything batched over (quads x edges x samples x offsets) — no loops.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..utils.geometry import line_intersection

_NSAMPLES = 12      # points sampled along each edge
_STEP = 0.5         # offset step, px (profile resolution)
_GRANGE = 1.0       # gradient baseline half-distance, px (= 2 profile steps)


def _neighbor_stack(img: jax.Array) -> jax.Array:
    """(H, W) -> (H, W, 4) with channels [img[y,x], img[y,x+1], img[y+1,x],
    img[y+1,x+1]] (edge rows/cols duplicated; never read by _bilinear's
    clamped coords). Build cost is three elementwise passes — cheap; it buys
    ONE gather row per sample instead of four in _bilinear (not yet timed
    against four plain gathers on the H100)."""
    v01 = jnp.concatenate([img[:, 1:], img[:, -1:]], axis=1)
    v10 = jnp.concatenate([img[1:, :], img[-1:, :]], axis=0)
    v11 = jnp.concatenate([v01[1:, :], v01[-1:, :]], axis=0)
    return jnp.stack([img, v01, v10, v11], axis=-1)


def _bilinear(img: jax.Array, x: jax.Array, y: jax.Array) -> jax.Array:
    """Bilinear sample img (H, W) or pre-stacked (H, W, 4) f32 at (x, y)
    pixel-center coords, clamped. Passing the `_neighbor_stack` form fetches
    all four taps in one gather row — bit-identical arithmetic."""
    H, W = img.shape[:2]
    x = jnp.clip(x, 0.0, W - 1.001)
    y = jnp.clip(y, 0.0, H - 1.001)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx = x - x0
    fy = y - y0
    if img.ndim == 3:
        v = img[y0, x0]
        v00, v01, v10, v11 = v[..., 0], v[..., 1], v[..., 2], v[..., 3]
    else:
        v00 = img[y0, x0]
        v01 = img[y0, x0 + 1]
        v10 = img[y0 + 1, x0]
        v11 = img[y0 + 1, x0 + 1]
    return ((v00 * (1 - fx) + v01 * fx) * (1 - fy)
            + (v10 * (1 - fx) + v11 * fx) * fy)


def refine_edges(gray: jax.Array, corners: jax.Array,
                 dark_inside: jax.Array, *,
                 search_range: float = 2.0) -> jax.Array:
    """Snap quad edges to the image's intensity gradient.

    gray: (H, W) float32; corners: (C, 4, 2) cyclic; dark_inside: (C,) bool.
    search_range: half-width of the normal search window, px — AprilTag 3
    uses quad_decimate + 1 so decimation quantization stays in capture range.
    Returns refined corners (C, 4, 2). Degenerate refinements (no gradient
    support, or a corner moving further than the search range) fall back to
    the input corner.
    """
    C = corners.shape[0]
    p0 = corners                                   # (C, 4, 2) edge start
    p1 = jnp.roll(corners, -1, axis=1)             # (C, 4, 2) edge end
    centroid = jnp.mean(corners, axis=1, keepdims=True)  # (C, 1, 2)

    e = p1 - p0
    elen = jnp.linalg.norm(e, axis=-1, keepdims=True)
    e = e / jnp.maximum(elen, 1e-6)
    n = jnp.stack([e[..., 1], -e[..., 0]], -1)     # unit perpendicular
    # Orient n inward (toward the quad centroid).
    mid = 0.5 * (p0 + p1)
    inward = jnp.sum(n * (centroid - mid), -1, keepdims=True) >= 0
    n = jnp.where(inward, n, -n)

    # Sample points along each edge (corners excluded).
    alphas = (1.0 + jnp.arange(_NSAMPLES)) / (_NSAMPLES + 1)     # (S,)
    pts = p0[:, :, None, :] + alphas[None, None, :, None] * (p1 - p0)[:, :, None, :]
    # (C, 4, S, 2)

    # ONE intensity profile per sample point along the normal; the gradient
    # pair at offset o is the profile differenced at +-_GRANGE (2 steps), so
    # taps are shared across offsets instead of re-sampled per (offset, side)
    # — a ~4x cut in bilinear gathers.
    pad = int(round(_GRANGE / _STEP))                            # steps
    prof_offs = jnp.arange(-search_range - _GRANGE,
                           search_range + _GRANGE + _STEP / 2, _STEP)
    base = (pts[:, :, :, None, :]
            + prof_offs[None, None, None, :, None] * n[:, :, None, None, :])
    gray4 = _neighbor_stack(gray)
    prof = _bilinear(gray4, base[..., 0], base[..., 1])          # (C, 4, S, P)
    g_in = prof[..., 2 * pad:]                                   # offset + GRANGE
    g_out = prof[..., :prof.shape[-1] - 2 * pad]                 # offset - GRANGE
    offs = prof_offs[pad:-pad]                                   # (O,)

    # Expected polarity: inward darker for dark-interior quads.
    diff = jnp.where(dark_inside[:, None, None, None], g_out - g_in,
                     g_in - g_out)
    w = jnp.where(diff > 0, diff * diff, 0.0)                    # (C, 4, S, O)
    wsum = jnp.sum(w, -1)                                        # (C, 4, S)
    n0 = jnp.sum(w * offs, -1) / jnp.maximum(wsum, 1e-9)         # (C, 4, S)
    sample_ok = wsum > 1e-3

    q = pts + n0[..., None] * n[:, :, None, :]                   # (C, 4, S, 2)

    # Weighted line fit through the adjusted samples (per edge).
    sw = jnp.where(sample_ok, wsum, 0.0)[..., None]              # (C, 4, S, 1)
    tot = jnp.maximum(jnp.sum(sw, 2), 1e-9)                      # (C, 4, 1)
    mean = jnp.sum(q * sw, 2) / tot                              # (C, 4, 2)
    d = q - mean[:, :, None, :]
    cxx = jnp.sum(sw[..., 0] * d[..., 0] * d[..., 0], -1)
    cxy = jnp.sum(sw[..., 0] * d[..., 0] * d[..., 1], -1)
    cyy = jnp.sum(sw[..., 0] * d[..., 1] * d[..., 1], -1)
    disc = jnp.sqrt(jnp.maximum((cxx - cyy) ** 2 + 4 * cxy * cxy, 0.0))
    lam = 0.5 * (cxx + cyy + disc)
    v1 = jnp.stack([cxy, lam - cxx], -1)
    v2 = jnp.stack([lam - cyy, cxy], -1)
    pick = jnp.sum(v1 * v1, -1, keepdims=True) > jnp.sum(v2 * v2, -1, keepdims=True)
    dirs = jnp.where(pick, v1, v2)
    dirs = dirs / jnp.maximum(jnp.linalg.norm(dirs, axis=-1, keepdims=True), 1e-9)

    # Edge usable only with gradient support on most samples.
    edge_ok = jnp.sum(sample_ok, -1) >= _NSAMPLES // 2           # (C, 4)
    # Degenerate direction (all samples coincident) -> keep original edge.
    dir_ok = lam > 1e-9
    mean = jnp.where((edge_ok & dir_ok)[..., None], mean, mid)
    dirs = jnp.where((edge_ok & dir_ok)[..., None], dirs, e)

    # Corner k = intersection of edge (k-1) and edge k.
    new = line_intersection(jnp.roll(mean, 1, 1), jnp.roll(dirs, 1, 1),
                            mean, dirs)                          # (C, 4, 2)
    moved = jnp.linalg.norm(new - corners, axis=-1)
    ok = jnp.isfinite(new).all(-1) & (moved < search_range + 0.5)
    return jnp.where(ok[..., None], new, corners)
