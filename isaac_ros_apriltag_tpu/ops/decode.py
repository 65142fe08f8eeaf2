"""Tag decoding: quad corners -> (id, hamming, decision margin, rotation).

Replaces the decode half of the reference's closed cuAprilTags/VPI engines
(ref: isaac_ros_apriltag/src/apriltag_node.cpp:491-493, :290-293) with a
fully table-driven XLA implementation:

  1. 4-point homography from the unit square to the quad (utils.geometry,
     batched solve);
  2. bilinear sampling of every bit-cell center plus two reference rings
     (border ring + just-outside ring);
  3. per-quad linear gray models (a + b*u + c*v) fit to each reference ring —
     batched 3x3 normal equations — give a spatially varying bit threshold;
  4. optional unsharp sharpening of the sampled bit grid
     (AprilTag 3's decode_sharpening);
  5. codeword match: XOR + popcount against the family codebook under all
     four rotations at once (dense (C, 4, ncodes) int ops).

Bit values and thresholds are computed identically for normal and
reversed-border families — the gray models adapt automatically.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.families import TagFamily
from ..utils.geometry import apply_homography, homography_from_correspondences

# uv coordinates of the quad's cyclic corners in the border frame ([-1,1]^2,
# u right / v down in tag-bitmap space). Quad corner j maps to _SQUARE[j].
_SQUARE = np.array([[-1.0, -1.0], [1.0, -1.0], [1.0, 1.0], [-1.0, 1.0]], np.float32)


class DecodeResult(NamedTuple):
    valid: jax.Array      # (C,) bool — codeword matched within max_hamming
    id: jax.Array         # (C,) int32
    hamming: jax.Array    # (C,) int32
    margin: jax.Array     # (C,) float32
    rotation: jax.Array   # (C,) int32 in [0, 4) — orientation of the tag
    corners: jax.Array    # (C, 4, 2) float32 — rotation-corrected cyclic order


def _ring_cells(lo: int, hi: int) -> np.ndarray:
    cells = []
    for x in range(lo, hi + 1):
        cells.append((x, lo))
        cells.append((x, hi))
    for y in range(lo + 1, hi):
        cells.append((lo, y))
        cells.append((hi, y))
    return np.array(cells, np.float32)


def _cell_uv(cells: np.ndarray, wb: int) -> np.ndarray:
    """Cell coords -> border-frame uv in [-1, 1] (cell centers)."""
    return ((cells + 0.5) / wb * 2.0 - 1.0).astype(np.float32)


def _bilinear(gray: jax.Array, pts: jax.Array) -> jax.Array:
    """Sample gray — (H, W), or (H, W, 4) pre-stacked via
    refine._neighbor_stack — at pixel coords pts (..., 2); clamped borders.
    The stacked form fetches all four taps in one gather row; arithmetic is
    bit-identical."""
    H, W = gray.shape[:2]
    x = jnp.clip(pts[..., 0], 0.0, W - 1.001)
    y = jnp.clip(pts[..., 1], 0.0, H - 1.001)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx = x - x0
    fy = y - y0
    if gray.ndim == 3:
        v = gray[y0, x0]
        v00, v01, v10, v11 = v[..., 0], v[..., 1], v[..., 2], v[..., 3]
    else:
        v00 = gray[y0, x0]
        v01 = gray[y0, x0 + 1]
        v10 = gray[y0 + 1, x0]
        v11 = gray[y0 + 1, x0 + 1]
    return (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy + v11 * fx * fy)


def _fit_gray_model(uv: jax.Array, vals: jax.Array) -> jax.Array:
    """Least-squares fit of vals ~ a + b*u + c*v. uv: (..., N, 2);
    vals: (..., N). Returns (..., 3) = (a, b, c)."""
    from ..utils.geometry import inverse3x3

    ones = jnp.ones_like(uv[..., :1])
    A = jnp.concatenate([ones, uv], -1)                       # (..., N, 3)
    hi = jax.lax.Precision.HIGHEST
    AtA = jnp.einsum("...ni,...nj->...ij", A, A, precision=hi)
    AtA = AtA + 1e-6 * jnp.eye(3)
    Atb = jnp.einsum("...ni,...n->...i", A, vals, precision=hi)
    return jnp.einsum("...ij,...j->...i", inverse3x3(AtA), Atb, precision=hi)


def _eval_gray_model(model: jax.Array, uv: jax.Array) -> jax.Array:
    return (model[..., 0:1] + model[..., 1:2] * uv[..., 0]
            + model[..., 2:3] * uv[..., 1])


def decode_quads(gray: jax.Array, corners: jax.Array, family: TagFamily, *,
                 max_hamming: int = 2, decode_sharpening: float = 0.25,
                 ) -> DecodeResult:
    """gray: (H, W) float32; corners: (C, 4, 2) cyclic quad corners."""
    C = corners.shape[0]
    wb = family.width_at_border
    nbits = family.nbits

    # Static sample layouts (border frame).
    bit_cells = np.stack([family.bit_x, family.bit_y], -1).astype(np.float32)
    uv_bits = jnp.asarray(_cell_uv(bit_cells, wb))            # (nbits, 2)
    uv_border = jnp.asarray(_cell_uv(_ring_cells(0, wb - 1), wb))
    uv_outer = jnp.asarray(_cell_uv(_ring_cells(-1, wb), wb))

    H = homography_from_correspondences(
        jnp.broadcast_to(jnp.asarray(_SQUARE), (C, 4, 2)), corners)  # (C, 3, 3)

    from .refine import _neighbor_stack
    gray4 = _neighbor_stack(gray)

    def sample(uv):
        pts = apply_homography(H, jnp.broadcast_to(uv, (C,) + uv.shape))
        return _bilinear(gray4, pts)

    v_border = sample(uv_border)       # (C, nb)
    v_outer = sample(uv_outer)         # (C, no)
    v_bits = sample(uv_bits)           # (C, nbits)

    model_in = _fit_gray_model(jnp.broadcast_to(uv_border, (C,) + uv_border.shape), v_border)
    model_out = _fit_gray_model(jnp.broadcast_to(uv_outer, (C,) + uv_outer.shape), v_outer)
    thresh = 0.5 * (_eval_gray_model(model_in, uv_bits)
                    + _eval_gray_model(model_out, uv_bits))   # (C, nbits)

    # --- sharpening on the (tw, tw) sampled grid --------------------------
    if decode_sharpening > 0:
        tw = family.total_width
        off = (tw - wb) // 2
        gx = (family.bit_x + off).astype(np.int32)
        gy = (family.bit_y + off).astype(np.int32)
        lin = jnp.asarray(gy * tw + gx)
        grid = jnp.zeros((C, tw * tw), v_bits.dtype).at[:, lin].set(v_bits)
        grid = grid.reshape(C, tw, tw)
        lap = (4.0 * grid
               - jnp.roll(grid, 1, 1) - jnp.roll(grid, -1, 1)
               - jnp.roll(grid, 1, 2) - jnp.roll(grid, -1, 2))
        grid = grid + decode_sharpening * lap
        v_bits = grid.reshape(C, tw * tw)[:, lin]

    deviation = v_bits - thresh
    bits = deviation > 0                                       # (C, nbits) bool
    # AprilTag 3 decision margin: intensities are scored per decoded CLASS —
    # mean deviation of the bits read as white and of the bits read as black
    # — and the margin is the WORSE of the two class means (one washed-out
    # class cannot hide behind a strong one). A class with no bits
    # contributes +inf so the other class's mean rules.
    wmask = bits.astype(jnp.float32)
    bmask = 1.0 - wmask
    wcnt = jnp.sum(wmask, -1)
    bcnt = jnp.sum(bmask, -1)
    wmean = jnp.where(wcnt > 0, jnp.sum(deviation * wmask, -1) / jnp.maximum(wcnt, 1.0), jnp.inf)
    bmean = jnp.where(bcnt > 0, jnp.sum(-deviation * bmask, -1) / jnp.maximum(bcnt, 1.0), jnp.inf)
    margin = jnp.minimum(wmean, bmean)

    # --- codebook match under 4 rotations ---------------------------------
    perms = jnp.asarray(family.rotation_perm)                  # (4, nbits)
    rbits = bits[:, perms]                                     # (C, 4, nbits)

    # pack bits -> (lo, hi) uint32 pair; bit 0 is the MSB of an nbits-wide word
    pos = nbits - 1 - np.arange(nbits)          # bit position (LSB = 0)
    w_lo = np.where(pos < 32, 1 << np.minimum(pos, 31), 0).astype(np.uint32)
    w_hi = np.where(pos >= 32, 1 << np.maximum(pos - 32, 0), 0).astype(np.uint32)
    b32 = rbits.astype(jnp.uint32)
    code_lo = jnp.sum(b32 * jnp.asarray(w_lo), -1, dtype=jnp.uint32)  # (C, 4)
    code_hi = jnp.sum(b32 * jnp.asarray(w_hi), -1, dtype=jnp.uint32)

    codes = family.codes
    tbl_lo = jnp.asarray((codes & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    tbl_hi = jnp.asarray((codes >> np.uint64(32)).astype(np.uint32))
    ham = (jax.lax.population_count(code_lo[..., None] ^ tbl_lo)
           + jax.lax.population_count(code_hi[..., None] ^ tbl_hi))  # (C, 4, n)
    ham_min = jnp.min(ham, -1).astype(jnp.int32)                # (C, 4)
    id_min = jnp.argmin(ham, -1).astype(jnp.int32)
    best_r = jnp.argmin(ham_min, -1).astype(jnp.int32)          # (C,)
    best_h = jnp.take_along_axis(ham_min, best_r[:, None], 1)[:, 0]
    best_id = jnp.take_along_axis(id_min, best_r[:, None], 1)[:, 0]
    valid = best_h <= max_hamming

    # --- rotation-corrected corner order ----------------------------------
    # Physical rotation r means the canonical tag bitmap is rotated r*90deg in
    # our uv frame; detection corner 0 is defined as the quad corner landing
    # on canonical bitmap corner (+1, +1) (see types.Detections docstring).
    roll = jnp.mod(2 - best_r, 4)
    idx = jnp.mod(jnp.arange(4)[None, :] + roll[:, None], 4)    # (C, 4)
    corr = jnp.take_along_axis(corners, idx[..., None].repeat(2, -1), 1)

    return DecodeResult(valid=valid, id=best_id, hamming=best_h, margin=margin,
                        rotation=best_r, corners=corr)
