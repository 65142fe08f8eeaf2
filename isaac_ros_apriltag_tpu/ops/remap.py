"""Image warping ops: rectification remap + resize.

Equivalents of the external isaac_ros_image_proc Rectify/Resize
nodes the reference composes upstream of the detector
(ref: isaac_ros_apriltag/package.xml:49, launch/isaac_ros_apriltag_usb_cam.
launch.py:43-52, README.md:16-26 — incl. the motivating 8 MP -> 4:1 downscale
path).

Two remap formulations:

  - `remap_bilinear`: the direct gather form — the CORRECTNESS ORACLE
    (a 1080p rectify is 4 x 2M gathered taps).
  - `SeparableRectify`: the production path. Rectification maps are smooth
    and near-identity, so the warp factors into a horizontal then a
    vertical 1D resample (Catmull-Smith two-pass), and each 1D bilinear
    resample with bounded displacement |src - dst| <= D becomes a BANDED
    shift-multiply-accumulate: out = sum_d hat(src - (dst+d)) * shift(in, d)
    over the 2D+2 static offsets — elementwise work, zero gathers. Chosen
    where gathers serialized; not yet timed against the gather on the H100.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


def remap_bilinear(image: jax.Array, grid: jax.Array) -> jax.Array:
    """Sample `image` at source coords `grid`.

    image: (H, W) or (H, W, C) float32/uint8; grid: (H', W', 2) source (x, y).
    Out-of-range samples clamp to the border. Returns float32.
    """
    squeeze = image.ndim == 2
    if squeeze:
        image = image[..., None]
    H, W, C = image.shape
    img = image.astype(jnp.float32)
    x = jnp.clip(grid[..., 0], 0.0, W - 1.001)
    y = jnp.clip(grid[..., 1], 0.0, H - 1.001)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    v00 = img[y0, x0]
    v01 = img[y0, x0 + 1]
    v10 = img[y0 + 1, x0]
    v11 = img[y0 + 1, x0 + 1]
    out = (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
           + v10 * (1 - fx) * fy + v11 * fx * fy)
    return out[..., 0] if squeeze else out


def _band_resample_1d(img: jax.Array, src: jax.Array, axis: int,
                      dmin: int, dmax: int) -> jax.Array:
    """1D bilinear resample along `axis` as a banded shift-mul-accumulate.

    src: per-OUTPUT-pixel source coordinate along `axis` (same shape as the
    output), with src - dst_index guaranteed inside [dmin, dmax]. The two
    bilinear taps at floor(src) and floor(src)+1 are exactly the offsets d
    where hat(src - (dst + d)) = max(0, 1 - |.|) is nonzero, so summing the
    hat-weighted static shifts over d in [dmin, dmax+1] reproduces the
    gather bit-for... to float rounding. Zero-padding is safe: taps outside
    the band get zero weight.
    """
    n = img.shape[axis]
    pad_lo, pad_hi = max(-dmin, 0), max(dmax + 1, 0)
    pads = [(0, 0)] * img.ndim
    pads[axis] = (pad_lo, pad_hi)
    padded = jnp.pad(img, pads)
    dst = jax.lax.broadcasted_iota(jnp.int32, src.shape,
                                   axis).astype(jnp.float32)
    rel = src - dst
    acc = jnp.zeros(src.shape, jnp.float32)
    for d in range(dmin, dmax + 2):
        w = jnp.maximum(0.0, 1.0 - jnp.abs(rel - d))
        sl = [slice(None)] * img.ndim
        sl[axis] = slice(pad_lo + d, pad_lo + d + n)
        acc = acc + w * padded[tuple(sl)]
    return acc


@dataclasses.dataclass(frozen=True)
class SeparableRectify:
    """Precomputed two-pass (horizontal then vertical) rectification plan.

    Built once per camera from the (H, W, 2) rectify grid; `__call__` is
    jit-safe pure elementwise work (see module docstring). The intermediate
    horizontal map sx2 is the x-map composed with the inverse of the
    vertical warp per column (Catmull-Smith), so
    pass2(pass1(img)) ~= remap_bilinear(img, grid) up to the O(curvature)
    separability error — sub-0.05 px for plumb_bob-scale distortion
    (asserted in tests/test_ops.py).
    """

    sx2: jax.Array      # (H, W) horizontal source x at intermediate rows
    sy2: jax.Array      # (H, W) vertical source y per output pixel
    dx_range: tuple     # static (dmin, dmax) for the horizontal band
    dy_range: tuple

    @staticmethod
    def from_grid(grid: np.ndarray) -> "SeparableRectify":
        grid = np.asarray(grid, np.float64)
        H, W = grid.shape[:2]
        sx = grid[..., 0]
        sy = grid[..., 1]
        # Invert the vertical warp per column: sx2(y, x') = sx(y'(y), x')
        # where y'(y) solves sy(y', x') = y (sy is monotone in y' for
        # physical rectification maps; verified below). Inversion runs on
        # the RAW map (clamping creates flat runs); outputs clamp after.
        ys = np.arange(H, dtype=np.float64)
        sx2 = np.empty_like(sx)
        for x in range(W):
            col = sy[:, x]
            if not np.all(np.diff(col) > 0):
                raise ValueError(
                    "vertical rectify map is not monotone per column; "
                    "use remap_bilinear for this camera")
            yprime = np.interp(ys, col, ys)
            sx2[:, x] = np.interp(yprime, ys, sx[:, x])
        sx2 = np.clip(sx2, 0.0, W - 1.001)
        sy = np.clip(sy, 0.0, H - 1.001)
        xs = np.arange(W, dtype=np.float64)[None, :]
        dxr = (int(np.floor((sx2 - xs).min())), int(np.ceil((sx2 - xs).max())))
        dyr = (int(np.floor((sy - ys[:, None]).min())),
               int(np.ceil((sy - ys[:, None]).max())))
        return SeparableRectify(
            sx2=jnp.asarray(sx2, jnp.float32),
            sy2=jnp.asarray(sy, jnp.float32),
            dx_range=dxr, dy_range=dyr)

    def __call__(self, image: jax.Array) -> jax.Array:
        assert image.ndim == 2, "SeparableRectify expects a (H, W) image"
        img = image.astype(jnp.float32)
        tmp = _band_resample_1d(img, self.sx2, axis=1, dmin=self.dx_range[0],
                                dmax=self.dx_range[1])
        return _band_resample_1d(tmp, self.sy2, axis=0,
                                 dmin=self.dy_range[0],
                                 dmax=self.dy_range[1])


def resize_area(image: jax.Array, factor: int) -> jax.Array:
    """Integer-factor area downsample ((H, W[, C]) -> (H/f, W/f[, C])).

    The reference's README recommends exactly this for 8 MP inputs
    (4:1 -> 1080p, README.md:24-26); an integer box filter is a pure reshape
    + mean.
    """
    f = int(factor)
    squeeze = image.ndim == 2
    if squeeze:
        image = image[..., None]
    H, W, C = image.shape
    assert H % f == 0 and W % f == 0, (H, W, f)
    out = image.astype(jnp.float32).reshape(H // f, f, W // f, f, C).mean((1, 3))
    return out[..., 0] if squeeze else out


def resize_bilinear(image: jax.Array, out_hw: tuple[int, int]) -> jax.Array:
    """Bilinear resize to (H', W') via jax.image (XLA-fused gather math)."""
    squeeze = image.ndim == 2
    if squeeze:
        image = image[..., None]
    H2, W2 = out_hw
    out = jax.image.resize(image.astype(jnp.float32),
                           (H2, W2, image.shape[-1]), method="bilinear")
    return out[..., 0] if squeeze else out
