"""Adaptive thresholding: tile min/max -> trinary image {0, 127, 255}.

Equivalent of the AprilTag-3 adaptive threshold that the
reference's closed-source backends implement on GPU (the `tile_size` detector
parameter, ref: isaac_ros_apriltag/src/apriltag_node.cpp:450-452, :566).

Algorithm (standard AprilTag 3):
  1. split the image into tile_size x tile_size tiles; min/max per tile;
  2. dilate min/max over the 3x3 tile neighborhood (handles tiles that
     straddle a tag edge);
  3. if max-min < min_white_black_diff the tile is low-contrast -> emit 127
     (excluded from segmentation); else threshold at min + (max-min)/2.

Everything is dense reshapes/reductions that XLA fuses; there is no
hand-written kernel for this stage.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _dilate3x3(x: jax.Array, op) -> jax.Array:
    """3x3 neighborhood reduce over a 2D array via shifted pads (edge-clamped)."""
    out = x
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            shifted = jnp.roll(x, (dy, dx), (0, 1))
            # Edge clamp: rolling wraps; overwrite wrapped rows/cols with x.
            if dy == -1:
                shifted = shifted.at[-1, :].set(x[-1, :])
            if dy == 1:
                shifted = shifted.at[0, :].set(x[0, :])
            if dx == -1:
                shifted = shifted.at[:, -1].set(x[:, -1])
            if dx == 1:
                shifted = shifted.at[:, 0].set(x[:, 0])
            out = op(out, shifted)
    return out


def adaptive_threshold(gray: jax.Array, tile_size: int = 4,
                       min_white_black_diff: int = 5) -> jax.Array:
    """(H, W) float32 grayscale -> (H, W) uint8 trinary {0, 127, 255}.

    H and W must be multiples of tile_size (the detector pads frames at
    construction time to guarantee this).
    """
    H, W = gray.shape
    ts = tile_size
    assert H % ts == 0 and W % ts == 0, (H, W, ts)
    tiles = gray.reshape(H // ts, ts, W // ts, ts)
    tmin = tiles.min(axis=(1, 3))
    tmax = tiles.max(axis=(1, 3))
    tmin = _dilate3x3(tmin, jnp.minimum)
    tmax = _dilate3x3(tmax, jnp.maximum)
    thresh = tmin + (tmax - tmin) * 0.5
    low_contrast = (tmax - tmin) < min_white_black_diff
    # Broadcast tile values back to pixels.
    thresh_px = jnp.repeat(jnp.repeat(thresh, ts, 0), ts, 1)
    low_px = jnp.repeat(jnp.repeat(low_contrast, ts, 0), ts, 1)
    binary = jnp.where(gray > thresh_px, jnp.uint8(255), jnp.uint8(0))
    return jnp.where(low_px, jnp.uint8(127), binary)
