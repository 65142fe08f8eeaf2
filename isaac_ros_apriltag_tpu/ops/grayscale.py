"""Color -> grayscale conversion.

Replaces the reference's VPI ConvertImageFormat stage
(ref: isaac_ros_apriltag/src/apriltag_node.cpp:276-282) and its five supported
encodings (rgb8/bgr8/rgba8/bgra8/mono8, ref: apriltag_node.cpp:76-82).
BT.601 weights match VPI/OpenCV. The weighted sum is written elementwise (a
length-3 contraction), so no matmul precision setting can round it.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

ENCODINGS = ("rgb8", "bgr8", "rgba8", "bgra8", "mono8")

_BT601 = (0.299, 0.587, 0.114)


def grayscale(image: jax.Array, encoding: str = "rgb8") -> jax.Array:
    """(H, W, C) or (H, W) uint8 -> (H, W) float32 grayscale in [0, 255].

    Raises on unknown encodings, mirroring the reference's encoding guard
    (ref: apriltag_node.cpp:469-476).
    """
    if encoding not in ENCODINGS:
        raise ValueError(f"Unsupported image encoding {encoding!r}; expected {ENCODINGS}")
    if encoding == "mono8":
        if image.ndim == 3:
            image = image[..., 0]
        return image.astype(jnp.float32)
    r, g, b = _BT601[0], _BT601[1], _BT601[2]
    if encoding in ("bgr8", "bgra8"):
        r, b = b, r
    rgb = image[..., :3].astype(jnp.float32)
    return (rgb[..., 0] * jnp.float32(r) + rgb[..., 1] * jnp.float32(g)
            + rgb[..., 2] * jnp.float32(b))
