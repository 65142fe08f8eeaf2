"""6-DoF tag pose from corners + intrinsics (batched homography decomposition).

The reference delegates pose to cuAprilTagsDetect (ref: apriltag_node.cpp:
491-493) or vpiSubmitAprilTagPoseEstimation — forced to CPU there
(ref: apriltag_node.cpp:298-301). Here pose stays on the device: a batched
4-point homography solve, K^-1 normalization, and a polar projection onto
SO(3) for all detections at once.

Frame convention (matches the reference's output, validated against the
golden fixture q = (0, 0, 0, 1), ref: test/isaac_ros_apriltag_pol_test.py:
154-175): detection corner k corresponds to tag-frame point
((-1,-1), (1,-1), (1,1), (-1,1))[k] * tag_size/2; for a fronto-parallel
upright tag, R_camera_tag = diag(-1, -1, 1).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.geometry import (homography_from_correspondences, inverse3x3,
                              orthonormalize_rotation, quat_from_rotmat)

# Tag-frame (x, y) of detection corners, in units of tag_size/2.
TAG_CORNERS = np.array([[-1.0, -1.0], [1.0, -1.0], [1.0, 1.0], [-1.0, 1.0]],
                       np.float32)


class Poses(NamedTuple):
    rotation: jax.Array      # (C, 3, 3) R_camera_tag
    translation: jax.Array   # (C, 3) meters
    quaternion: jax.Array    # (C, 4) (w, x, y, z)


def estimate_poses(corners: jax.Array, K: jax.Array, tag_size: float | jax.Array
                   ) -> Poses:
    """corners: (C, 4, 2) rotation-corrected detection corners (pixels)."""
    C = corners.shape[0]
    obj = jnp.asarray(TAG_CORNERS) * (tag_size * 0.5)          # (4, 2)
    H = homography_from_correspondences(
        jnp.broadcast_to(obj, (C, 4, 2)), corners)             # (C, 3, 3)

    Kinv = inverse3x3(K.astype(jnp.float32))
    M = jnp.einsum("ij,cjk->cik", Kinv, H,
                   precision=jax.lax.Precision.HIGHEST)        # (C, 3, 3)
    m1, m2, m3 = M[..., 0], M[..., 1], M[..., 2]
    n1 = jnp.linalg.norm(m1, axis=-1)
    n2 = jnp.linalg.norm(m2, axis=-1)
    scale = 2.0 / jnp.maximum(n1 + n2, 1e-12)
    # Positive depth: the tag is in front of the camera.
    scale = scale * jnp.sign(m3[..., 2])
    r1 = m1 * scale[..., None]
    r2 = m2 * scale[..., None]
    t = m3 * scale[..., None]
    r3 = jnp.cross(r1, r2)
    R = jnp.stack([r1, r2, r3], -1)                            # columns
    R = orthonormalize_rotation(R)
    return Poses(rotation=R, translation=t, quaternion=quat_from_rotmat(R))
