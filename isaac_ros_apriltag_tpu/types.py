"""Result pytrees: fixed-capacity detection arrays.

Replacement for the reference's AprilTagDetectionArray message
(ref: isaac_ros_apriltag_interfaces, used at apriltag_node.cpp:324-363).
All arrays have a static leading dim of max_tags; `valid` masks real rows —
the moral equivalent of the reference's max_tags-capacity VPI array + size
query (ref: apriltag_node.cpp:285-289, :305-306).

Corner convention (identical to the reference's normalized output, see
apriltag_node.cpp:337-344 where VPI corners are reversed to match cuAprilTags):
corners[0..3] trace the border-square boundary such that for an upright,
fronto-parallel tag they land at image (BR, BL, TL, TR); corner k corresponds
to tag-frame point ((-,-), (+,-), (+,+), (-,+)) * tag_size/2.
Pose is T_camera_tag: `translation` (3,) + `quaternion` (4,) (w, x, y, z); for
the fronto-parallel golden fixture this yields q = (0, 0, 0, 1)
(ref: test/isaac_ros_apriltag_pol_test.py:164-175).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Detections:
    """Batched fixed-capacity detections for one frame (leading dim max_tags)."""

    valid: jax.Array          # (T,) bool
    id: jax.Array             # (T,) int32
    hamming: jax.Array        # (T,) int32 — bit errors corrected
    decision_margin: jax.Array  # (T,) float32 — decode confidence
    center: jax.Array         # (T, 2) float32 pixels (x, y)
    corners: jax.Array        # (T, 4, 2) float32 pixels
    translation: jax.Array    # (T, 3) float32 meters, camera frame
    quaternion: jax.Array     # (T, 4) float32 (w, x, y, z)
    rotation: jax.Array       # (T, 3, 3) float32 R_camera_tag

    @property
    def count(self) -> jax.Array:
        return jnp.sum(self.valid.astype(jnp.int32))

    @staticmethod
    def empty(max_tags: int) -> "Detections":
        T = max_tags
        return Detections(
            valid=jnp.zeros((T,), bool),
            id=jnp.full((T,), -1, jnp.int32),
            hamming=jnp.zeros((T,), jnp.int32),
            decision_margin=jnp.zeros((T,), jnp.float32),
            center=jnp.zeros((T, 2), jnp.float32),
            corners=jnp.zeros((T, 4, 2), jnp.float32),
            translation=jnp.zeros((T, 3), jnp.float32),
            quaternion=jnp.zeros((T, 4), jnp.float32),
            rotation=jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), (T, 3, 3)),
        )

    def frame_ids(self, family: str) -> list[str]:
        """TF child frame names for the valid detections, in the reference's
        exact convention: "<family>:<id>" (ref: apriltag_node.cpp:353-356,
        id format :535-536). Consumers hang each tag pose under the camera
        frame with these names — the tf2-broadcaster analog."""
        import numpy as np

        valid = np.asarray(self.valid)
        ids = np.asarray(self.id)
        return [f"{family}:{int(ids[i])}" for i in np.nonzero(valid)[0]]

    def to_list(self) -> list[dict]:
        """Host-side: unpack valid rows into python dicts (for viz / logging)."""
        import numpy as np

        valid = np.asarray(self.valid)
        out = []
        for i in np.nonzero(valid)[0]:
            out.append(dict(
                id=int(np.asarray(self.id)[i]),
                hamming=int(np.asarray(self.hamming)[i]),
                decision_margin=float(np.asarray(self.decision_margin)[i]),
                center=np.asarray(self.center)[i].tolist(),
                corners=np.asarray(self.corners)[i].tolist(),
                translation=np.asarray(self.translation)[i].tolist(),
                quaternion=np.asarray(self.quaternion)[i].tolist(),
            ))
        return out


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FrameStats:
    """Per-frame pipeline statistics (observability; survey §5.5)."""

    num_edge_points: jax.Array   # int32 — boundary points before capacity cap
    num_clusters: jax.Array      # int32 — candidate clusters before cap
    num_quads: jax.Array         # int32 — quads that passed geometric filters
    num_detections: jax.Array    # int32 — final decoded detections
    edge_stride: jax.Array       # int32 — boundary decimation applied (1 = none)
    ccl_converged: jax.Array     # bool — final CCL round changed nothing; False
    #                              means ccl_rounds was too small for this scene
    #                              (adversarial percolation noise) and labels may
    #                              be split finer than true components
    overflow: jax.Array          # bool — a capacity was exceeded; results are
    #                              decimated/truncated (moral equivalent of the
    #                              reference's detector-error log,
    #                              ref: apriltag_node.cpp:494-497)
