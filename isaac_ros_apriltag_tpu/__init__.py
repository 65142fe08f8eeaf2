"""isaac_ros_apriltag_tpu — an AprilTag perception engine in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
NVIDIA-ISAAC-ROS/isaac_ros_apriltag:
fiducial detection + 6-DoF pose as pure-array jit-compiled pipelines, plus a
distributed tag-map SLAM layer (no reference analog) over jax.sharding
meshes.
"""

from .camera.model import CameraModel
from .config import BACKENDS, DetectorConfig
from .detector import Detector, build_detect_fn
from .models.families import TagFamily, family_names, get_family, register_family
from .types import Detections, FrameStats

__version__ = "0.1.0"

__all__ = [
    "BACKENDS", "CameraModel", "Detections", "Detector", "DetectorConfig",
    "FrameStats", "TagFamily", "build_detect_fn", "family_names",
    "get_family", "register_family", "__version__",
]
