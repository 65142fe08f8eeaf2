"""Dev smoke test: render a small scene, run the XLA detector, print results."""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from isaac_ros_apriltag_tpu.utils.cache import enable_compile_cache

enable_compile_cache()

import numpy as np

from isaac_ros_apriltag_tpu import CameraModel, Detector, DetectorConfig
from isaac_ros_apriltag_tpu.models.families import get_family
from isaac_ros_apriltag_tpu.utils.render import project_corners, render_tags, upright_pose

cam = CameraModel.create(fx=420.0, fy=420.0, cx=320.0, cy=240.0, width=640, height=480)
fam = get_family("tag36h11")
t = np.array([0.05, -0.02, 0.8])
R = upright_pose(t)
tag_size = 0.16
img = render_tags(np.asarray(cam.K), (480, 640),
                  [dict(family=fam, id=3, R=R, t=t, tag_size=tag_size)])
print("image:", img.shape, img.dtype, img.min(), img.max())

cfg = DetectorConfig(backend="xla", tag_size=tag_size, min_decision_margin=10.0)
det = Detector(cfg, cam)
d, stats = det.detect_with_stats(img, encoding="mono8")
print("stats: edge_points", int(stats.num_edge_points), "clusters",
      int(stats.num_clusters), "quads", int(stats.num_quads),
      "detections", int(stats.num_detections))
for row in d.to_list():
    print(row)
print("gt corners:\n", project_corners(np.asarray(cam.K), R, t, tag_size))
print("gt t:", t)
