"""Verification probes: drive the public API off the happy path."""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from isaac_ros_apriltag_tpu.utils.cache import enable_compile_cache

enable_compile_cache()

import numpy as np

from isaac_ros_apriltag_tpu import CameraModel, Detector, DetectorConfig
from isaac_ros_apriltag_tpu.models.families import get_family
from isaac_ros_apriltag_tpu.utils.render import render_tags, upright_pose

cam = CameraModel.create(fx=420.0, fy=420.0, cx=320.0, cy=240.0, width=640, height=480)

# probe 1: invalid family name -> eager ValueError
try:
    DetectorConfig(tag_family="tag99h9")
    print("P1 FAIL: no error for invalid family")
except ValueError as e:
    print("P1 OK invalid family ->", e)

# probe 2: invalid backend
try:
    DetectorConfig(backend="cuda")
    print("P2 FAIL: no error")
except ValueError as e:
    print("P2 OK invalid backend ->", e)

# probe 3: unsupported encoding raises
det = Detector(DetectorConfig(backend="xla", tag_size=0.16), cam)
try:
    det.detect(np.zeros((480, 640), np.uint8), encoding="yuv422")
    print("P3 FAIL: no error")
except ValueError as e:
    print("P3 OK bad encoding ->", e)

# probe 4: empty scene -> zero detections (same shapes as smoke -> cached)
img = np.full((480, 640), 140, np.uint8)
rows = det.detect(img, encoding="mono8").to_list()
print("P4", "OK empty scene -> 0 detections" if len(rows) == 0
      else f"FAIL: {rows}")

# probe 5: 90-deg rotated tag -> same id, rotated pose
fam = get_family("tag36h11")
t = np.array([0.0, 0.0, 0.7])
R = upright_pose(t, inplane=np.pi / 2)
img = render_tags(np.asarray(cam.K), (480, 640),
                  [dict(family=fam, id=11, R=R, t=t, tag_size=0.16)])
d = det.detect(img, encoding="mono8")
rows = d.to_list()
if len(rows) == 1 and rows[0]["id"] == 11:
    R_est = np.asarray(d.rotation)[np.asarray(d.valid)][0]
    ang = np.degrees(np.arccos(np.clip((np.trace(R_est.T @ R) - 1) / 2, -1, 1)))
    print(f"P5 OK rotated tag: id=11, rotation err {ang:.3f} deg, "
          f"t_err {np.linalg.norm(np.asarray(rows[0]['translation'])-t)*1000:.2f} mm")
else:
    print("P5 FAIL:", rows)

# probe 6: two tags same id (duplicate in scene) -> both reported
t1, t2 = np.array([-0.25, 0.0, 0.9]), np.array([0.25, 0.0, 0.9])
img = render_tags(np.asarray(cam.K), (480, 640),
                  [dict(family=fam, id=5, R=upright_pose(t1), t=t1, tag_size=0.16),
                   dict(family=fam, id=5, R=upright_pose(t2), t=t2, tag_size=0.16)])
rows = det.detect(img, encoding="mono8").to_list()
print("P6", "OK duplicate-id tags -> 2 detections" if len(rows) == 2
      else f"UNEXPECTED: {len(rows)} detections: {rows}")
