"""Detection under sensor noise — the round-1 blind spot.

The reference's POL fixture is a real 1920x1080 photo with real sensor noise
(ref: isaac_ros_apriltag/test/test_cases/apriltag0/, pol_test.py:116-175);
round 1 only ever tested noiseless renders and shipped a detector that found
0 tags on the noisy benchmark scene (2M boundary points vs 131k capacity,
truncated in scan order). These tests pin the fix: pressure-aware global
stride decimation + overflow reporting.
"""

import numpy as np
import pytest

from isaac_ros_apriltag_tpu import CameraModel, Detector, DetectorConfig
from isaac_ros_apriltag_tpu.models.families import get_family
from isaac_ros_apriltag_tpu.utils.render import (project_corners, render_tags,
                                                 upright_pose)

TAG_SIZE = 0.16


@pytest.fixture(scope="module")
def camera():
    return CameraModel.create(fx=420.0, fy=420.0, cx=320.0, cy=240.0,
                              width=640, height=480)


def _scene(camera, positions, noise, ids=None, z=1.1, tag_size=TAG_SIZE):
    fam = get_family("tag36h11")
    tags, gt = [], {}
    for i, (x, y) in enumerate(positions):
        t = np.array([x, y, z])
        R = upright_pose(t, 0.1 * i)
        tid = ids[i] if ids else 3 * i + 1
        tags.append(dict(family=fam, id=tid, R=R, t=t, tag_size=tag_size))
        gt[tid] = (R, t)
    img = render_tags(np.asarray(camera.K), (camera.height, camera.width),
                      tags, noise=noise)
    return img, gt


@pytest.mark.parametrize("noise", [2.0, 4.0])
def test_noisy_scene_detects_all(camera, noise):
    img, gt = _scene(camera, [(-0.25, -0.15), (0.25, -0.15),
                              (-0.25, 0.18), (0.25, 0.18)], noise)
    det = Detector(DetectorConfig(tag_size=TAG_SIZE, backend="xla"), camera)
    rows = det.detect(img, encoding="mono8").to_list()
    assert sorted(r["id"] for r in rows) == sorted(gt), f"noise={noise}"
    for r in rows:
        R, t = gt[r["id"]]
        want = project_corners(np.asarray(camera.K), R, t, TAG_SIZE)
        err = np.linalg.norm(np.asarray(r["corners"]) - want, axis=-1).max()
        assert err < 1.0, (r["id"], err)


def test_overflow_keeps_biggest_clusters(camera):
    """Cluster-slot pressure must degrade gracefully: with max_clusters far
    below the number of eligible boundary clusters, the LARGEST clusters
    (real tag borders) keep their slots, detection survives, and the
    truncation is flagged (the reference logs detector errors, ref:
    apriltag_node.cpp:494-497). The sort-free pipeline has no edge-point
    capacity at all, so point-buffer overflow cannot occur by construction —
    the remaining capacity is the top-C cluster cut exercised here."""
    # Two large tags under noise; C=8 < eligible clusters (each tag
    # contributes its outer border cluster plus several interior clusters,
    # and noise adds more).
    positions = [(-0.4, -0.25), (0.3, 0.2)]
    big_ids = [100, 200]
    img, gt = _scene(camera, positions, noise=3.0, ids=big_ids,
                     z=1.2, tag_size=0.28)
    cfg = DetectorConfig(tag_size=0.28, backend="xla", max_clusters=16,
                         max_tags=16)
    det, stats = Detector(cfg, camera).detect_with_stats(img, encoding="mono8")
    assert bool(stats.overflow)
    assert int(stats.num_edge_points) > 1000
    got = np.asarray(det.id)[np.asarray(det.valid)].tolist()
    assert set(big_ids) <= set(got)


def test_clean_scene_has_no_overflow(camera):
    img, _ = _scene(camera, [(0.0, 0.0)], noise=0.0)
    det, stats = Detector(DetectorConfig(tag_size=TAG_SIZE, backend="xla"),
                          camera).detect_with_stats(img, encoding="mono8")
    assert not bool(stats.overflow)
    assert int(stats.edge_stride) == 1
    assert int(stats.num_detections) == 1


def test_bench_scene_1080p_noise2(camera):
    """The exact round-1 benchmark failure: 6 tags, 1080p, noise=2.0 ->
    was 0 detections in an early revision. Must now find all 6."""
    H, W = 1080, 1920
    cam = CameraModel.create(fx=900.0, fy=900.0, cx=W / 2, cy=H / 2,
                             width=W, height=H)
    fam = get_family("tag36h11")
    tags = []
    for i, (x, y) in enumerate([(-0.8, -0.45), (0.0, -0.45), (0.8, -0.45),
                                (-0.8, 0.45), (0.0, 0.45), (0.8, 0.45)]):
        t = np.array([x, y, 2.5])
        tags.append(dict(family=fam, id=7 * i + 1, R=upright_pose(t, 0.1 * i),
                         t=t, tag_size=0.3))
    img = render_tags(np.asarray(cam.K), (H, W), tags, noise=2.0)
    det = Detector(DetectorConfig(tag_size=0.3, backend="xla"), cam)
    rows = det.detect(img, encoding="mono8").to_list()
    assert sorted(r["id"] for r in rows) == [1, 8, 15, 22, 29, 36]


def test_ccl_convergence_reported(camera):
    """FrameStats.ccl_converged surfaces iteration-budget exhaustion (the
    round-2 review's blind spot: ccl_rounds too small for adversarial noise
    silently mislabeled). A clean scene must converge; a tiny round budget
    on a noisy scene must NOT report convergence."""
    img, _ = _scene(camera, [(0.0, 0.0)], noise=0.0)
    _, stats = Detector(DetectorConfig(tag_size=TAG_SIZE, backend="xla"),
                        camera).detect_with_stats(img, encoding="mono8")
    assert bool(stats.ccl_converged)

    noisy, _ = _scene(camera, [(0.0, 0.0)], noise=4.0)
    cfg = DetectorConfig(tag_size=TAG_SIZE, backend="xla", ccl_rounds=1,
                         ccl_jumps=0)
    _, stats2 = Detector(cfg, camera).detect_with_stats(noisy, encoding="mono8")
    assert not bool(stats2.ccl_converged)
