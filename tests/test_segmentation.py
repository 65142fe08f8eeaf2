"""Segmentation front end: the plain adaptive threshold and the two-phase
scan CCL against independent oracles.

This is the reference's cross-backend parity pattern (ref:
test/isaac_ros_apriltag_backends_compare_test.py:162-249) applied at the
stage level: the threshold must equal a straightforward per-tile numpy loop
exactly, and the production CCL must reproduce the connected-component
partition of `scipy.ndimage.label` (4-connectivity for black, 8 for white).
"""

import numpy as np
import pytest
from scipy import ndimage

from isaac_ros_apriltag_tpu import CameraModel, Detector, DetectorConfig
from isaac_ros_apriltag_tpu.models.families import get_family
from isaac_ros_apriltag_tpu.ops.ccl import two_phase_ccl
from isaac_ros_apriltag_tpu.ops.threshold import adaptive_threshold
from isaac_ros_apriltag_tpu.utils.render import (project_corners, render_tags,
                                                 upright_pose)
from tests.conftest import make_scene


def _threshold_loop(gray, ts, min_diff):
    """AprilTag 3's adaptive threshold as a plain loop over tiles."""
    H, W = gray.shape
    th, tw = H // ts, W // ts
    tmin = np.empty((th, tw), np.float32)
    tmax = np.empty((th, tw), np.float32)
    for i in range(th):
        for j in range(tw):
            tile = gray[i * ts:(i + 1) * ts, j * ts:(j + 1) * ts]
            tmin[i, j], tmax[i, j] = tile.min(), tile.max()
    out = np.empty((H, W), np.uint8)
    for i in range(th):
        for j in range(tw):
            ii = slice(max(i - 1, 0), min(i + 2, th))
            jj = slice(max(j - 1, 0), min(j + 2, tw))
            lo, hi = tmin[ii, jj].min(), tmax[ii, jj].max()
            tile = gray[i * ts:(i + 1) * ts, j * ts:(j + 1) * ts]
            if hi - lo < min_diff:
                out[i * ts:(i + 1) * ts, j * ts:(j + 1) * ts] = 127
            else:
                thresh = np.float32(lo + (hi - lo) * np.float32(0.5))
                out[i * ts:(i + 1) * ts, j * ts:(j + 1) * ts] = np.where(
                    tile > thresh, 255, 0)
    return out


@pytest.mark.parametrize("shape,ts", [((480, 640), 4), ((96, 128), 4),
                                      ((200, 256), 8), ((64, 128), 2)])
def test_threshold_parity_random(shape, ts):
    import jax.numpy as jnp

    rng = np.random.default_rng(7)
    g = rng.uniform(0, 255, shape).astype(np.float32)
    g[10:40, 20:90] = 100.0  # flat low-contrast region
    a = np.asarray(adaptive_threshold(jnp.asarray(g), ts, 5))
    np.testing.assert_array_equal(a, _threshold_loop(g, ts, 5))


def test_threshold_parity_scene():
    import jax.numpy as jnp

    fam = get_family("tag36h11")
    K = np.array([[420.0, 0, 320], [0, 420.0, 240], [0, 0, 1]])
    t = np.array([0.0, 0.05, 0.8])
    img = render_tags(K, (480, 640),
                      [dict(family=fam, id=3, R=upright_pose(t), t=t,
                            tag_size=0.16)], noise=3.0).astype(np.float32)
    a = np.asarray(adaptive_threshold(jnp.asarray(img), 4, 5))
    np.testing.assert_array_equal(a, _threshold_loop(img, 4, 5))


def _final_roots(label, rank_table):
    """Follow the two-phase CCL's rank labels to their chain fixpoints:
    rank -> root pixel -> that pixel's rank, until nothing changes."""
    flat = np.asarray(label).reshape(-1)
    table = np.append(np.asarray(rank_table), -1)
    root = table[flat]
    while True:
        nxt = table[flat[root]]
        if (nxt == root).all():
            return root
        root = nxt


def _oracle_partition(tri):
    """scipy.ndimage.label per value: 4-connected black, 8-connected white
    (0 = invalid)."""
    black, nb = ndimage.label(tri == 0)
    white, _ = ndimage.label(tri == 255, structure=np.ones((3, 3), int))
    return np.where(tri == 0, black, np.where(tri == 255, white + nb, 0))


def _assert_refines(tri, roots, oracle):
    """Every class of `roots` lies inside one oracle component (the CCL
    never merges distinct components); returns the (ours, theirs) pairs."""
    valid = (tri != 127).reshape(-1)
    ours = roots[valid]
    theirs = oracle.reshape(-1)[valid]
    pairs = np.unique(np.stack([ours, theirs]), axis=1)
    assert pairs.shape[1] == len(np.unique(ours))
    return pairs


def _two_phase(tri, rounds1, rounds2):
    import jax.numpy as jnp

    label, converged, table, overflow = two_phase_ccl(
        jnp.asarray(tri), rounds1, rounds2,
        max_components=min(tri.size // 2, 1 << 16), contraction_steps=5)
    assert not bool(overflow)
    return _final_roots(label, table), bool(converged)


@pytest.mark.parametrize("shape", [(96, 128)])
def test_ccl_parity(shape):
    """Two-phase scan CCL vs scipy's partition on random speckle around a
    nested ring (the tag border topology that needs several rounds)."""
    rng = np.random.default_rng(3)
    tri = rng.choice(np.array([0, 127, 255], np.uint8), size=shape,
                     p=[0.4, 0.2, 0.4])
    tri[10:min(80, shape[0] - 4), 12:min(100, shape[1] - 4)] = 255
    tri[14:min(76, shape[0] - 8), 16:min(96, shape[1] - 8)] = 0
    tri[22:min(68, shape[0] - 16), 24:min(88, shape[1] - 16)] = 255
    roots, converged = _two_phase(tri, 16, 8)
    assert converged
    oracle = _oracle_partition(tri)
    pairs = _assert_refines(tri, roots, oracle)
    # converged: the partitions are equal, not just nested
    assert pairs.shape[1] == len(np.unique(oracle[tri != 127]))


def test_ccl_parity_noisy_scene():
    """Two-phase scan CCL vs scipy's partition on a thresholded noisy
    rendered scene at the production round counts. Percolation speckle
    need not converge in that many rounds, so every CCL class must lie
    inside one true component, and the tag's border ring (the largest black
    component) must come out whole."""
    import jax.numpy as jnp

    fam = get_family("tag36h11")
    K = np.array([[420.0, 0, 320], [0, 420.0, 240], [0, 0, 1]])
    t = np.array([0.0, 0.05, 0.8])
    img = render_tags(K, (480, 640),
                      [dict(family=fam, id=3, R=upright_pose(t), t=t,
                            tag_size=0.16)], noise=2.0).astype(np.float32)
    tri = np.asarray(adaptive_threshold(jnp.asarray(img), 4, 5))
    cfg = DetectorConfig()
    roots, _ = _two_phase(tri, cfg.ccl_scan_rounds, cfg.ccl_phase2_rounds)
    oracle = _oracle_partition(tri)
    _assert_refines(tri, roots, oracle)
    # a pixel inside the black border ring, just in from a corner
    corner = project_corners(K, upright_pose(t), t, 0.16)
    x, y = np.round(corner[0] + 0.06 * (corner.mean(0) - corner[0])).astype(int)
    assert tri[y, x] == 0
    in_ring = (oracle == oracle[y, x]).reshape(-1)
    assert len(np.unique(roots[in_ring])) == 1
    assert in_ring.sum() > 1000


def test_detector_backend_parity():
    """End-to-end: 'scan' backend detections == 'xla' backend detections
    (same count/id and bit-identical corners/poses), the reference's
    backends-compare contract at zero tolerance."""
    cam = CameraModel.create(fx=420.0, fy=420.0, cx=320.0, cy=240.0,
                             width=640, height=480)
    fam = get_family("tag36h11")
    t = np.array([-0.1, 0.05, 0.9])
    img = make_scene(cam, [dict(family=fam, id=21, R=upright_pose(t), t=t,
                                tag_size=0.16)])
    det_x = Detector(DetectorConfig(backend="xla", tag_size=0.16), cam)
    det_p = Detector(DetectorConfig(backend="scan", tag_size=0.16), cam)
    rx = det_x.detect(img, encoding="mono8").to_list()
    rp = det_p.detect(img, encoding="mono8").to_list()
    assert len(rx) == len(rp) == 1
    assert rx[0]["id"] == rp[0]["id"] == 21
    np.testing.assert_array_equal(np.asarray(rx[0]["corners"]),
                                  np.asarray(rp[0]["corners"]))
    np.testing.assert_array_equal(np.asarray(rx[0]["translation"]),
                                  np.asarray(rp[0]["translation"]))
