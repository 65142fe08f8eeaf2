"""Tests for the sort-based component resolution (ops/resolve.py) and the
production two-phase scan CCL (ops/ccl.two_phase_ccl).

Differential pattern (ref: test/isaac_ros_apriltag_backends_compare_test.py:
162-249 applied at stage level): scans+resolve must reproduce the
fully-converged (jump-based) CCL's components exactly, and the scan
backend's detections must match the jump-based oracle's.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from isaac_ros_apriltag_tpu.models.families import get_family
from isaac_ros_apriltag_tpu.ops.ccl import (component_sizes,
                                            connected_components,
                                            two_phase_ccl)
from isaac_ros_apriltag_tpu.ops.resolve import _KMAX, resolve_components
from isaac_ros_apriltag_tpu.ops.threshold import adaptive_threshold
from isaac_ros_apriltag_tpu.utils.render import render_tags, upright_pose


def _speckle_scene(shape=(96, 128), seed=3, ring=True):
    rng = np.random.default_rng(seed)
    tri = rng.choice(np.array([0, 127, 255], np.uint8), size=shape,
                     p=[0.4, 0.2, 0.4])
    if ring:
        tri[10:80, 12:100] = 255
        tri[14:76, 16:96] = 0
        tri[22:68, 24:88] = 255
    return tri


def _scan(tri, rounds, label0=None):
    """Jump-free scan rounds with the convergence flag (one CCL phase)."""
    return connected_components(jnp.asarray(tri), rounds, 0, label0=label0,
                                with_convergence=True)


def _old_dense(lab, valid, min_pixels):
    """Round-3 relabel semantics (gather-based) as the oracle."""
    sizes = np.asarray(component_sizes(jnp.asarray(lab)))
    flat = lab.reshape(-1)
    idx = np.arange(flat.size)
    elig = (flat == idx) & (sizes >= min_pixels)
    rank = np.cumsum(elig) - 1
    dense_of_root = np.where(elig & (rank < _KMAX), rank, _KMAX)
    dense = dense_of_root[flat].reshape(lab.shape)
    dense[~valid] = _KMAX
    return dense


def test_resolve_matches_old_relabel_on_converged_labels():
    tri = _speckle_scene()
    lab = np.asarray(connected_components(jnp.asarray(tri), 16, 3, 1))
    valid = tri != 127
    res = resolve_components(jnp.asarray(lab), jnp.asarray(valid),
                             min_component_pixels=25, chain_steps=2,
                             with_roots=True)
    assert bool(res.converged)
    assert not bool(res.overflow)
    np.testing.assert_array_equal(np.asarray(res.dense),
                                  _old_dense(lab, valid, 25))
    # converged labels are already roots
    np.testing.assert_array_equal(np.asarray(res.roots)[valid], lab[valid])


def test_fused_kernel_bit_matches_xla_scan_rounds():
    """The convergence-flag form (rounds-1 looped + one explicit round) is
    bit-identical to the plain loop of scan rounds, and so is phase 1 of
    the two-phase CCL."""
    tri = _speckle_scene()
    for rounds in (1, 4, 12):
        a = np.asarray(connected_components(jnp.asarray(tri), rounds, 0))
        b, _ = _scan(tri, rounds)
        c, _, table, _ = two_phase_ccl(jnp.asarray(tri), rounds, 0,
                                       max_components=4096,
                                       contraction_steps=5)
        assert table is None
        np.testing.assert_array_equal(a, np.asarray(b))
        np.testing.assert_array_equal(a, np.asarray(c))


def test_fused_kernel_convergence_flag():
    tri = np.full((16, 128), 127, np.uint8)
    tri[4:12, 8:120] = 0
    _, conv1 = _scan(tri, 1)
    _, conv4 = _scan(tri, 4)
    assert not bool(conv1)     # first round changes labels
    assert bool(conv4)         # a solid rectangle converges quickly


def test_scans_plus_resolve_chain_fixpoint_on_noisy_scene():
    """On a realistic noisy scene the scan kernel leaves parent chains up to
    ~14 deep; `chain_steps` pointer doublings must reach the fixpoint
    (converged=True) and every resolved root must actually be a fixpoint of
    the label map. Tag components (the detection contract) must match the
    fully-converged oracle; sprawling NOISE components may stay split (see
    ops/resolve.py docstring) — detection-level parity is asserted in
    test_noisy_detection_parity_interpret_vs_xla."""
    fam = get_family("tag36h11")
    K = np.array([[420.0, 0, 320], [0, 420.0, 240], [0, 0, 1]])
    t = np.array([0.0, 0.05, 0.8])
    img = render_tags(K, (480, 640),
                      [dict(family=fam, id=3, R=upright_pose(t), t=t,
                            tag_size=0.16)], noise=2.0).astype(np.float32)
    tri = np.asarray(adaptive_threshold(jnp.asarray(img), 4, 5))
    valid = tri != 127
    lab, _ = _scan(tri, 16)
    res = resolve_components(lab, jnp.asarray(valid),
                             min_component_pixels=25, chain_steps=5,
                             with_roots=True)
    assert bool(res.converged)
    roots = np.asarray(res.roots)
    flat = np.asarray(lab).reshape(-1)
    rv = roots[valid]
    np.testing.assert_array_equal(flat[rv], rv)  # roots are fixpoints
    # The tag's border ring — the largest black component — must match the
    # converged oracle exactly (same pixel set, same min-index root).
    ref = np.asarray(connected_components(jnp.asarray(tri), 24, 3, 1))
    black = tri == 0
    vals, counts = np.unique(ref[black], return_counts=True)
    r = vals[counts.argmax()]
    np.testing.assert_array_equal(roots == r, ref == r)


def test_noisy_detection_parity_interpret_vs_xla():
    """Detection-level parity on a noisy scene: the two-phase scan backend
    and the jump-based XLA oracle must agree on ids and corners
    even where speckle labeling differs (the reference's backends-compare
    contract, ref: test/isaac_ros_apriltag_backends_compare_test.py:162-249)."""
    from isaac_ros_apriltag_tpu import CameraModel, Detector, DetectorConfig

    cam = CameraModel.create(fx=420.0, fy=420.0, cx=320.0, cy=240.0,
                             width=640, height=480)
    fam = get_family("tag36h11")
    tags = []
    for i, (x, y) in enumerate([(-0.25, -0.15), (0.25, -0.15),
                                (-0.25, 0.18), (0.25, 0.18)]):
        t = np.array([x, y, 1.1])
        tags.append(dict(family=fam, id=5 * i + 2, R=upright_pose(t, 0.1 * i),
                         t=t, tag_size=0.16))
    img = render_tags(np.asarray(cam.K), (480, 640), tags, noise=2.0)
    det_x = Detector(DetectorConfig(backend="xla", tag_size=0.16), cam)
    det_p = Detector(DetectorConfig(backend="scan", tag_size=0.16), cam)
    rx = sorted(det_x.detect(img, encoding="mono8").to_list(),
                key=lambda d: d["id"])
    rp = sorted(det_p.detect(img, encoding="mono8").to_list(),
                key=lambda d: d["id"])
    assert [d["id"] for d in rx] == [5 * i + 2 for i in range(4)]
    assert [d["id"] for d in rp] == [d["id"] for d in rx]
    for a, b in zip(rx, rp):
        np.testing.assert_allclose(np.asarray(a["corners"]),
                                   np.asarray(b["corners"]), atol=0.15)


def test_resolve_follows_chains():
    """Labels forming a parent chain (a->b->c->root) resolve to the root."""
    W = 16
    lab = np.arange(4 * W, dtype=np.int32).reshape(4, W)
    valid = np.zeros((4, W), bool)
    # pixels 0,1,2,3 in row 0: 3 -> 2 -> 1 -> 0 chain; all one component
    lab[0, :4] = [0, 0, 1, 2]
    valid[0, :4] = True
    res = resolve_components(jnp.asarray(lab), jnp.asarray(valid),
                             min_component_pixels=1, chain_steps=3,
                             with_roots=True)
    assert bool(res.converged)
    np.testing.assert_array_equal(np.asarray(res.roots)[0, :4], [0, 0, 0, 0])
    d = np.asarray(res.dense)
    assert d[0, 0] == d[0, 1] == d[0, 2] == d[0, 3] == 0
    # insufficient steps: not converged (chain deeper than steps resolves
    # partially and the flag reports it)
    lab[0, :6] = [0, 0, 1, 2, 3, 4]
    valid[0, :6] = True
    res2 = resolve_components(jnp.asarray(lab), jnp.asarray(valid),
                              min_component_pixels=1, chain_steps=1,
                              with_roots=True)
    assert not bool(res2.converged)


def test_resolve_area_gate_and_overflow():
    tri = np.full((32, 128), 127, np.uint8)
    tri[2:6, 2:10] = 0       # 32 px component
    tri[10:12, 2:4] = 0      # 4 px component (gated out at min 25)
    valid = tri != 127
    lab = np.asarray(connected_components(jnp.asarray(tri), 8, 2))
    res = resolve_components(jnp.asarray(lab), jnp.asarray(valid),
                             min_component_pixels=25)
    d = np.asarray(res.dense)
    assert int(res.n_eligible) == 1
    assert (d[2:6, 2:10] == 0).all()
    assert (d[10:12, 2:4] == _KMAX).all()
    assert not bool(res.overflow)
    # capacity overflow: max_components smaller than distinct labels
    res2 = resolve_components(jnp.asarray(lab), jnp.asarray(valid),
                              min_component_pixels=25, max_components=1)
    assert bool(res2.overflow)


def test_resolve_under_vmap():
    tri = _speckle_scene(shape=(64, 128))
    lab = np.asarray(connected_components(jnp.asarray(tri), 16, 3, 1))
    valid = tri != 127
    import jax

    batched = jax.vmap(lambda l, v: resolve_components(
        l, v, min_component_pixels=25).dense)
    out = batched(jnp.stack([jnp.asarray(lab)] * 3),
                  jnp.stack([jnp.asarray(valid)] * 3))
    single = resolve_components(jnp.asarray(lab), jnp.asarray(valid),
                                min_component_pixels=25).dense
    for i in range(3):
        np.testing.assert_array_equal(np.asarray(out[i]), np.asarray(single))


def test_fused_kernel_under_vmap():
    """The two-phase CCL batched under vmap equals the single-frame run."""
    tri = _speckle_scene(shape=(32, 128), ring=False)
    import jax

    def ccl(t):
        return two_phase_ccl(t, 6, 3, max_components=2048,
                             contraction_steps=5)[0]

    batched = jax.vmap(ccl)
    out = batched(jnp.stack([jnp.asarray(tri)] * 2))
    single = ccl(jnp.asarray(tri))
    np.testing.assert_array_equal(np.asarray(out[0]), np.asarray(single))
    np.testing.assert_array_equal(np.asarray(out[1]), np.asarray(single))


def test_ccl_label0_parity():
    """A seeded scan phase (the two-phase CCL's second phase): seeding with
    the flat-index identity bit-matches the unseeded scan, and seeding with
    contracted roots only ever lowers labels, never across components."""
    tri = _speckle_scene(shape=(64, 128))
    ident = jnp.arange(tri.size, dtype=jnp.int32).reshape(tri.shape)
    a, _ = _scan(tri, 4)
    b, _ = _scan(tri, 4, label0=ident)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    from isaac_ros_apriltag_tpu.ops.resolve import resolve_roots

    valid = tri != 127
    roots = np.asarray(resolve_roots(a, jnp.asarray(valid)))
    c, _ = _scan(tri, 4, label0=jnp.asarray(roots))
    c = np.asarray(c)
    assert (c <= roots).all()
    ref = np.asarray(connected_components(jnp.asarray(tri), 24, 3, 1))
    # every seeded label points into its own (converged) component
    np.testing.assert_array_equal(ref.reshape(-1)[c[valid]], ref[valid])


import functools


@functools.lru_cache(maxsize=None)
def _sweep_detectors(H, W):
    from isaac_ros_apriltag_tpu import CameraModel, Detector, DetectorConfig

    cam = CameraModel.create(fx=420.0 * W / 640, fy=420.0 * W / 640,
                             cx=W / 2, cy=H / 2, width=W, height=H)
    return (cam,
            Detector(DetectorConfig(backend="scan", tag_size=0.16), cam),
            Detector(DetectorConfig(backend="xla", tag_size=0.16), cam))


@pytest.mark.parametrize("size", [(480, 640), (720, 1280)])
@pytest.mark.parametrize("noise", [2.0, 4.0, 6.0])
@pytest.mark.parametrize("seed", [0, 1])
def test_two_phase_ccl_noise_sweep(size, noise, seed):
    """Robustness sweep for the tuned two-phase CCL round counts
    (ccl_scan_rounds=8 / ccl_phase2_rounds=6, config.py): the production
    structure must keep detection parity with the jump-based XLA oracle
    across noise levels, seeds and resolutions — the single-phase design's
    failure was noise-dependent and NON-monotonic in rounds (8 rounds: 6/6;
    24: 0/6 at noise=4 on hardware), so one fixed scene cannot protect the
    constants. Also asserts `ccl_converged` telemetry is truthful: whenever
    the flag is True the detections must match the oracle (the flag may
    legitimately be False under extreme speckle — then parity is excused
    but the flag must have said so).

    Two seeds x three noise levels x two resolutions; detectors are
    compiled once per resolution (lru_cache) to keep suite time sane.
    """
    H, W = size
    if size == (720, 1280) and noise != 4.0:
        pytest.skip("larger resolution swept at the hardware-regression "
                    "noise level only (suite-time budget)")
    cam, det_p, det_x = _sweep_detectors(H, W)
    fam = get_family("tag36h11")
    tags = []
    for i, (x, y) in enumerate([(-0.25, -0.1), (0.25, 0.12)]):
        t = np.array([x, y, 1.0])
        tags.append(dict(family=fam, id=4 * i + 3, R=upright_pose(t, 0.1 * i),
                         t=t, tag_size=0.16))
    img = render_tags(np.asarray(cam.K), (H, W), tags, noise=noise, seed=seed)
    dp, sp = det_p.detect_with_stats(img, encoding="mono8")
    rx = sorted(d["id"] for d in det_x.detect(img, encoding="mono8").to_list())
    rp = sorted(d["id"] for d in dp.to_list())
    assert rx == [3, 7], (rx, noise, seed, size)   # oracle finds both
    if bool(sp.ccl_converged):
        assert rp == rx, (rp, rx, noise, seed, size)
    else:
        # Telemetry flagged non-convergence: parity is excused, but the
        # production path must still not hallucinate ids.
        assert set(rp) <= set(rx), (rp, rx, noise, seed, size)


def test_two_phase_ccl_survives_heavy_noise():
    """The regime that broke a single long scan phase on hardware: under
    heavy noise a distant min label propagates PARTWAY into the tag border
    and splits its labels (more rounds = worse). The production two-phase
    CCL (scan -> compacted contraction -> scan) must keep detecting; the
    detections must match the jump-based XLA oracle."""
    from isaac_ros_apriltag_tpu import CameraModel, Detector, DetectorConfig

    cam = CameraModel.create(fx=420.0, fy=420.0, cx=320.0, cy=240.0,
                             width=640, height=480)
    fam = get_family("tag36h11")
    tags = []
    for i, (x, y) in enumerate([(-0.25, -0.1), (0.25, 0.12)]):
        t = np.array([x, y, 1.0])
        tags.append(dict(family=fam, id=4 * i + 3, R=upright_pose(t, 0.1 * i),
                         t=t, tag_size=0.16))
    img = render_tags(np.asarray(cam.K), (480, 640), tags, noise=4.0)
    det_p = Detector(DetectorConfig(backend="scan", tag_size=0.16), cam)
    det_x = Detector(DetectorConfig(backend="xla", tag_size=0.16), cam)
    rp = sorted(d["id"] for d in det_p.detect(img, encoding="mono8").to_list())
    rx = sorted(d["id"] for d in det_x.detect(img, encoding="mono8").to_list())
    assert rx == [3, 7], rx          # the oracle finds both
    assert rp == rx, (rp, rx)


def test_rank_flow_matches_flat_flow():
    """The RANK-space two-phase flow (resolve_roots_rank -> opaque phase-2
    scan -> resolve_components(rank_table=...)) produces dense ids EXACTLY
    equal to the flat-label flow (resolve_roots -> phase-2 ->
    resolve_components): ranks are order-isomorphic to root flat indices,
    and min-propagation commutes with monotone relabelings."""
    from isaac_ros_apriltag_tpu.ops.resolve import (resolve_roots,
                                                    resolve_roots_rank)

    tri = _speckle_scene(shape=(64, 128))
    valid = jnp.asarray(tri != 127)
    R = 1024
    lab1, _ = _scan(tri, 4)

    roots = resolve_roots(lab1, valid, max_components=R)
    lab2f, _ = _scan(tri, 3, label0=roots)
    res_flat = resolve_components(lab2f, valid, min_component_pixels=4,
                                  max_components=R, chain_steps=3)

    rank_img, table, ovf = resolve_roots_rank(lab1, valid, max_components=R)
    lab2r, _ = _scan(tri, 3, label0=rank_img)
    res_rank = resolve_components(lab2r, valid, min_component_pixels=4,
                                  max_components=R, chain_steps=3,
                                  rank_table=table)

    np.testing.assert_array_equal(np.asarray(res_flat.dense),
                                  np.asarray(res_rank.dense))
    assert int(res_flat.n_eligible) == int(res_rank.n_eligible)
    assert not bool(ovf)
