"""Proof that the detect-to-pose path runs on an NVIDIA GPU.

    python chip_smoke.py            # one card: the phases below
    python chip_smoke.py --multi    # four cards: rig, spatial, distributed BA

One process drives the card(s) through the entry points a user calls
(`Detector`, the vmapped `build_detect_fn`, `GraphPipeline`,
`StreamingRunner`; with --multi `RigDetector`, `SpatialDetector` and the
distributed BA solver) and checks what comes out: against the renderer's
ground truth at the reference's POL tolerances, against the `xla` oracle at
the reference's backends-compare tolerances, batched against single-frame,
and the f32 stages against the CPU. Each phase prints one line; the card's
name and power limit (nvidia-smi) are printed before the last line, which
is one JSON object. Exits non-zero, printing no JSON, when JAX finds no GPU
or any phase fails. Claims no speed: the seconds printed are compile times.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

# Reference POL tolerances vs ground truth (BASELINE.md accuracy table).
POL_PX, POL_T, POL_Q = 2.0, 0.01, 0.01
# Batched vs single-frame: the same program under vmap.
SAME_PX, SAME_T, SAME_Q = 1e-3, 1e-5, 1e-5
# Card vs CPU on identical inputs, f32 stages pinned to HIGHEST precision
# (TF32 rounding would show as ~1e-3 relative).
PRECISION_TOL = {"grayscale": 1e-3, "homography_px": 1e-3,
                 "gray_model": 1e-3, "decode_margin": 1e-2,
                 "pose_t_m": 1e-4, "pose_R": 1e-4}


class PhaseError(AssertionError):
    pass


def _check(ok, msg):
    if not ok:
        raise PhaseError(msg)


# --------------------------------------------------------------------------
# comparisons (host numpy)

def compare_detections(a, b):
    """Same ids; corners, translation and quaternion within the
    backends-compare tolerances. Returns (ids, max corner px, max t m,
    max q)."""
    from isaac_ros_apriltag_tpu.utils.compare import (detection_errors, rows,
                                                      within)

    errors = detection_errors(a, b)
    _check(within(errors), f"ids {sorted(rows(a))} vs {sorted(rows(b))}; "
           "corner {:.3g} px, t {:.3g} m, q {:.3g}".format(*errors[1:]))
    return (sorted(rows(a)),) + tuple(errors[1:])


def compare_rowwise(a, b, px, t_m, q, b_idx=None):
    """Row-for-row equality of one frame of batch `a` (or all of `a`) with
    `b`: valid mask and ids exact, floats within tolerance."""
    from isaac_ros_apriltag_tpu.utils.compare import q_err

    def pick(x):
        x = np.asarray(x)
        return x if b_idx is None else x[b_idx]
    va, vb = pick(a.valid), np.asarray(b.valid)
    _check((va == vb).all(), "valid masks differ")
    _check((pick(a.id)[va] == np.asarray(b.id)[vb]).all(), "ids differ")
    if not va.any():
        return 0.0, 0.0, 0.0
    ec = float(np.abs(pick(a.corners)[va] - np.asarray(b.corners)[vb]).max())
    et = float(np.abs(pick(a.translation)[va]
                      - np.asarray(b.translation)[vb]).max())
    qa, qb = pick(a.quaternion)[va], np.asarray(b.quaternion)[vb]
    eq = float(max(q_err(x, y) for x, y in zip(qa, qb)))
    _check(ec <= px and et <= t_m and eq <= q,
           f"corner {ec:.3g} px, t {et:.3g} m, q {eq:.3g} over "
           f"({px}, {t_m}, {q})")
    return ec, et, eq


def compare_ground_truth(det, camera, tags):
    """Every rendered tag found, within the reference's POL tolerances."""
    from isaac_ros_apriltag_tpu.utils.compare import q_err, rows as det_rows
    from isaac_ros_apriltag_tpu.utils.geometry import quat_from_rotmat
    from isaac_ros_apriltag_tpu.utils.render import project_corners

    rows = det_rows(det)
    want = sorted(tg["id"] for tg in tags)
    _check(sorted(rows) == want, f"ids {sorted(rows)} != {want}")
    K = np.asarray(camera.K, np.float64)
    ec = et = eq = 0.0
    for tg in tags:
        corners, center, t, q = rows[tg["id"]]
        gt_c = project_corners(K, tg["R"], tg["t"], tg["tag_size"])
        gt_ctr = (K @ tg["t"])[:2] / tg["t"][2]
        gt_q = np.asarray(quat_from_rotmat(np.asarray(tg["R"], np.float32)))
        ec = max(ec, float(np.abs(corners - gt_c).max()),
                 float(np.abs(center - gt_ctr).max()))
        et = max(et, float(np.abs(t - tg["t"]).max()))
        eq = max(eq, q_err(q, gt_q))
    _check(ec <= POL_PX and et <= POL_T and eq <= POL_Q,
           f"vs ground truth: corner/center {ec:.3g} px, t {et:.3g} m, "
           f"q {eq:.3g}")
    return want, ec, et, eq


def noisy_frames(base: np.ndarray, n: int, noise: float = 2.0):
    """n frames: one noise-free render plus independent Gaussian noise."""
    rng = np.random.default_rng(0)
    return np.stack([np.clip(base + rng.normal(0.0, noise, base.shape), 0,
                             255).astype(np.uint8) for _ in range(n)])


# --------------------------------------------------------------------------
# phases

def timed_first_call(log, name, fn, *args):
    """First call of a jitted entry: compile + one run, synchronised."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    log[name] = round(time.perf_counter() - t0, 2)
    return out


def phase_reference_node(compile_s, H=720, W=1280):
    """The reference node's config: Detector at 1280x720 rgb8, tag36h11,
    tile 4, max_tags 64 on the six-tag scene."""
    from isaac_ros_apriltag_tpu import Detector, DetectorConfig
    from isaac_ros_apriltag_tpu.utils.render import six_tag_scene

    cam, gray, tags = six_tag_scene(H, W)
    rgb = np.repeat(gray[..., None], 3, axis=-1)
    det = Detector(DetectorConfig(tag_size=0.3), cam)
    oracle = Detector(DetectorConfig(backend="xla", tag_size=0.3), cam)
    d = timed_first_call(compile_s, f"Detector {H}p rgb8 scan",
                         det.detect, rgb)
    dx = timed_first_call(compile_s, f"Detector {H}p rgb8 xla",
                          oracle.detect, rgb)
    ids, ec, et, eq = compare_ground_truth(d, cam, tags)
    _, xc, xt, xq = compare_detections(d, dx)
    return (f"ids {ids}; vs ground truth corner {ec:.3g} px, t {et:.3g} m, "
            f"q {eq:.3g}; vs xla oracle corner {xc:.3g} px, t {xt:.3g} m, "
            f"q {xq:.3g}"), (rgb, d, cam)


def phase_bench_config(compile_s, batch=8, H=1080, W=1920):
    """1080p mono8, batch 8, vmapped build_detect_fn: every frame of the
    batch equals the single-frame run, for production and oracle."""
    import jax
    import jax.numpy as jnp

    from isaac_ros_apriltag_tpu import DetectorConfig
    from isaac_ros_apriltag_tpu.detector import build_detect_fn
    from isaac_ros_apriltag_tpu.utils.render import six_tag_scene

    cam, base, tags = six_tag_scene(H, W, noise=0.0)
    frames = noisy_frames(base, batch)
    x = jnp.asarray(frames)
    notes, singles, memory = [], {}, ""
    for backend in ("scan", "xla"):
        fn = build_detect_fn(DetectorConfig(backend=backend, tag_size=0.3),
                             cam, encoding="mono8")
        t0 = time.perf_counter()
        batched = jax.jit(jax.vmap(fn)).lower(x).compile()
        compile_s[f"detect {H}p batch {batch} {backend}"] = round(
            time.perf_counter() - t0, 2)
        if backend == "scan":
            ma = batched.memory_analysis()
            memory = (f"memory_analysis: args {ma.argument_size_in_bytes} B, "
                      f"out {ma.output_size_in_bytes} B, "
                      f"temp {ma.temp_size_in_bytes} B, "
                      f"code {ma.generated_code_size_in_bytes} B")
        db, sb = jax.block_until_ready(batched(x))
        single = jax.jit(fn)
        worst = [0.0, 0.0, 0.0]
        outs = []
        for b in range(batch):
            ds, ss = (timed_first_call(compile_s, f"detect {H}p {backend}",
                                       single, x[b]) if b == 0
                      else jax.block_until_ready(single(x[b])))
            outs.append(ds)
            e = compare_rowwise(db, ds, SAME_PX, SAME_T, SAME_Q, b_idx=b)
            worst = [max(u, v) for u, v in zip(worst, e)]
            compare_ground_truth(ds, cam, tags)
        singles[backend] = (single, outs)
        notes.append(f"{backend}: {batch}/{batch} frames equal single-frame "
                     f"(max corner {worst[0]:.3g} px, t {worst[1]:.3g} m, "
                     f"q {worst[2]:.3g}), {int(np.asarray(sb.num_detections).sum())} "
                     "detections")
    return "; ".join(notes) + "; " + memory, (frames, singles)


def phase_graph(compile_s, scale=1.0):
    """GraphPipeline at 720p with the shipped plumb_bob calibration
    (`scale` shrinks camera and frame, for rehearsals)."""
    from isaac_ros_apriltag_tpu import CameraModel, DetectorConfig
    from isaac_ros_apriltag_tpu.pipeline import GraphPipeline
    from isaac_ros_apriltag_tpu.utils.compare import rows
    from isaac_ros_apriltag_tpu.utils.render import (USB_CAM, distort_image,
                                                     six_tag_scene)

    H, W = int(USB_CAM["height"] * scale), int(USB_CAM["width"] * scale)
    cam = CameraModel.create(
        **{k: USB_CAM[k] * scale for k in ("fx", "fy", "cx", "cy")},
        width=W, height=H, dist=USB_CAM["dist"])
    _, ideal, tags = six_tag_scene(H, W, camera=cam)
    frame = distort_image(ideal, cam)
    gp = GraphPipeline(DetectorConfig(tag_size=0.3), cam, encoding="mono8")
    det, _ = timed_first_call(compile_s, f"GraphPipeline {H}p plumb_bob",
                              gp, frame)
    ids = sorted(rows(det))
    want = sorted(tg["id"] for tg in tags)
    _check(ids == want, f"ids {ids} != {want}")
    return f"ids {ids}"


def phase_stream(frames, singles, n=16):
    """StreamingRunner over n host numpy frames (uploads included) equals
    the direct single-frame calls."""
    from isaac_ros_apriltag_tpu.streaming import StreamingRunner

    single, direct = singles["scan"]
    host = [frames[i % len(frames)] for i in range(n)]
    t0 = time.perf_counter()
    got = [d for d, _ in StreamingRunner(single, depth=2).run(host)]
    dt = time.perf_counter() - t0
    _check(len(got) == n, f"{len(got)} results for {n} frames")
    worst = 0.0
    for i, d in enumerate(got):
        e = compare_rowwise(d, direct[i % len(frames)], SAME_PX, SAME_T,
                            SAME_Q)
        worst = max(worst, *e)
    return (f"{n} host frames, outputs equal the direct calls (max diff "
            f"{worst:.3g}; {dt:.2f} s wall)")


def check_precision(rgb, corners, K, tag_size):
    """The f32 stages on the default device and on the CPU, from identical
    inputs: {stage: (max abs difference, tolerance)}."""
    import jax
    import jax.numpy as jnp

    from isaac_ros_apriltag_tpu.models.families import get_family
    from isaac_ros_apriltag_tpu.ops.decode import _fit_gray_model, decode_quads
    from isaac_ros_apriltag_tpu.ops.grayscale import grayscale
    from isaac_ros_apriltag_tpu.ops.pose import estimate_poses
    from isaac_ros_apriltag_tpu.utils.geometry import (
        apply_homography, homography_from_correspondences)

    fam = get_family("tag36h11")
    square = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], np.float32)
    grid = np.stack(np.meshgrid(np.linspace(-1, 1, 9), np.linspace(-1, 1, 9)),
                    -1).reshape(-1, 2).astype(np.float32)
    rng = np.random.default_rng(1)
    uv = rng.uniform(-1, 1, (len(corners), 32, 2)).astype(np.float32)
    vals = rng.uniform(0, 255, (len(corners), 32)).astype(np.float32)
    gray = np.asarray(grayscale(jnp.asarray(rgb), "rgb8"))

    def homography(c):
        H = homography_from_correspondences(
            jnp.broadcast_to(jnp.asarray(square), c.shape), c)
        return apply_homography(H, jnp.broadcast_to(grid, (c.shape[0],)
                                                    + grid.shape))

    def pose(c):
        p = estimate_poses(c, jnp.asarray(K, jnp.float32), tag_size)
        return p.translation, p.rotation

    def decode(g, c):
        return decode_quads(g, c, fam).margin

    stages = {
        "grayscale": (lambda im: grayscale(im, "rgb8"), (rgb,)),
        "homography_px": (homography, (corners,)),
        "gray_model": (_fit_gray_model, (uv, vals)),
        "decode_margin": (decode, (gray, corners)),
        "pose_t_m": (lambda c: pose(c)[0], (corners,)),
        "pose_R": (lambda c: pose(c)[1], (corners,)),
    }
    cpu = jax.devices("cpu")[0]
    dev = jax.devices()[0]
    out = {}
    for name, (f, args) in stages.items():
        f = jax.jit(f)
        a = np.asarray(f(*[jax.device_put(np.asarray(v), dev) for v in args]))
        b = np.asarray(f(*[jax.device_put(np.asarray(v), cpu) for v in args]))
        out[name] = (float(np.abs(a - b).max()), PRECISION_TOL[name])
    return out


def phase_precision(rgb, det, cam):
    valid = np.asarray(det.valid)
    corners = np.asarray(det.corners)[valid]
    res = check_precision(rgb, corners, np.asarray(cam.K), 0.3)
    bad = {k: v for k, v in res.items() if not v[0] <= v[1]}
    _check(not bad, f"card vs CPU over tolerance: {bad}")
    return "card vs CPU max |diff| (tol): " + ", ".join(
        f"{k} {v[0]:.3g} ({v[1]:g})" for k, v in res.items())


# --------------------------------------------------------------------------
# four cards

def phase_rig(devices, n_cams=16, H=720, W=1280):
    """RigDetector, n_cams cameras over a len(devices) 'cam' mesh, vs the
    same rig on one device."""
    import jax

    from isaac_ros_apriltag_tpu import DetectorConfig
    from isaac_ros_apriltag_tpu.parallel.mesh import make_mesh
    from isaac_ros_apriltag_tpu.parallel.rig import RigDetector
    from isaac_ros_apriltag_tpu.utils.compare import frame
    from isaac_ros_apriltag_tpu.utils.render import six_tag_scene

    cam, base, tags = six_tag_scene(H, W, noise=0.0)
    frames = noisy_frames(base, n_cams)
    cfg = DetectorConfig(tag_size=0.3)
    many = RigDetector(cfg, cam, n_cams, mesh=make_mesh(devices=devices))
    one = RigDetector(cfg, cam, n_cams, mesh=make_mesh(devices=devices[:1]))
    dm, _ = jax.block_until_ready(many.detect(frames))
    d1, _ = jax.block_until_ready(one.detect(frames))
    worst = [0.0, 0.0, 0.0]
    for b in range(n_cams):
        e = compare_rowwise(dm, frame(d1, b), SAME_PX, SAME_T, SAME_Q, b_idx=b)
        worst = [max(u, v) for u, v in zip(worst, e)]
    n_det = int(np.asarray(dm.valid).sum())
    _check(n_det >= n_cams * (len(tags) - 1),
           f"{n_det} detections over {n_cams} cameras of {len(tags)} tags")
    return (f"{n_cams} cameras {W}x{H} on {len(devices)} devices == 1 device "
            f"(max corner {worst[0]:.3g} px, t {worst[1]:.3g} m, "
            f"q {worst[2]:.3g}); {n_det} detections")


def phase_spatial(devices, H=1080, W=1920):
    """SpatialDetector over a len(devices) 'y' mesh vs a single-device
    Detector. The noise-free scene must match. On the noisy scene (noise 2,
    the rig's frames) the sharded front's single-phase scan CCL, which is
    not the production two-phase CCL, can lose tags that the production
    path keeps (ROADMAP R7): the loss is reported as a known fault, not
    checked."""
    from jax.sharding import Mesh

    from isaac_ros_apriltag_tpu import Detector, DetectorConfig
    from isaac_ros_apriltag_tpu.parallel.spatial import SpatialDetector
    from isaac_ros_apriltag_tpu.utils.compare import rows
    from isaac_ros_apriltag_tpu.utils.render import six_tag_scene

    cam, frame, tags = six_tag_scene(H, W, noise=0.0)
    cfg = DetectorConfig(tag_size=0.3)
    sd = SpatialDetector(cfg, cam, Mesh(np.asarray(devices), ("y",)))
    det = Detector(cfg, cam)
    ds = sd.detect(frame)
    d1 = det.detect(frame, encoding="mono8")
    ids, ec, et, eq = compare_detections(ds, d1)
    compare_ground_truth(ds, cam, tags)
    noisy = noisy_frames(frame, 1)[0]
    d1n = det.detect(noisy, encoding="mono8")
    compare_ground_truth(d1n, cam, tags)
    got, want = sorted(rows(sd.detect(noisy))), sorted(rows(d1n))
    lost = sorted(set(want) - set(got))
    return (f"{W}x{H} on {len(devices)} devices vs 1-device Detector: ids "
            f"{ids}, corner {ec:.3g} px, t {et:.3g} m, q {eq:.3g}; known "
            f"fault (ROADMAP R7), noise 2: sharded finds {got}, Detector "
            f"{want}, {len(lost)} of {len(want)} lost {lost}")


def ba_problem(n_kf=32, cols=16, rows=8, seed=0):
    """Synthetic tag map: a cols x rows wall of 0.16 m tags 2 m away, a
    camera sliding along it; observations of every tag in view, 0.3 px
    noise, states perturbed."""
    import jax.numpy as jnp

    from isaac_ros_apriltag_tpu.ops.pose import TAG_CORNERS
    from isaac_ros_apriltag_tpu.parallel.slam import ba
    from isaac_ros_apriltag_tpu.utils.geometry import se3_exp
    from isaac_ros_apriltag_tpu.utils.render import upright_pose

    rng = np.random.default_rng(seed)
    K = np.array([[420.0, 0, 320], [0, 420.0, 240], [0, 0, 1]], np.float32)
    size = 0.16
    lm_t = np.array([[0.4 * (i % cols) - 0.2 * cols, 0.4 * (i // cols)
                      - 0.2 * rows, 2.0] for i in range(cols * rows)])
    lm_R = np.stack([upright_pose(t) for t in lm_t])
    kf_t = np.array([[0.2 * k - 0.1 * n_kf, 0.05 * np.sin(k), 0.0]
                     for k in range(n_kf)])
    obj = np.concatenate([TAG_CORNERS * size / 2, np.zeros((4, 1))], -1)
    obs = []
    for k in range(n_kf):
        for lm in range(len(lm_t)):
            pc = obj @ lm_R[lm].T + lm_t[lm] - kf_t[k]
            uv = pc[:, :2] / pc[:, 2:] * K[0, 0] + K[:2, 2]
            if (uv >= 0).all() and (uv[:, 0] < 640).all() and (uv[:, 1] < 480).all():
                obs.append((k, lm, uv + rng.normal(0, 0.3, uv.shape)))

    def perturb(R, s):
        dR, _ = se3_exp(jnp.asarray(np.concatenate(
            [rng.normal(0, s, 3), np.zeros(3)])))
        return R @ np.asarray(dR)

    return ba.BAProblem(
        cam_R=jnp.asarray(np.stack([perturb(np.eye(3), 0.01)
                                    for _ in range(n_kf)]), jnp.float32),
        cam_t=jnp.asarray(kf_t + rng.normal(0, 0.02, kf_t.shape), jnp.float32),
        lm_R=jnp.asarray(np.stack([perturb(R, 0.01) for R in lm_R]),
                         jnp.float32),
        lm_t=jnp.asarray(lm_t + rng.normal(0, 0.02, lm_t.shape), jnp.float32),
        obs_kf=jnp.asarray([o[0] for o in obs], jnp.int32),
        obs_lm=jnp.asarray([o[1] for o in obs], jnp.int32),
        obs_uv=jnp.asarray(np.stack([o[2] for o in obs]), jnp.float32),
        obs_valid=jnp.ones(len(obs), bool),
        K=jnp.asarray(K), tag_size=jnp.float32(size))


def phase_dba(devices, iters=6, **problem):
    """The distributed BA on a len(devices) 'map' mesh vs the
    single-device solve."""
    import jax
    from jax.sharding import Mesh

    from isaac_ros_apriltag_tpu.parallel.slam import ba, dba

    p = ba_problem(**problem)
    mesh = Mesh(np.asarray(devices), ("map",))
    pp = jax.device_put(dba.partition_problem(p, len(devices)),
                        dba.problem_shardings(mesh))
    solved_d, rms_d = jax.block_until_ready(
        dba.make_distributed_solver(mesh, iters=iters)(pp))
    p1 = jax.device_put(p, devices[0])
    solved_s, rms_s = jax.block_until_ready(
        jax.jit(lambda q: ba.solve(q, iters=iters))(p1))
    err = float(np.abs(np.asarray(solved_d.cam_t)
                       - np.asarray(solved_s.cam_t)).max())
    rd, rs = float(np.asarray(rms_d)[-1]), float(np.asarray(rms_s)[-1])
    _check(err <= 1e-3, f"camera trajectories differ by {err:.3g} m")
    _check(rd < 0.5 and rs < 0.5, f"final rms {rd:.3g} / {rs:.3g} px")
    return (f"{p.cam_R.shape[0]} keyframes, {p.lm_R.shape[0]} tags, "
            f"{p.obs_kf.shape[0]} observations on {len(devices)} devices: "
            f"cam_t vs 1-device solve {err:.3g} m, final rms {rd:.3g} / "
            f"{rs:.3g} px")


# --------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run the four-card phases (rig, spatial, "
                         "distributed BA) and nothing else")
    args = ap.parse_args(argv)

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from isaac_ros_apriltag_tpu.utils.cache import enable_compile_cache
        from isaac_ros_apriltag_tpu.utils.device import card_lines, require_gpu
    except ImportError as e:
        print(f"chip_smoke: cannot import the package: {e}", file=sys.stderr)
        return 2
    import jax

    devices = require_gpu("chip_smoke", 4 if args.multi else 1)
    enable_compile_cache()

    failed = []

    def run(name, fn, *a):
        t0 = time.perf_counter()
        try:
            res = fn(*a)
        except Exception as e:   # noqa: BLE001 — every phase is reported
            failed.append(name)
            print(f"phase {name}: FAILED ({time.perf_counter() - t0:.1f} s): "
                  f"{type(e).__name__}: {e}", flush=True)
            traceback.print_exc(file=sys.stderr)
            return None
        note, extra = res if isinstance(res, tuple) else (res, None)
        print(f"phase {name}: ok ({time.perf_counter() - t0:.1f} s): {note}",
              flush=True)
        return extra if isinstance(res, tuple) else True

    d0 = devices[0]
    print(f"phase device: platform {d0.platform}, kind {d0.device_kind}, "
          f"count {len(devices)}; jax {jax.__version__}", flush=True)
    try:
        cards = card_lines()
    except (OSError, subprocess.SubprocessError) as e:
        cards = []
        failed.append("card")
        print(f"phase card: FAILED: nvidia-smi: {e}", flush=True)
    if args.multi:
        run("rig", phase_rig, devices)
        run("spatial", phase_spatial, devices)
        run("distributed_ba", phase_dba, devices)
    else:
        compile_s = {}
        node = run("reference_node", phase_reference_node, compile_s)
        bench = run("bench_config", phase_bench_config, compile_s)
        run("graph", phase_graph, compile_s)
        if bench is not None:
            run("stream", phase_stream, *bench)
        else:
            failed.append("stream")
        if node is not None:
            run("precision", phase_precision, *node)
        else:
            failed.append("precision")
        print("phase compile: first-call seconds (compile + one run): "
              + json.dumps(compile_s), flush=True)
        stats = d0.memory_stats() or {}
        print(f"phase memory: peak_bytes_in_use "
              f"{stats.get('peak_bytes_in_use', 'not reported')}", flush=True)

    for line in cards:
        print(line)
    if failed:
        print(f"chip_smoke: FAILED phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": d0.platform, "kind": d0.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
