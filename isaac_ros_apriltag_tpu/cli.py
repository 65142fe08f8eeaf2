"""Command-line interface: detect | bench | slam.

Mirrors the reference's launch-argument surface (`tag_family`, `backends`,
`size`, `max_tags`, `tile_size` — ref: isaac_ros_apriltag/launch/
isaac_ros_apriltag_core.launch.py:55-69 and the node parameter defaults at
src/apriltag_node.cpp:564-568) as flags on a plain process entry point:

    python -m isaac_ros_apriltag_tpu detect --image frame.png --fx 600 ...
    python -m isaac_ros_apriltag_tpu bench --hw 1080,1920 --iters 30
    python -m isaac_ros_apriltag_tpu slam --frames 24 --tags 12

`detect` reads an image (PNG via cv2 if available, else .npy), runs the
jit-compiled detector, and prints one JSON line per detection. `bench`
reports fps on a synthetic scene. `slam` renders a synthetic trajectory,
maps it, optimizes with BA and reports ATE; --save-map/--load-map exercise
the checkpoint path.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _add_detector_flags(p: argparse.ArgumentParser) -> None:
    # Names/defaults mirror apriltag_node.cpp:564-568.
    p.add_argument("--tag-family", default="tag36h11")
    p.add_argument("--backends", default="scan",
                   help="scan | xla (reference: CPU|CUDA|PVA)")
    p.add_argument("--size", type=float, default=0.22,
                   help="tag edge length, meters")
    p.add_argument("--max-tags", type=int, default=64)
    p.add_argument("--tile-size", type=int, default=4)
    p.add_argument("--quad-decimate", type=int, default=2)


def _config(args):
    from .config import DetectorConfig

    return DetectorConfig(tag_family=args.tag_family, backend=args.backends,
                          tag_size=args.size, max_tags=args.max_tags,
                          tile_size=args.tile_size,
                          quad_decimate=args.quad_decimate)


def _load_image(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        return np.load(path)
    try:
        import cv2

        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if img is None:
            raise FileNotFoundError(path)
        if img.ndim == 3:
            img = img[..., ::-1]  # BGR -> RGB
        return img
    except ImportError as e:
        raise SystemExit(f"need cv2 to read {path}; use .npy instead") from e


def cmd_detect(args) -> int:
    from .camera.model import CameraModel
    from .detector import Detector

    img = _load_image(args.image)
    H, W = img.shape[:2]
    if args.camera_info:
        info = json.load(open(args.camera_info))
        cam = CameraModel.from_camera_info(info)
    else:
        fx = args.fx or 0.6 * W
        cam = CameraModel.create(fx=fx, fy=args.fy or fx,
                                 cx=args.cx if args.cx is not None else W / 2,
                                 cy=args.cy if args.cy is not None else H / 2,
                                 width=W, height=H)
    det = Detector(_config(args), cam)
    if not det.family.exact:
        print(f"# WARNING: {det.family.name} uses a self-generated stand-in "
              "codebook (the published table is not regenerable offline) — "
              "ids will NOT match physical tags; vendor the official table "
              "via models.families.register_family for interop",
              file=sys.stderr)
    encoding = "mono8" if img.ndim == 2 else "rgb8"
    t0 = time.perf_counter()
    rows = det.detect(img, encoding=encoding).to_list()
    dt = time.perf_counter() - t0
    for r in rows:
        print(json.dumps(r))
    print(f"# {len(rows)} detections in {dt*1000:.1f} ms (incl. compile)",
          file=sys.stderr)
    return 0


def cmd_bench(args) -> int:
    import jax
    import jax.numpy as jnp

    from .detector import build_detect_fn
    from .utils.render import six_tag_scene

    H, W = map(int, args.hw.split(","))
    cam, frame, _ = six_tag_scene(H, W, noise=args.noise,
                                  family=args.tag_family)
    import dataclasses

    from .utils.timing import throughput

    cfg = dataclasses.replace(_config(args), tag_size=0.3)
    fn = jax.jit(jax.vmap(build_detect_fn(cfg, cam, encoding="mono8")))
    x = jnp.asarray(np.stack([frame] * args.batch))
    dt, (det, stats) = throughput(fn, x, args.iters)
    n = int(np.asarray(stats.num_detections).sum()) // args.batch
    fps = args.batch * args.iters / dt
    print(json.dumps({"fps": round(fps, 1), "detections_per_frame": n,
                      "backend": cfg.backend, "hw": [H, W]}))
    return 0 if n > 0 else 1


def cmd_slam(args) -> int:
    from .camera.model import CameraModel
    from .detector import Detector
    from .models.families import get_family
    from .parallel.slam import ba
    from .parallel.slam.map import TagMapper, ate_rmse
    from .utils.render import render_tags, rotz

    rng = np.random.default_rng(0)
    cam = CameraModel.create(fx=420.0, fy=420.0, cx=320.0, cy=240.0,
                             width=640, height=480)
    fam = get_family(args.tag_family)
    mapper = TagMapper(K=np.asarray(cam.K), tag_size=args.size)
    if args.load_map:
        mapper.load(args.load_map)
        print(f"# loaded map with {len(mapper.lm_ids)} landmarks", file=sys.stderr)

    # Synthetic trajectory: camera orbiting a wall of tags.
    ncols = int(np.ceil(np.sqrt(args.tags)))
    wall = []
    for i in range(args.tags):
        gx = (i % ncols - (ncols - 1) / 2.0) * 0.5
        gy = (i // ncols - (args.tags // ncols) / 2.0) * 0.5
        wall.append((i * 3 + 1, np.array([gx, gy, 0.0])))
    det = Detector(_config(args), cam)
    gt_traj = []
    for k in range(args.frames):
        ang = 0.25 * np.sin(2 * np.pi * k / args.frames)
        c = np.array([1.2 * np.sin(ang), 0.15 * np.sin(2 * ang), -2.0 - 0.3 * np.cos(ang)])
        R_wc = rotz(0.05 * np.sin(ang))
        gt_traj.append(c)
        tags = []
        for tid, p in wall:
            R_wt = np.diag([1.0, 1.0, 1.0])
            R_ct = R_wc.T @ R_wt @ np.diag([-1.0, -1.0, 1.0])
            t_ct = R_wc.T @ (p - c)
            if t_ct[2] < 0.3:
                continue
            tags.append(dict(family=fam, id=tid, R=R_ct, t=t_ct,
                             tag_size=args.size))
        img = render_tags(np.asarray(cam.K), (480, 640), tags, noise=args.noise,
                          seed=k)
        mapper.process_frame(det.detect(img, encoding="mono8"))
    p = mapper.build_problem()
    p, rms = ba.solve(p, iters=args.ba_iters)
    mapper.update_from_problem(p)
    est = np.stack(mapper.kf_t)
    ate = ate_rmse(est, np.stack(gt_traj))
    if args.save_map:
        mapper.save(args.save_map)
        print(f"# saved map to {args.save_map}", file=sys.stderr)
    print(json.dumps({"frames": args.frames, "tags_mapped": len(mapper.lm_ids),
                      "final_rms_px": float(np.asarray(rms)[-1]),
                      "ate_rmse_m": ate}))
    return 0 if ate < args.ate_bound else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="isaac_ros_apriltag_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("detect", help="detect tags in one image")
    _add_detector_flags(d)
    d.add_argument("--image", required=True)
    d.add_argument("--camera-info", help="CameraInfo-style JSON file")
    d.add_argument("--fx", type=float)
    d.add_argument("--fy", type=float)
    d.add_argument("--cx", type=float)
    d.add_argument("--cy", type=float)
    d.set_defaults(fn=cmd_detect)

    b = sub.add_parser("bench", help="throughput on a synthetic scene")
    _add_detector_flags(b)
    b.add_argument("--hw", default="1080,1920")
    b.add_argument("--batch", type=int, default=8)
    b.add_argument("--iters", type=int, default=30)
    b.add_argument("--noise", type=float, default=2.0)
    b.set_defaults(fn=cmd_bench)

    s = sub.add_parser("slam", help="synthetic-trajectory tag mapping + BA")
    _add_detector_flags(s)
    s.add_argument("--frames", type=int, default=16)
    s.add_argument("--tags", type=int, default=9)
    s.add_argument("--noise", type=float, default=1.0)
    s.add_argument("--ba-iters", type=int, default=8)
    s.add_argument("--ate-bound", type=float, default=0.05)
    s.add_argument("--save-map")
    s.add_argument("--load-map")
    s.set_defaults(fn=cmd_slam)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
