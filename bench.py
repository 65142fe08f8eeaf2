"""Benchmark: prints the headline JSON line, then enriches it.

Headline: tag36h11 detection throughput (frames/s per card) at noisy 1080p,
batch 8, with the production `scan` backend. vs_baseline is against the
reference's best published single-GPU number (596 fps @720p on an RTX 5090,
reference README.md:69).

The JSON line is printed right after the headline and re-printed, enriched,
after every section; the last complete line is the record. Every line names
the platform, JAX's device kind, and the card's name and power limit as
nvidia-smi reports them. The script refuses a platform other than the GPU,
and any failed section or failed check makes it exit non-zero.

Timing: every loop dispatches asynchronously and stops the clock at
`jax.block_until_ready` (utils/timing.py), after one warmup call that
compiles. Sections: the `xla` oracle's fps and its parity with production
(ids, corners <= 0.1 px, translation <= 1 cm, quaternion <= 0.01 — the
reference's backends-compare contract, ref test:162-253), batched-vs-single
parity for both backends, a per-stage ms table from separately jitted
stages, the 720p line (the reference's benchmark resolution), the graph
pipeline on real graph work (8 MP distorted input -> separable rectify ->
2x resize -> detect at 1080p, README.md:24-26) and the streaming runner fed
from host numpy frames, uploads included.
"""

import contextlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

BASELINE_FPS = 596.0  # RTX 5090 anchor (reference README.md:69)


def _timeit(fn, *args, iters):
    """ms per call of a jitted fn (warmup + block_until_ready)."""
    import jax

    out = jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        res = fn(*args)
    jax.block_until_ready(res)
    return 1000.0 * (time.perf_counter() - t0) / iters, out


def _stage_table(cam, frame, cfg, iters):
    """Per-stage ms at the bench configuration (separately jitted stages,
    one frame)."""
    import jax
    import jax.numpy as jnp

    from isaac_ros_apriltag_tpu.detector import (_decimate, _pad_to_tiles,
                                                 _upscale_coords)
    from isaac_ros_apriltag_tpu.models.families import get_family
    from isaac_ros_apriltag_tpu.ops.ccl import connected_components, two_phase_ccl
    from isaac_ros_apriltag_tpu.ops.cluster_moments import extract_cluster_moments
    from isaac_ros_apriltag_tpu.ops.decode import decode_quads
    from isaac_ros_apriltag_tpu.ops.pose import estimate_poses
    from isaac_ros_apriltag_tpu.ops.quadfit import fit_quads_from_moments
    from isaac_ros_apriltag_tpu.ops.refine import refine_edges
    from isaac_ros_apriltag_tpu.ops.resolve import resolve_components
    from isaac_ros_apriltag_tpu.ops.threshold import adaptive_threshold

    fam = get_family(cfg.tag_family)
    d = cfg.quad_decimate
    table = {}

    def timeit(name, fn, *args):
        table[name], out = _timeit(jax.jit(fn), *args, iters=iters)
        table[name] = round(table[name], 3)
        return out

    gray = jnp.asarray(frame, jnp.float32)
    seg = timeit("decimate", lambda g: _pad_to_tiles(_decimate(g, d),
                                                     cfg.tile_size), gray)
    E_eff, R_eff = cfg.effective_capacities(*seg.shape)
    tri = timeit("threshold", lambda s: adaptive_threshold(
        s, cfg.tile_size, cfg.min_white_black_diff), seg)
    if cfg.backend == "scan":
        lab, _, rtab, _ = timeit("ccl", lambda t: two_phase_ccl(
            t, cfg.ccl_scan_rounds, cfg.ccl_phase2_rounds,
            max_components=R_eff,
            contraction_steps=cfg.ccl_contraction_steps), tri)
    else:
        lab = timeit("ccl", lambda t: connected_components(
            t, cfg.ccl_rounds, cfg.ccl_jumps, cfg.ccl_jump_every), tri)
        rtab = None
    dense = timeit("resolve", lambda t, l, T: resolve_components(
        l, t != 127, min_component_pixels=cfg.min_component_pixels,
        max_components=R_eff, chain_steps=cfg.ccl_resolve_steps,
        rank_table=T).dense, tri, lab, rtab)
    mom = timeit("cluster_moments", lambda t, dn: extract_cluster_moments(
        t, dn, comp_overflow=jnp.bool_(False),
        max_edge_points=E_eff,
        max_clusters=cfg.max_clusters,
        min_cluster_pixels=cfg.min_cluster_pixels,
        max_cluster_points=cfg.max_cluster_points), tri, dense)
    quads = timeit("quadfit", lambda m: fit_quads_from_moments(
        m, min_area=64.0 / (d * d)), mom)
    corners = timeit("refine", lambda g, c, dk: refine_edges(
        g, _upscale_coords(c, d), dk, search_range=d + 1.0),
        gray, quads.corners, quads.dark_inside)
    dec = timeit("decode", lambda g, c: decode_quads(
        g, c, fam, max_hamming=cfg.max_hamming,
        decode_sharpening=cfg.decode_sharpening), gray, corners)
    timeit("pose", lambda c: estimate_poses(c, cam.K, cfg.tag_size),
           dec.corners)
    return table


def main():
    import jax
    import jax.numpy as jnp

    from isaac_ros_apriltag_tpu import DetectorConfig
    from isaac_ros_apriltag_tpu.detector import build_detect_fn
    from isaac_ros_apriltag_tpu.utils.cache import enable_compile_cache
    from isaac_ros_apriltag_tpu.utils.compare import (detection_errors, frame,
                                                      within)
    from isaac_ros_apriltag_tpu.utils.device import card_lines, require_gpu
    from isaac_ros_apriltag_tpu.utils.render import six_tag_scene
    from isaac_ros_apriltag_tpu.utils.timing import throughput

    dev = require_gpu("bench")[0]
    enable_compile_cache()
    card_name, power_limit = [v.strip() for v in card_lines()[0].split(",")]

    H, W = 1080, 1920
    BATCH = int(os.environ.get("BENCH_BATCH", "8"))
    ITERS = int(os.environ.get("BENCH_ITERS", "30"))
    BACKEND = os.environ.get("BENCH_BACKEND", "scan")
    fail = []

    cam, frame, _ = six_tag_scene(H, W)
    frames = np.stack([frame] * BATCH)
    x = jnp.asarray(frames)

    # --- headline: production backend, batched 1080p ----------------------
    cfg = DetectorConfig(backend=BACKEND, tag_size=0.3)
    fn = jax.jit(jax.vmap(build_detect_fn(cfg, cam, encoding="mono8")))
    dt, (det0, stats0) = throughput(fn, x, ITERS)
    fps = BATCH * ITERS / dt
    det_per_frame = int(np.asarray(stats0.num_detections).sum()) // BATCH

    detail = {
        "batch": BATCH, "iters": ITERS,
        "ms_per_frame": round(1000.0 * dt / (BATCH * ITERS), 3),
        "detections_per_frame": det_per_frame,
        "platform": dev.platform, "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "card": card_name, "power_limit": power_limit,
        "backend": cfg.backend,
    }

    def emit():
        print(json.dumps({
            "metric": "tag36h11_fps_1080p_per_card",
            "value": round(fps, 1),
            "unit": "frames/s",
            "vs_baseline": round(fps / BASELINE_FPS, 3),
            "detail": detail,
        }), flush=True)

    emit()

    @contextlib.contextmanager
    def section(name):
        """A failed section records its error and fails the run."""
        try:
            yield
            print(f"# bench section {name} done", file=sys.stderr, flush=True)
        except Exception as e:  # noqa: BLE001 — recorded, then fails the run
            detail[name + "_error"] = str(e)[:200]
            fail.append(f"section {name}: {e}")
            print(f"# bench section {name} FAILED: {e}", file=sys.stderr,
                  flush=True)
        emit()

    # --- oracle fps + parity: single-frame and batched --------------------
    if os.environ.get("BENCH_XLA", "1") == "1" and BACKEND != "xla":
        with section("xla"):
            cfg_x = DetectorConfig(backend="xla", tag_size=0.3)
            fn_x = jax.jit(jax.vmap(build_detect_fn(cfg_x, cam, encoding="mono8")))
            dt_x, (det_x, stats_x) = throughput(fn_x, x, ITERS)
            detail["xla_fps"] = round(BATCH * ITERS / dt_x, 1)
            detail["xla_detections_per_frame"] = int(
                np.asarray(stats_x.num_detections).sum()) // BATCH
            fn_x1 = jax.jit(build_detect_fn(cfg_x, cam, encoding="mono8"))
            det_x1, _ = jax.block_until_ready(fn_x1(x[0]))
            errors = detection_errors(frame(det0, 0), det_x1)
            _, ec, et, eq = errors
            detail["parity_ok"] = within(errors)
            detail["parity_max_corner_err_px"] = round(ec, 5)
            detail["parity_max_translation_err_m"] = round(et, 6)
            detail["parity_max_quaternion_err"] = round(eq, 6)
            if not detail["parity_ok"]:
                fail.append(f"backend parity failed (corner {ec}, t {et}, q {eq})")
            errors = detection_errors(frame(det_x, 0), det_x1)
            detail["xla_batch_parity_ok"] = within(errors)
            detail["xla_batch_max_corner_err_px"] = round(errors[1], 5)
            if not detail["xla_batch_parity_ok"]:
                fail.append("xla batched-vs-single parity failed")

    # --- production batched-vs-single parity ------------------------------
    if os.environ.get("BENCH_SELF_PARITY", "1") == "1":
        with section("self_parity"):
            fn_1 = jax.jit(build_detect_fn(cfg, cam, encoding="mono8"))
            det_1, _ = jax.block_until_ready(fn_1(x[0]))
            errors = detection_errors(frame(det0, 0), det_1)
            detail["batch_parity_ok"] = within(errors)
            detail["batch_max_corner_err_px"] = round(errors[1], 5)
            if not detail["batch_parity_ok"]:
                fail.append("batched-vs-single parity failed")

    # --- per-stage breakdown ----------------------------------------------
    if os.environ.get("BENCH_STAGES", "1") == "1":
        with section("stages"):
            detail["stage_ms"] = _stage_table(cam, frame, cfg, max(ITERS, 10))

    # --- 720p line (reference anchor is 596 fps @720p) ---------------------
    if os.environ.get("BENCH_720", "1") == "1":
        with section("720p"):
            cam7, frame7, _ = six_tag_scene(720, 1280)
            fn7 = jax.jit(jax.vmap(build_detect_fn(cfg, cam7, encoding="mono8")))
            x7 = jnp.asarray(np.stack([frame7] * BATCH))
            dt7, (_, stats7) = throughput(fn7, x7, ITERS)
            detail["fps_720p"] = round(BATCH * ITERS / dt7, 1)
            detail["detections_per_frame_720p"] = int(
                np.asarray(stats7.num_detections).sum()) // BATCH

    # --- graph pipeline with REAL graph work (README.md:24-26, :70) --------
    if os.environ.get("BENCH_GRAPH", "1") == "1":
        with section("graph"):
            from isaac_ros_apriltag_tpu import CameraModel
            from isaac_ros_apriltag_tpu.pipeline import GraphPipeline
            from isaac_ros_apriltag_tpu.utils.render import USB_CAM, distort_image

            # The reference's usb_cam calibration scaled 3x to 8 MP.
            cam8 = CameraModel.create(
                **{k: USB_CAM[k] * 3 for k in ("fx", "fy", "cx", "cy")},
                width=3840, height=2160, dist=USB_CAM["dist"])
            _, ideal8, _ = six_tag_scene(2160, 3840, camera=cam8)
            frame8 = distort_image(ideal8, cam8)
            gp = GraphPipeline(cfg, cam8, downscale=2, encoding="mono8")
            gfn = jax.jit(jax.vmap(
                gp.fn_with_plan, in_axes=(0,) + (None,) * len(gp.plan_args)))
            x8 = jnp.asarray(np.stack([frame8] * BATCH))
            g_iters = max(ITERS // 2, 5)
            dt_g, (_, gstats) = throughput(
                lambda v: gfn(v, *gp.plan_args), x8, g_iters)
            detail["graph_fps"] = round(BATCH * g_iters / dt_g, 1)
            detail["graph_detections_per_frame"] = int(
                np.asarray(gstats.num_detections).sum()) // BATCH
            detail["graph_input"] = "3840x2160 plumb_bob -> rectify -> 2x -> detect"
            if detail["graph_detections_per_frame"] == 0:
                fail.append("graph pipeline found 0 detections")

    # --- streaming runner fed from host frames, uploads included -----------
    if os.environ.get("BENCH_STREAM", "1") == "1":
        with section("stream"):
            from isaac_ros_apriltag_tpu.streaming import StreamingRunner

            def run(f, feed, depth):
                t0 = time.perf_counter()
                for _ in StreamingRunner(f, depth=depth).run(feed):
                    pass
                return time.perf_counter() - t0

            chunks = [frames] * 8
            run(fn, chunks[:2], 2)                       # warm path
            detail["stream_fps_batched"] = round(
                len(chunks) * BATCH / run(fn, chunks, 3), 1)
            sfn = jax.jit(build_detect_fn(cfg, cam, encoding="mono8"))
            singles = [frame] * 16
            run(sfn, singles[:4], 2)
            detail["stream_fps_single_sync"] = round(
                len(singles) / run(sfn, singles, 1), 1)
            detail["stream_fps_single_pipelined"] = round(
                len(singles) / run(sfn, singles, 3), 1)

    emit()

    if det_per_frame == 0:
        fail.append("0 detections per frame")
    if fail:
        print("BENCH FAILED: " + "; ".join(fail), file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
