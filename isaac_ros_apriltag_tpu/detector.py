"""AprilTag detector: config + camera -> jit-compiled detect(frame).

Replacement for the reference's AprilTagNode + backend impls
(ref: isaac_ros_apriltag/src/apriltag_node.cpp:562-633). There is no
middleware: `detect` is a pure function image -> Detections, compiled once
per (shape, encoding) — the analog of the reference's freeze-at-first-frame
lazy init (ref: apriltag_node.cpp:618-620). Backends mirror the reference's
CPU|CUDA|PVA dispatch (ref: apriltag_node.cpp:576-582): 'scan' is the
production two-phase scan CCL (ops/ccl.two_phase_ccl), 'xla' the oracle
whose CCL converges with rationed pointer jumps. Both are plain JAX.

Every stage runs under a `jax.named_scope` (STAGES), so a profiler trace of
the jitted program attributes device time to stages
(tools/trace_stages.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .camera.model import CameraModel
from .config import DetectorConfig
from .models.families import TagFamily, get_family
from .ops.ccl import connected_components, two_phase_ccl
from .ops.cluster_moments import extract_cluster_moments
from .ops.resolve import resolve_components
from .ops.decode import decode_quads
from .ops.grayscale import grayscale
from .ops.pose import estimate_poses
from .ops.quadfit import fit_quads_from_moments
from .ops.refine import refine_edges
from .ops.threshold import adaptive_threshold
from .types import Detections, FrameStats
from .utils.geometry import line_intersection

# Named scopes of the detect program, in pipeline order ("contraction" is
# nested in "ccl": ops/ccl.two_phase_ccl).
STAGES = ("grayscale", "decimate", "threshold", "ccl", "contraction",
          "resolve", "cluster_moments", "quadfit", "select", "refine",
          "decode", "pose")


def _pad_to_tiles(gray: jax.Array, ts: int) -> jax.Array:
    H, W = gray.shape
    ph = (-H) % ts
    pw = (-W) % ts
    if ph or pw:
        gray = jnp.pad(gray, ((0, ph), (0, pw)), mode="edge")
    return gray


def _pool_matrix(n: int, d: int) -> jax.Array:
    """(n//d, n) mean-pooling operator: row i averages input block [d*i, d*i+d)."""
    rows = jax.lax.broadcasted_iota(jnp.int32, (n // d, n), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (n // d, n), 1)
    return jnp.where(cols // d == rows, jnp.float32(1.0 / d), jnp.float32(0.0))


def _decimate(gray: jax.Array, d: int) -> jax.Array:
    """d x d mean-pool (AprilTag 3's quad_decimate). Pixel (i, j) of the
    pooled image has center (d*j + (d-1)/2, d*i + (d-1)/2) in full-res
    coordinates (see _upscale_coords).

    Formulated as two matmuls against banded pooling operators instead of a
    reshape+reduce (not yet timed against the reshape form on the H100).
    precision=HIGHEST keeps the pool exact in f32 (a default-precision f32
    matmul may round its operands, to TF32 on the GPU)."""
    if d == 1:
        return gray
    gray = _pad_to_tiles(gray, d)
    Hp, Wp = gray.shape
    pooled_rows = jnp.matmul(_pool_matrix(Hp, d), gray,
                             precision=jax.lax.Precision.HIGHEST)
    return jnp.matmul(pooled_rows, _pool_matrix(Wp, d).T,
                      precision=jax.lax.Precision.HIGHEST)


def _upscale_coords(xy: jax.Array, d: int) -> jax.Array:
    """Decimated-image pixel coords -> full-resolution pixel coords."""
    if d == 1:
        return xy
    return xy * d + (d - 1) / 2.0


def _dedupe(valid, ids, margin, corners):
    """Suppress duplicate detections of the same id with overlapping extent.

    A tag can yield several candidate quads (outer border + interior
    structure); keep the best decision margin. Vectorized (T, T) pairwise
    suppression."""
    center = jnp.mean(corners, axis=1)                       # (T, 2)
    edge = jnp.mean(jnp.linalg.norm(
        corners - jnp.roll(corners, 1, 1), axis=-1), axis=-1)  # (T,)
    d = jnp.linalg.norm(center[:, None] - center[None, :], axis=-1)
    near = d < 0.75 * jnp.maximum(edge[:, None], edge[None, :])
    same = ids[:, None] == ids[None, :]
    both = valid[:, None] & valid[None, :]
    # i suppresses j if better margin (ties: lower index wins)
    idx = jnp.arange(ids.shape[0])
    better = (margin[:, None] > margin[None, :]) | (
        (margin[:, None] == margin[None, :]) & (idx[:, None] < idx[None, :]))
    suppressed = jnp.any(near & same & both & better, axis=0)
    return valid & ~suppressed


def detect_tail(cfg: DetectorConfig, camera: CameraModel, family: TagFamily,
                gray: jax.Array, trinary: jax.Array, label: jax.Array,
                scan_converged: jax.Array, *, with_pose: bool = True,
                rank_table: jax.Array | None = None,
                extra_overflow: jax.Array | None = None
                ) -> tuple[Detections, FrameStats]:
    """The back half of the detector: CCL labels -> Detections.

    Shared between the single-device detector and the row-sharded
    SpatialDetector (parallel/spatial.py), whose front half produces the
    same (trinary, label) pair sharded+gathered across the mesh.
    `rank_table` marks `label` as being in compacted-rank space (the
    two-phase scan flow — see ops/ccl.two_phase_ccl);
    `extra_overflow` ORs an upstream capacity flag (e.g. the contraction's)
    into the cluster stage's overflow telemetry.
    """
    # Sort-based chain resolution + component sizing + area-gated dense
    # relabel (replaces the round-3 pointer jumps, component_sizes
    # scatter, and relabel gather — see ops/resolve.py). Capacities scale
    # with the segmentation resolution (config.effective_capacities).
    E_eff, R_eff = cfg.effective_capacities(*trinary.shape)
    with jax.named_scope("resolve"):
        res = resolve_components(
            label, trinary != 127,
            min_component_pixels=cfg.min_component_pixels,
            max_components=R_eff,
            chain_steps=cfg.ccl_resolve_steps,
            rank_table=rank_table)
    ccl_converged = scan_converged & res.converged
    comp_overflow = res.overflow if extra_overflow is None \
        else res.overflow | extra_overflow
    dense = jax.lax.optimization_barrier(res.dense)
    with jax.named_scope("cluster_moments"):
        clusters = extract_cluster_moments(
            trinary, dense,
            comp_overflow=comp_overflow,
            max_edge_points=E_eff,
            max_clusters=cfg.max_clusters,
            min_cluster_pixels=cfg.min_cluster_pixels,
            max_cluster_points=cfg.max_cluster_points)
    return _detect_from_clusters(cfg, camera, family, gray, clusters,
                                 ccl_converged, with_pose=with_pose)


def build_detect_fn(config: DetectorConfig, camera: CameraModel,
                    encoding: str = "rgb8", *, with_pose: bool = True):
    """Returns a pure function image -> (Detections, FrameStats).

    with_pose=False skips the pose stage (fields come back zeroed) — for
    callers that re-pose with their own per-camera intrinsics
    (parallel/rig.py), so pose work is not done twice."""
    family = get_family(config.tag_family)
    cfg = config

    def detect(image: jax.Array) -> tuple[Detections, FrameStats]:
        with jax.named_scope("grayscale"):
            gray = grayscale(image, encoding)
        # Segmentation runs on the quad_decimate-pooled image; refinement and
        # decode sample the full-resolution image (AprilTag 3's same split).
        with jax.named_scope("decimate"):
            seg = _pad_to_tiles(_decimate(gray, cfg.quad_decimate),
                                cfg.tile_size)
        with jax.named_scope("threshold"):
            trinary = adaptive_threshold(seg, cfg.tile_size,
                                         cfg.min_white_black_diff)
        # Stage boundaries are materialization points: the downstream stages
        # contain iterative scans, and XLA's recomputation fusion would
        # otherwise re-derive upstream full-image intermediates inside every
        # scan step.
        gray, trinary = jax.lax.optimization_barrier((gray, trinary))
        rank_table = extra_overflow = None
        with jax.named_scope("ccl"):
            if cfg.backend == "scan":
                label, scan_converged, rank_table, extra_overflow = \
                    two_phase_ccl(
                        trinary, cfg.ccl_scan_rounds, cfg.ccl_phase2_rounds,
                        max_components=cfg.effective_capacities(
                            *trinary.shape)[1],
                        contraction_steps=cfg.ccl_contraction_steps)
            else:
                label, scan_converged = connected_components(
                    trinary, cfg.ccl_rounds, cfg.ccl_jumps,
                    cfg.ccl_jump_every, with_convergence=True)
        label = jax.lax.optimization_barrier(label)
        return detect_tail(cfg, camera, family, gray, trinary, label,
                           scan_converged, with_pose=with_pose,
                           rank_table=rank_table,
                           extra_overflow=extra_overflow)

    return detect


def _detect_from_clusters(cfg, camera, family, gray, clusters, ccl_converged,
                          *, with_pose: bool = True
                          ) -> tuple[Detections, FrameStats]:
    clusters = jax.lax.optimization_barrier(clusters)
    with jax.named_scope("quadfit"):
        quads = fit_quads_from_moments(
            clusters, min_area=64.0 / (cfg.quad_decimate ** 2))
    # Border polarity gate: normal families have a dark interior.
    want_dark = not family.reversed_border
    qvalid = quads.valid & (quads.dark_inside == want_dark)

    # --- top candidate quads by fit quality ----------------------------
    # Selecting BEFORE refine/decode bounds the full-res sampling stages
    # to T2 quads. Two safeguards against evicting real tags pre-decode:
    # (a) the rank score favors LARGE quads (perimeter / (1 + fit_err));
    #     raw fit_err alone lets tiny interior quads with near-zero
    #     line-fit error outrank real tag borders;
    # (b) a 2x margin above max_tags is decoded, so bad candidates can
    #     still lose at decode time; the final top-max_tags cut is by
    #     decision margin. max_tags is the reference's output capacity
    #     (apriltag_node.cpp:564).
    T = cfg.max_tags
    T2 = min(2 * T, quads.valid.shape[0])
    with jax.named_scope("select"):
        perim = jnp.sum(jnp.linalg.norm(
            quads.corners - jnp.roll(quads.corners, 1, 1), axis=-1), axis=-1)
        qscore = jnp.where(qvalid, perim / (1.0 + quads.fit_err), -jnp.inf)
        top_qs, top_i = jax.lax.top_k(qscore, T2)
        pre_valid = jnp.isfinite(top_qs)
        qcorners = quads.corners[top_i]
        qdark = quads.dark_inside[top_i]

    # Subpixel edge refinement (AprilTag 3's refine_edges): removes the
    # +-0.5 px quantization of the raw pair-midpoint boundary points and
    # the quad_decimate quantization (corners move back to full-res).
    with jax.named_scope("refine"):
        corners = refine_edges(gray,
                               _upscale_coords(qcorners, cfg.quad_decimate),
                               qdark,
                               search_range=cfg.quad_decimate + 1.0)

    with jax.named_scope("decode"):
        dec = decode_quads(gray, corners, family,
                           max_hamming=cfg.max_hamming,
                           decode_sharpening=cfg.decode_sharpening)
        dec_valid = (pre_valid & dec.valid
                     & (dec.margin >= cfg.min_decision_margin))
        dec_valid = _dedupe(dec_valid, dec.id, dec.margin, dec.corners)

        # Final top-max_tags cut by decision margin (the post-decode
        # ranking the T2 pre-decode margin exists to enable).
        fscore = jnp.where(dec_valid, dec.margin, -jnp.inf)
        top_fs, top_f = jax.lax.top_k(fscore, T)
        sel_valid = jnp.isfinite(top_fs)
        sel_ids = dec.id[top_f]
        sel_margin = dec.margin[top_f]
        sel_ham = dec.hamming[top_f]
        sel_corners = dec.corners[top_f]

    with jax.named_scope("pose"):
        # Center = intersection of the two diagonals, exactly as the
        # reference's CUDA backend computes it (apriltag_node.cpp:520-530).
        center = line_intersection(
            sel_corners[:, 0], sel_corners[:, 2] - sel_corners[:, 0],
            sel_corners[:, 1], sel_corners[:, 3] - sel_corners[:, 1])

        if with_pose:
            poses = estimate_poses(sel_corners, camera.K, cfg.tag_size)
            translation, quaternion, rotation = (
                poses.translation, poses.quaternion, poses.rotation)
        else:
            T_out = sel_corners.shape[0]
            translation = jnp.zeros((T_out, 3), jnp.float32)
            quaternion = jnp.zeros((T_out, 4), jnp.float32)
            rotation = jnp.zeros((T_out, 3, 3), jnp.float32)

    det = Detections(
        valid=sel_valid,
        id=jnp.where(sel_valid, sel_ids, -1),
        hamming=sel_ham,
        decision_margin=sel_margin,
        center=center,
        corners=sel_corners,
        translation=translation,
        quaternion=quaternion,
        rotation=rotation,
    )
    n_quads = jnp.sum(qvalid.astype(jnp.int32))
    stats = FrameStats(
        num_edge_points=clusters.num_edge_points,
        num_clusters=clusters.num_clusters,
        num_quads=n_quads,
        num_detections=jnp.sum(sel_valid.astype(jnp.int32)),
        edge_stride=clusters.edge_stride,
        ccl_converged=ccl_converged,
        # clusters.overflow covers hash-probe exhaustion and
        # eligible-cluster truncation (num_eligible > max_clusters, NOT
        # raw segment count — sub-threshold segments never get slots);
        # additionally flag when valid quads exceeded the decode budget.
        overflow=clusters.overflow | (n_quads > T2),
    )
    return det, stats


class Detector:
    """User-facing detector (the reference's AprilTagNode analog).

    Validates config eagerly (ctor-time errors, like apriltag_node.cpp:
    584-599) and jit-compiles one detect function per input encoding.
    """

    def __init__(self, config: DetectorConfig | None = None,
                 camera: CameraModel | None = None):
        self.config = config or DetectorConfig()
        if camera is None:
            raise ValueError("camera is required (CameraModel.create / from_camera_info)")
        self.camera = camera
        self.family: TagFamily = get_family(self.config.tag_family)
        self._jitted: dict[str, object] = {}

    def _fn(self, encoding: str):
        if encoding not in self._jitted:
            self._jitted[encoding] = jax.jit(
                build_detect_fn(self.config, self.camera, encoding))
        return self._jitted[encoding]

    def detect(self, image, encoding: str = "rgb8") -> Detections:
        det, _ = self._fn(encoding)(jnp.asarray(image))
        return det

    def detect_with_stats(self, image, encoding: str = "rgb8"
                          ) -> tuple[Detections, FrameStats]:
        return self._fn(encoding)(jnp.asarray(image))

    def detect_checked(self, image, encoding: str = "rgb8"
                       ) -> tuple[Detections, FrameStats]:
        """Debug entry point: run the pipeline under jax.experimental.checkify
        with explicit output-invariant checks, raising on violation.

        The sanitizer analog of the reference's CHECK_VPI_STATUS macros
        (survey §5.2; ref: apriltag_node.cpp:210,:228,:279) — jit purity
        already rules out data races, so the remaining runtime checks are
        numeric health of everything reported valid: finite corners/centers/
        poses, normalized quaternions, in-range ids, sane counts. (Whole-
        graph float_checks would false-positive on the pipeline's guarded
        degenerate paths — parallel-line intersections etc. are computed
        then masked.) Slower than detect(); not for the hot path.
        """
        from jax.experimental import checkify

        key = ("checked", encoding)
        if key not in self._jitted:
            fn = build_detect_fn(self.config, self.camera, encoding)
            ncodes = self.family.ncodes

            def checked(img):
                det, stats = fn(img)
                v = det.valid
                vm = lambda x: jnp.where(
                    v.reshape(v.shape + (1,) * (x.ndim - 1)), x, 0.0)
                checkify.check(jnp.all(jnp.isfinite(vm(det.corners))),
                               "non-finite corners on valid detections")
                checkify.check(jnp.all(jnp.isfinite(vm(det.center))),
                               "non-finite centers on valid detections")
                checkify.check(jnp.all(jnp.isfinite(vm(det.translation))),
                               "non-finite translations on valid detections")
                qn = jnp.sum(det.quaternion * det.quaternion, -1)
                checkify.check(
                    jnp.all(jnp.where(v, jnp.abs(qn - 1.0) < 1e-3, True)),
                    "unnormalized quaternions on valid detections")
                ok_id = (det.id >= 0) & (det.id < ncodes)
                checkify.check(jnp.all(jnp.where(v, ok_id, True)),
                               "tag id out of family range")
                checkify.check(
                    stats.num_detections == jnp.sum(v.astype(jnp.int32)),
                    "num_detections disagrees with the valid mask")
                return det, stats

            self._jitted[key] = jax.jit(
                checkify.checkify(checked, errors=checkify.user_checks))
        err, out = self._jitted[key](jnp.asarray(image))
        checkify.check_error(err)
        return out
