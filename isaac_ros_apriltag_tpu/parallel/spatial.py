"""Spatial (halo-exchange) parallelism: one frame sharded by rows across
the device mesh (survey §5.7a — the multi-chip analog of the reference's
in-chip `tile_size` tiling, motivated by its 8 MP workload discussion,
ref: isaac_ros_apriltag/README.md:24-26).

The pixel-dominant front half of the pipeline (decimate -> threshold ->
CCL -> component sizes) runs sharded: each device owns a horizontal band of
the segmentation image and exchanges one-band halos with its neighbors via
`ppermute` over the mesh axis:

  - threshold needs a 2*tile_size halo (tile stats + 3x3 tile dilation);
    bands exchange `2*ts` edge rows, compute locally, and the result is
    bit-identical to the single-device threshold;
  - CCL runs with GLOBAL flat-index labels; after each block of local scan
    rounds the cut rows are exchanged and min-merged (same connectivity
    rule as the in-image scans: 4-neighborhood for both colors plus
    diagonals for white), so components spanning shards converge to the
    same global min-index representative as a single-device run — one
    extra outer round per crossed shard boundary;
  - component sizes are psum-reduced into the replicated (H*W,) table.

The back half (cluster moments -> quad fit -> refine -> decode -> pose) is
data-light (the cluster tables are KBs); the labels and trinary bands are
all-gathered and the tail runs replicated on every shard, returning results
identical to the single-device detector (asserted in tests/test_spatial.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..camera.model import CameraModel
from ..config import DetectorConfig
from ..ops.ccl import connected_components
from ..ops.threshold import adaptive_threshold


def _neighbor_rows(x: jax.Array, n_rows: int, axis_name: str, nshards: int):
    """Return (rows_from_above, rows_from_below) halo bands via ppermute.

    rows_from_above = the BOTTOM n_rows of the shard above (global y smaller);
    rows_from_below = the TOP n_rows of the shard below. Edge shards receive
    a 127-filled band (no-connectivity sentinel for trinary; harmless fill
    for labels since the mask excludes them).
    """
    down = [(i, i + 1) for i in range(nshards - 1)]      # send toward +y
    up = [(i + 1, i) for i in range(nshards - 1)]
    from_above = jax.lax.ppermute(x[-n_rows:], axis_name, down)
    from_below = jax.lax.ppermute(x[:n_rows], axis_name, up)
    return from_above, from_below


def _fill_edge(band, axis_name, which, nshards, fill):
    idx = jax.lax.axis_index(axis_name)
    is_edge = idx == 0 if which == "top" else idx == nshards - 1
    return jnp.where(is_edge, jnp.full_like(band, fill), band)


def spatial_threshold(gray_band: jax.Array, ts: int, min_diff: int,
                      axis_name: str, nshards: int) -> jax.Array:
    """Sharded adaptive threshold, bit-identical to the single-device op.

    gray_band: this shard's (Hb, W) rows of the segmentation image; Hb must
    be a multiple of ts. Halo = 2*ts rows each side (tile stats + dilation).
    """
    halo = 2 * ts
    above, below = _neighbor_rows(gray_band, halo, axis_name, nshards)
    # Edge fill: replicate the band's own edge rows (idempotent under the
    # min/max tile stats).
    above = jnp.where(jax.lax.axis_index(axis_name) == 0,
                      jnp.broadcast_to(gray_band[:1], above.shape), above)
    below = jnp.where(jax.lax.axis_index(axis_name) == nshards - 1,
                      jnp.broadcast_to(gray_band[-1:], below.shape), below)
    padded = jnp.concatenate([above, gray_band, below], 0)
    tri = adaptive_threshold(padded, ts, min_diff)
    return tri[halo:halo + gray_band.shape[0]]


_DIAG = ((1, 1), (1, -1), (-1, 1), (-1, -1))


def _merge_cut(tri_band, label_band, tri_nb, label_nb, side: str):
    """Min-merge labels across the horizontal cut with the CCL connectivity
    rule: vertical same-value for black+white, diagonals for white only."""
    row = 0 if side == "top" else -1
    t0 = tri_band[row]
    l0 = label_band[row]
    best = l0
    for dx in (-1, 0, 1):
        tn = jnp.roll(tri_nb, -dx)
        ln = jnp.roll(label_nb, -dx)
        if dx == -1:
            tn = tn.at[-1].set(jnp.uint8(127))
        if dx == 1:
            tn = tn.at[0].set(jnp.uint8(127))
        conn = (tn == t0) & (t0 != 127) if dx == 0 else \
            (tn == t0) & (t0 == 255)
        best = jnp.minimum(best, jnp.where(conn, ln, l0))
    return label_band.at[row].set(best)


def spatial_ccl(tri_band: jax.Array, y0: jax.Array, W: int, axis_name: str,
                nshards: int, rounds: int, outer: int) -> jax.Array:
    """Sharded CCL with global flat-index labels.

    y0: this shard's first global row index. `outer` halo-merge rounds each
    run `rounds` local scan rounds (jumps disabled — labels are global).
    """
    Hb = tri_band.shape[0]
    ys = y0 + jax.lax.broadcasted_iota(jnp.int32, (Hb, W), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (Hb, W), 1)
    label = ys * W + xs

    def body(_, label):
        label = connected_components(tri_band, rounds=rounds, jumps=0,
                                     label0=label)
        t_above, t_below = _neighbor_rows(tri_band, 1, axis_name, nshards)
        l_above, l_below = _neighbor_rows(label, 1, axis_name, nshards)
        t_above = _fill_edge(t_above, axis_name, "top", nshards, jnp.uint8(127))
        t_below = _fill_edge(t_below, axis_name, "bottom", nshards, jnp.uint8(127))
        label = _merge_cut(tri_band, label, t_above[0], l_above[0], "top")
        label = _merge_cut(tri_band, label, t_below[0], l_below[0], "bottom")
        return label

    return jax.lax.fori_loop(0, outer, body, label)


def build_spatial_front_fn(config: DetectorConfig, camera: CameraModel,
                           mesh: Mesh, axis: str = "y",
                           encoding: str = "mono8",
                           outer_rounds: int | None = None):
    """jit-compiled sharded front half: (H, W) frame -> (trinary, label).

    The frame enters replicated; decimate/threshold/CCL run row-sharded
    over `axis`; the outputs are all-gathered (replicated) and are EXACTLY
    equal to the single-device ops' outputs (asserted in
    tests/test_spatial.py), so the detector tail consumes them unchanged.

    outer_rounds: halo-merge rounds. A component spanning k shard cuts
    needs ~k merge rounds, so the default scales with the mesh:
    max(3, nshards - 1).
    """
    front = _build_front(config, camera, mesh, axis, encoding, outer_rounds)
    return jax.jit(lambda frame: front(frame)[1:])


def _build_front(config: DetectorConfig, camera: CameraModel, mesh: Mesh,
                 axis: str, encoding: str, outer_rounds: int | None):
    """Unjitted sharded front: frame -> (gray, trinary, label)."""
    cfg = config
    nshards = mesh.shape[axis]
    if outer_rounds is None:
        outer_rounds = max(3, nshards - 1)

    H = camera.height // cfg.quad_decimate
    Hp0 = -(-H // cfg.tile_size) * cfg.tile_size
    # Bands must start on GLOBAL tile boundaries for the threshold to be
    # bit-identical to the single-device op; when Hp0 doesn't split into
    # tile-aligned bands, pad with edge rows to the next aligned height and
    # crop after the gather. Padded rows are forced to 127 before CCL; when
    # padding engages, the bottom tile row's dilated threshold stats may
    # differ from the single-device op's (detections are unaffected — tags
    # touching the absolute bottom edge are already truncated).
    Hp = -(-Hp0 // (nshards * cfg.tile_size)) * (nshards * cfg.tile_size)

    def fn(frame):
        from ..detector import _decimate, _pad_to_tiles
        from ..ops.grayscale import grayscale

        gray = grayscale(frame, encoding)
        seg = _pad_to_tiles(_decimate(gray, cfg.quad_decimate), cfg.tile_size)
        if Hp != Hp0:
            seg = jnp.pad(seg, ((0, Hp - Hp0), (0, 0)), mode="edge")
        band = seg.reshape(nshards, Hp // nshards, seg.shape[-1])

        def per_shard(b):
            b = b.reshape(b.shape[-2], b.shape[-1])
            tri = spatial_threshold(b, cfg.tile_size,
                                    cfg.min_white_black_diff, axis, nshards)
            y0 = jax.lax.axis_index(axis) * (Hp // nshards)
            if Hp != Hp0:
                rows = y0 + jax.lax.broadcasted_iota(
                    jnp.int32, tri.shape, 0)
                tri = jnp.where(rows < Hp0, tri, jnp.uint8(127))
            lab = spatial_ccl(tri, y0, tri.shape[-1], axis, nshards,
                              rounds=cfg.ccl_rounds, outer=outer_rounds)
            tri_full = jax.lax.all_gather(tri, axis, axis=0,
                                          tiled=True)
            lab_full = jax.lax.all_gather(lab, axis, axis=0, tiled=True)
            return tri_full, lab_full

        tri_full, lab_full = jax.shard_map(
            per_shard, mesh=mesh, in_specs=P(axis), out_specs=P(),
            check_vma=False)(band)
        return gray, tri_full[:Hp0], lab_full[:Hp0]

    return fn


class SpatialDetector:
    """One-call row-sharded detector: ONE frame split across the device mesh
    (survey §5.7a — the multi-chip analog of the reference's 8 MP workload,
    ref: isaac_ros_apriltag/README.md:24-26).

    The pixel-dominant front half (decimate -> threshold -> CCL with
    ppermute halo merges) runs row-sharded over `axis`; the data-light tail
    (resolve -> clusters -> quads -> refine -> decode -> pose) runs
    replicated after an all_gather, inside the SAME jit region. Detections
    equal the single-device Detector's (asserted in tests/test_spatial.py).
    """

    def __init__(self, config: DetectorConfig, camera: CameraModel,
                 mesh: Mesh, axis: str = "y", encoding: str = "mono8",
                 outer_rounds: int | None = None):
        from ..detector import detect_tail
        from ..models.families import get_family

        self.config = cfg = config
        self.camera = camera
        self.mesh = mesh
        family = get_family(cfg.tag_family)
        front = _build_front(config, camera, mesh, axis, encoding,
                             outer_rounds)

        def fn(frame):
            gray, tri_full, lab_full = front(frame)
            # The sharded CCL carries no per-round convergence flag; the
            # resolve stage's chain-fixpoint flag inside detect_tail is the
            # convergence telemetry for this path.
            return detect_tail(cfg, camera, family, gray, tri_full, lab_full,
                               jnp.bool_(True))

        self._jitted = jax.jit(fn)
        self.fn = fn

    def detect(self, frame):
        det, _ = self._jitted(jnp.asarray(frame))
        return det

    def detect_with_stats(self, frame):
        return self._jitted(jnp.asarray(frame))
