"""Detector configuration + backend registry + eager validation.

Mirrors the reference's parameter surface (ref: isaac_ros_apriltag/src/
apriltag_node.cpp:564-568: max_tags=64, size=0.22, tile_size=4,
tag_family="tag36h11", backends="CUDA") and its constructor-time
family-vs-backend validation (ref: apriltag_node.cpp:584-599), re-expressed as
a frozen dataclass validated eagerly at construction.

Backends (the reference's CPU|CUDA|PVA trait, ref: apriltag_node.cpp:576-582):
  - 'scan'  production: two-phase scan CCL (scan rounds -> compacted
            rank-space contraction -> scan rounds), plain JAX throughout
  - 'xla'   correctness oracle: scan CCL with rationed pointer jumps
"""

from __future__ import annotations

import dataclasses

from .models.families import FAMILY_SPECS, family_names

BACKENDS = ("xla", "scan")

# Family support matrix per backend. Unlike the reference — whose CUDA backend
# supports only tag36h11 (ref: apriltag_node.cpp:429-432, README.md:49-59) —
# every backend here is table-driven and supports all nine families; the matrix
# exists so configs stay validated if a restricted backend is ever added.
BACKEND_FAMILIES = {b: tuple(family_names()) for b in BACKENDS}


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """Static (jit-constant) detector parameters."""

    # Reference-visible parameters (apriltag_node.cpp:564-568).
    tag_family: str = "tag36h11"
    max_tags: int = 64
    tag_size: float = 0.22          # edge length of the border square, meters
    tile_size: int = 4              # adaptive-threshold tile edge, pixels
    backend: str = "scan"

    # Segmentation decimation (AprilTag 3's quad_decimate; the closed
    # reference backends decimate likewise). Segmentation/quad-fitting run on
    # a (H/d, W/d) mean-pooled image; corner refinement and decoding run on
    # the full-resolution image, so corner accuracy is preserved; d=2 also
    # quarters every per-pixel label and size table.
    quad_decimate: int = 2

    # Pipeline capacities (all static; data-dependent counts are handled
    # with validity masks, same tradeoff as the reference's max_tags arrays,
    # ref: apriltag_node.cpp:285-289). max_edge_points / max_components are
    # CAPS: the effective capacities scale with the segmentation-image pixel
    # count (see effective_capacities) so 720p inputs don't pay 1080p-sized
    # sorts and 1080p keeps stride-1 headroom (measured 272k gated boundary
    # pairs at noisy 1080p).
    max_edge_points: int = 1 << 19   # cap on compacted boundary points
    max_clusters: int = 128          # candidate boundary clusters kept
    max_cluster_points: int = 1024   # points retained per cluster
    # CCL iteration (XLA oracle path; see ops/ccl.py): scan rounds plus
    # pointer-jump passes rationed to every `ccl_jump_every`-th round (jumps
    # converge components attached through noisy percolation corridors, but
    # each pass is a full-image serializing gather, so they are rationed).
    ccl_rounds: int = 8              # scan/propagate rounds (see ops/ccl.py)
    ccl_jumps: int = 2               # pointer-jumping passes per jump round
    ccl_jump_every: int = 4          # jump rounds: every Nth round
    # Two-phase scan CCL (scan backend; ops/ccl.two_phase_ccl): two scan
    # phases with a compacted chain CONTRACTION (ops/resolve.resolve_roots_rank)
    # between them, in place of full-image pointer jumps. A SINGLE long
    # scan phase is non-monotonic in rounds under percolation noise — a
    # distant min label can propagate PARTWAY into a tag border and split
    # its labels (tests/test_resolve.py sweeps the noise levels) — while
    # contraction + a short second phase re-converges the border.
    # Residual chains are finished exactly by ops/resolve.py with
    # `ccl_resolve_steps` pointer doublings (both backends run the same
    # final resolve).
    ccl_scan_rounds: int = 8         # phase-1 scan rounds
    ccl_phase2_rounds: int = 6       # post-contraction scan rounds (0 = off)
    # Chain pointer-doublings (depth 2^n). The mid-loop contraction faces
    # phase-1 chains (depth up to ~24 at 8 rounds on noisy scenes -> 5
    # doublings);
    # the final resolve only sees chains formed during the short phase 2
    # (depth <= phase2_rounds + 1 -> 3 doublings). Both report shortfall
    # via the converged flag (FrameStats.ccl_converged).
    ccl_contraction_steps: int = 5
    ccl_resolve_steps: int = 3
    max_components: int = 1 << 16    # distinct-label capacity in resolve

    # Threshold / segmentation tuning (AprilTag-3 standard values).
    min_white_black_diff: int = 5
    min_cluster_pixels: int = 24
    min_component_pixels: int = 25

    # Decode tuning.
    max_hamming: int = 2
    decode_sharpening: float = 0.25
    min_decision_margin: float = 10.0

    def effective_capacities(self, seg_h: int, seg_w: int) -> tuple[int, int]:
        """(edge_points, components) for a segmentation image of seg_h x
        seg_w pixels: 3/4 boundary pairs and 1/8 distinct labels per pixel
        (both ~2x the worst measured noisy-scene counts), capped by the
        config fields. Static per camera (jit-shape-safe)."""
        hw = seg_h * seg_w
        return (min(self.max_edge_points, max((3 * hw) // 4, 1024)),
                min(self.max_components, max(hw // 8, 256)))

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"Invalid backend {self.backend!r}; expected one of {BACKENDS}")
        if self.tag_family not in FAMILY_SPECS:
            raise ValueError(
                f"Invalid tag family {self.tag_family!r}; expected one of {family_names()}")
        if self.tag_family not in BACKEND_FAMILIES[self.backend]:
            raise ValueError(
                f"Tag family {self.tag_family!r} not supported by backend {self.backend!r}")
        if self.max_tags <= 0 or self.max_tags > self.max_clusters:
            raise ValueError("max_tags must be in (0, max_clusters]")
        if self.max_clusters > 128:
            # cluster_moments broadcasts slot ids with an 8-bit packed
            # cummax (ops/cluster_moments.py); more than 128 slots would
            # not fit the pack.
            raise ValueError("max_clusters must be <= 128 "
                             "(8-bit slot packing in the cluster broadcast)")
        if self.tile_size < 2:
            raise ValueError("tile_size must be >= 2")
        if self.quad_decimate < 1:
            raise ValueError("quad_decimate must be >= 1")
        if self.ccl_jump_every < 1:
            raise ValueError("ccl_jump_every must be >= 1")
        if self.ccl_scan_rounds < 1:
            raise ValueError("ccl_scan_rounds must be >= 1")
        if self.ccl_phase2_rounds < 0:
            raise ValueError("ccl_phase2_rounds must be >= 0")
        if self.ccl_resolve_steps < 1:
            raise ValueError("ccl_resolve_steps must be >= 1")
        if self.max_components < 1:
            raise ValueError("max_components must be >= 1")
        if self.max_components > (1 << 16):
            # resolve's packed-cummax broadcast carries the group rank in 16
            # high bits (ops/resolve.py); more distinct groups than 2^16
            # would silently leak dense ids across group boundaries.
            raise ValueError("max_components must be <= 65536 "
                             "(resolve packs group ranks into 16 bits)")
        if self.ccl_rounds < 1:
            raise ValueError("ccl_rounds must be >= 1")
        fam_h = FAMILY_SPECS[self.tag_family][1]
        if self.max_hamming > (fam_h - 1) // 2:
            raise ValueError(
                f"max_hamming={self.max_hamming} too large for {self.tag_family} "
                f"(min distance {fam_h})")
