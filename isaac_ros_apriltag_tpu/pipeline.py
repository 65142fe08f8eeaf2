"""Composable perception pipeline: rectify -> resize -> detect.

Replacement for the reference's launch-file node graph
(camera -> RectifyNode -> ResizeNode -> AprilTagNode, ref:
launch/isaac_ros_apriltag_usb_cam.launch.py:28-90, README.md:16-29). Stages
are pure functions composed inside ONE jit region, so XLA fuses the whole
graph and intermediate images never leave device memory — the role NITROS zero-copy
transport plays in the reference (README.md:61-63) falls out of the
programming model for free.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from .camera.model import CameraModel
from .config import DetectorConfig
from .detector import build_detect_fn
from .ops.grayscale import grayscale
from .ops.remap import SeparableRectify, remap_bilinear, resize_area
from .types import Detections, FrameStats


class GraphPipeline:
    """rectify (undistort) -> optional integer downscale -> detect.

    Reproduces the reference's "AprilTag Graph" benchmark configuration and
    the 8 MP -> 4:1 downscale path (README.md:24-26, :70).

    Rectification uses the banded separable warp by default
    (shift-mul-accumulate, no gathers; see ops/remap.py — not yet timed
    against the gather on the H100). Set `exact_remap=True` to use the
    gather-based `remap_bilinear` oracle instead.
    """

    def __init__(self, config: DetectorConfig, camera: CameraModel,
                 downscale: int = 1, encoding: str = "rgb8",
                 exact_remap: bool = False):
        self.config = config
        self.camera = camera
        self.downscale = int(downscale)
        self.encoding = encoding

        self._grid = None
        self._rectify = None
        if camera.has_distortion():
            grid = camera.rectify_map()
            if exact_remap:
                self._grid = jnp.asarray(grid)
            else:
                self._rectify = SeparableRectify.from_grid(np.asarray(grid))
        # Rectify maps enter as ARGUMENTS, not jit-closure constants: baked-in
        # maps bloat the executable (hundreds of MB at 8 MP) and slow
        # compilation.
        self.plan_args = ((self._rectify.sx2, self._rectify.sy2)
                          if self._rectify is not None else ())
        self.detect_camera = camera.scaled(1.0 / self.downscale) \
            if self.downscale > 1 else camera
        self._detect = build_detect_fn(config, self.detect_camera, "mono8")
        self._jitted = jax.jit(self.fn_with_plan)

    @property
    def fn(self):
        """The pure (unjitted) single-arg pipeline function. NB: under jit
        this embeds the rectify maps as constants; prefer `fn_with_plan` +
        `plan_args` for jit/vmap composition (see __init__ note)."""
        return lambda image: self.fn_with_plan(image, *self.plan_args)

    def fn_with_plan(self, image: jax.Array, *plan
                     ) -> tuple[Detections, FrameStats]:
        """Pipeline with the rectify maps passed explicitly (jit-friendly).

        vmap as jax.vmap(gp.fn_with_plan, in_axes=(0,) + (None,) * len(
        gp.plan_args)) and call with (*batch, *gp.plan_args)."""
        gray = grayscale(image, self.encoding)
        if self._rectify is not None:
            sx2, sy2 = plan
            gray = dataclasses.replace(self._rectify, sx2=sx2, sy2=sy2)(gray)
        elif self._grid is not None:
            gray = remap_bilinear(gray, self._grid)
        if self.downscale > 1:
            gray = resize_area(gray, self.downscale)
        return self._detect(gray.astype(jnp.float32))

    def __call__(self, image) -> tuple[Detections, FrameStats]:
        return self._jitted(jnp.asarray(image), *self.plan_args)


def batched_detect_fn(config: DetectorConfig, camera: CameraModel,
                      encoding: str = "mono8"):
    """vmap detect over a leading batch/camera axis: (B, H, W[, C]) frames."""
    fn = build_detect_fn(config, camera, encoding)
    return jax.vmap(fn)
