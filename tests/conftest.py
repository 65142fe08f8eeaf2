"""Test harness: an 8-device virtual CPU mesh.

The reference tests hardware variants via runtime platform sniffing
(ref: test/isaac_ros_apriltag_mono8_test.py:36-38); here the multi-device
story is testable anywhere via XLA's forced host device count (survey §4).
The suite runs on the CPU whatever `JAX_PLATFORMS` says, unless the `gpu`
marker is selected: tests marked `gpu` need a card and skip without one;
run them there with `python -m pytest -m gpu tests/`.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax
import numpy as np
import pytest

from isaac_ros_apriltag_tpu.utils.cache import enable_compile_cache

# Persistent compile cache: the detector graph takes minutes to compile on
# CPU; cache it across test runs.
enable_compile_cache()


def _selects_gpu(markexpr: str) -> bool:
    return "gpu" in markexpr and "not gpu" not in markexpr


def pytest_configure(config):
    """Pin the platform before any test touches a device: the CPU, or with
    `-m gpu` the card (and the CPU the card is compared with)."""
    if _selects_gpu(config.option.markexpr or ""):
        platforms = os.environ.get("JAX_PLATFORMS") or "cuda,cpu"
    else:
        platforms = "cpu"
    jax.config.update("jax_platforms", platforms)


@pytest.fixture
def gpu():
    """The first GPU; skips the test where JAX has none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run `python -m pytest -m gpu "
                    "tests/` on the card)")
    return dev


@pytest.fixture(scope="session")
def golden_scene():
    """Synthesized golden fixture (see utils/render.py docstring)."""
    from isaac_ros_apriltag_tpu.models.families import get_family
    from isaac_ros_apriltag_tpu.utils.render import GOLDEN, render_tags, upright_pose

    fam = get_family(GOLDEN["family"])
    R = upright_pose(GOLDEN["translation"])
    img = render_tags(GOLDEN["K"], GOLDEN["size"],
                      [dict(family=fam, id=GOLDEN["id"], R=R,
                            t=GOLDEN["translation"], tag_size=GOLDEN["tag_size"])])
    return img


@pytest.fixture(scope="session")
def small_camera():
    from isaac_ros_apriltag_tpu.camera.model import CameraModel

    return CameraModel.create(fx=420.0, fy=420.0, cx=320.0, cy=240.0,
                              width=640, height=480)


def make_scene(camera, tags, **kw):
    """Render tags onto a camera-sized grayscale image."""
    from isaac_ros_apriltag_tpu.utils.render import render_tags

    K = np.asarray(camera.K)
    return render_tags(K, (camera.height, camera.width), tags, **kw)
