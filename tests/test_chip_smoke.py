"""The GPU entry points refuse other platforms; chip_smoke.py's phases at a
small size on the CPU (and, on a card only, its card-vs-CPU precision
check); the compile-cache helper and the backend registry."""

import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

from isaac_ros_apriltag_tpu import BACKENDS, DetectorConfig
from isaac_ros_apriltag_tpu.utils.cache import (CHECKOUT_CACHE_DIR,
                                                enable_compile_cache)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    sys.path.insert(0, REPO)
    import chip_smoke
    return chip_smoke


@pytest.mark.parametrize("script,alone", [("chip_smoke.py", False),
                                          ("chip_smoke.py", True),
                                          ("bench.py", False)])
def test_gpu_scripts_refuse_cpu(script, alone, tmp_path):
    """Without a GPU (or, for chip_smoke.py, without the rest of the repo)
    the scripts exit non-zero and print no result line."""
    path = os.path.join(REPO, script)
    if alone:
        path = shutil.copy(path, tmp_path / script)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    if alone:
        env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, path], cwd=os.path.dirname(path),
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0, res.stdout
    assert '"ok": true' not in res.stdout
    assert ("cannot import the package" if alone else "GPU") in res.stderr


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # sets nothing


def test_compile_cache_defaults_to_checkout(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        assert enable_compile_cache() == CHECKOUT_CACHE_DIR
        assert jax.config.jax_compilation_cache_dir == CHECKOUT_CACHE_DIR
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    assert os.path.dirname(CHECKOUT_CACHE_DIR) == REPO
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


@pytest.mark.parametrize("backend", ["pallas", "interpret", "cuda"])
def test_config_rejects_removed_backends(backend):
    assert BACKENDS == ("xla", "scan")
    assert DetectorConfig().backend == "scan"
    with pytest.raises(ValueError, match="Invalid backend"):
        DetectorConfig(backend=backend)


@pytest.mark.gpu
def test_precision_on_card(gpu):
    """The f32 stages agree between the card and the CPU (HIGHEST-pinned
    contractions): the check chip_smoke.py's precision phase runs."""
    chip_smoke = _chip_smoke()
    from isaac_ros_apriltag_tpu.utils.render import (project_corners,
                                                     six_tag_scene)

    cam, gray, tags = six_tag_scene(240, 320)
    K = np.asarray(cam.K)
    corners = np.stack([project_corners(K, t["R"], t["t"], t["tag_size"])
                        for t in tags]).astype(np.float32)
    rgb = np.repeat(gray[..., None], 3, axis=-1)
    res = chip_smoke.check_precision(rgb, corners, K, 0.3)
    for name, (diff, tol) in res.items():
        assert diff <= tol, (name, diff, tol)


def test_smoke_phases_small_on_cpu():
    """chip_smoke.py's one-card phases at a small size on the CPU: the
    checks themselves (ground truth, oracle, batched vs single, graph,
    stream, precision) hold wherever they run."""
    cs = _chip_smoke()
    compile_s = {}
    _, (rgb, det, cam) = cs.phase_reference_node(compile_s, 480, 640)
    _, (frames, singles) = cs.phase_bench_config(compile_s, 2, 480, 640)
    assert "ids [1, 8, 15, 22, 29, 36]" in cs.phase_graph(compile_s, 0.5)
    cs.phase_stream(frames, singles, 4)
    cs.phase_precision(rgb, det, cam)
    assert len(compile_s) == 7


def test_smoke_multi_phases_on_virtual_devices():
    """chip_smoke.py --multi's phases on four virtual CPU devices at a
    small size."""
    cs = _chip_smoke()
    devices = jax.devices()[:4]
    cs.phase_rig(devices, n_cams=8, H=480, W=640)
    assert "known fault (ROADMAP R7)" in cs.phase_spatial(devices, H=480,
                                                          W=640)
    cs.phase_dba(devices, n_kf=12, cols=8, rows=4)
