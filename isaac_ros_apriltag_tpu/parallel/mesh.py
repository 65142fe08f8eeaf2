"""Device mesh construction + sharding helpers.

The reference's concurrency story is CUDA streams + a multithreaded ROS
component container in one process (survey §2.3; ref: launch/
isaac_ros_apriltag_usb_cam.launch.py:81). Here the scaling axes are a jax
device mesh with named axes:

  'cam'  — data parallelism across cameras of a rig (and/or frame batches)
  'map'  — map-block parallelism for the SLAM layer (landmark shards)

The cards of one host reach each other all to all at one rate, so the mesh
follows the algorithm alone; jax.sharding + shard_map insert the
collectives from the named-axis program.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None) -> None:
    """Join this process to a multi-host run (survey §5.8).

    Thin deterministic wrapper over jax.distributed.initialize. Pass
    `coordinator_address` (e.g. "localhost:<port>"), `num_processes` and
    `process_id` explicitly: nothing in a plain GPU cluster tells JAX
    about them. Must run before any jax computation. After it,
    jax.devices() spans every process (enumerated process-major).

    The reference has no multi-machine story at all (DDS pub/sub inside one
    node graph); this is the entry point its replacement needs for the
    4-host/16-camera BASELINE configuration.
    """
    kwargs = {}
    if coordinator_address is not None:
        kwargs.update(coordinator_address=coordinator_address,
                      num_processes=num_processes, process_id=process_id)
    jax.distributed.initialize(**kwargs)


def make_mesh(n_cam: int | None = None, n_map: int = 1,
              devices=None) -> Mesh:
    """Build a (cam, map) mesh over the available devices.

    Defaults to all devices on the 'cam' axis (the throughput axis for
    detection). n_cam * n_map must equal the device count: pass `devices`
    to use a subset. Raises instead of dropping devices.
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if n_cam is None:
        if n % n_map:
            raise ValueError(f"n_map={n_map} does not divide {n} devices")
        n_cam = n // n_map
    if n_cam * n_map != n:
        raise ValueError(f"mesh {n_cam}x{n_map} does not cover {n} devices; "
                         "pass devices= to choose a subset")
    devs = np.asarray(devices).reshape(n_cam, n_map)
    return Mesh(devs, ("cam", "map"))


def cam_sharding(mesh: Mesh) -> NamedSharding:
    """Shard a (B, ...) batch of frames over the 'cam' axis."""
    return NamedSharding(mesh, P("cam"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def map_sharding(mesh: Mesh) -> NamedSharding:
    """Shard a (L, ...) landmark/map-block array over the 'map' axis."""
    return NamedSharding(mesh, P("map"))
