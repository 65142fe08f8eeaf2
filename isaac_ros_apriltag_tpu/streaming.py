"""Streaming runner: double-buffered host->device frame feed.

The reference hides host/device overlap inside CUDA streams + NITROS
zero-copy transport (ref: isaac_ros_apriltag/src/apriltag_node.cpp:279-303,
README.md:61-63). The JAX-native equivalent exploits ASYNC DISPATCH: both
`jax.device_put` and jitted calls return immediately with futures, so the
host can upload frame k+1 and enqueue its detect while the device is still
computing frame k. This runner keeps a bounded window of in-flight frames
and only blocks when the window is full — a software double (or N-) buffer.

Blocking semantics: results are yielded IN ORDER, each once
`jax.block_until_ready` returns for it; `depth=2` gives classic double
buffering (upload k+1 overlaps compute k). `depth=1` degenerates to the
synchronous loop (the overlap-gain baseline in bench.py).
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Iterable, Iterator

import jax


class StreamingRunner:
    """Pipelines `fn` (a jitted frame -> result function) over a frame
    stream with up to `depth` frames in flight."""

    def __init__(self, fn: Callable, depth: int = 2):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self.fn = fn
        self.depth = depth

    def run(self, frames: Iterable) -> Iterator:
        """Yield fn(frame) for each frame, in order, pipelined."""
        inflight: deque = deque()
        for frame in frames:
            # Async H2D copy, then async dispatch: neither blocks the host.
            x = jax.device_put(frame)
            out = self.fn(x)
            inflight.append(out)
            if len(inflight) >= self.depth:
                yield jax.block_until_ready(inflight.popleft())
        while inflight:
            yield jax.block_until_ready(inflight.popleft())


def run_stream(fn: Callable, frames: Iterable, depth: int = 2) -> list:
    """Convenience: collect StreamingRunner results into a list."""
    return list(StreamingRunner(fn, depth).run(frames))
