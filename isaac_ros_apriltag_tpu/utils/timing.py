"""Throughput timing: async dispatch, then `jax.block_until_ready`."""

from __future__ import annotations

import time

import jax


def throughput(fn, x, iters: int):
    """Time `iters` back-to-back calls of fn(x) after one warmup call.

    Calls are dispatched asynchronously and the clock stops when the last
    result is ready (device execution is in order). Returns
    (seconds, first_output).
    """
    out0 = jax.block_until_ready(fn(x))   # compile + warmup
    t0 = time.perf_counter()
    out = out0
    for _ in range(iters):
        out = fn(x)
    jax.block_until_ready(out)
    return time.perf_counter() - t0, out0
