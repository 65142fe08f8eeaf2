"""The GPU entry points' platform check and card identity."""

from __future__ import annotations

import subprocess
import sys

import jax


def require_gpu(tool: str, count: int = 1) -> list:
    """The first `count` GPUs; exits with status 2 (no fallback) when JAX
    finds fewer."""
    devices = jax.devices()
    if devices[0].platform != "gpu" or len(devices) < count:
        print(f"{tool}: needs {count} NVIDIA GPU(s); JAX found "
              f"{len(devices)} {devices[0].platform!r} device(s)",
              file=sys.stderr)
        sys.exit(2)
    return devices[:count]


def card_lines() -> list[str]:
    """`name, power.limit` per card as nvidia-smi reports them (a child
    process, off JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]
