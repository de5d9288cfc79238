"""Accelerator guard for the entry points that measure or prove the GPU path.

``chip_smoke.py`` and ``bench.py`` call ``require_gpu`` before any work.
JAX quietly falls back to the CPU when its CUDA plugin fails to start, so
without this check a broken installation would report CPU numbers as if they
came from the card.
"""

from __future__ import annotations

import shutil
import subprocess
from typing import List


def require_gpu() -> List:
    """Return ``jax.devices()``; raise unless the first device is a GPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX found platform {devs[0].platform!r} "
            f"({devs[0].device_kind}); this entry point has no CPU fallback")
    return devs


def nvidia_smi() -> List[str]:
    """One line per card: its name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit`` reports them."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        raise RuntimeError("nvidia-smi not found")
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def device_info() -> dict:
    """What every GPU result is reported beside: JAX's view of the devices
    plus the card's name and power limit as nvidia-smi reports them."""
    devs = require_gpu()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "nvidia_smi": nvidia_smi()}
