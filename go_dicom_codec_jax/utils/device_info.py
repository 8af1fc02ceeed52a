"""What a measurement ran on: JAX's device view and the card's own report.

Every tool that prints a number prints these beside it, so that a CPU
run is never read as a device number and a card set below its power
limit is visible.
"""

from __future__ import annotations

import subprocess
from typing import Optional


def device_summary() -> dict:
    """``{"platform", "kind", "count"}`` of JAX's default devices."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def gpu_name_and_power_limit() -> Optional[str]:
    """``nvidia-smi``'s ``name, power.limit`` lines (one per card), read
    in a child process that never imports JAX; None without a GPU."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    out = r.stdout.strip()
    return out if r.returncode == 0 and out else None
