"""Which device a measurement ran on.

Every number the benchmark or the smoke check prints names its device:
JAX's platform, device kind and count, and the card's name and power
limit as ``nvidia-smi`` reports them (a card set below its maximum
power runs slower under load).
"""

from __future__ import annotations

import subprocess


def nvidia_smi_name_power() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` for the first card,
    or "not available" where there is no such tool."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.SubprocessError):
        return "not available"
    lines = r.stdout.strip().splitlines()
    return lines[0].strip() if r.returncode == 0 and lines else "not available"


def jax_device() -> dict:
    """{"platform", "kind", "count"} of JAX's first device."""
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def require_gpu() -> dict:
    """jax_device(), or SystemExit when JAX finds no GPU: a measurement
    never falls back to the CPU."""
    dev = jax_device()
    if dev["platform"] != "gpu":
        raise SystemExit(
            f"no GPU: JAX's first device is {dev['platform']!r}"
        )
    return dev
