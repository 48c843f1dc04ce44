"""What a result line says about the device it ran on."""

from __future__ import annotations

import shutil
import subprocess

__all__ = ["card_name_and_power_limit", "device_record"]


def card_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card, as
    nvidia-smi prints it (a card may be set below its maximum power and
    then runs slower under load, so every number keeps this beside it)."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return "nvidia-smi not found"
    res = subprocess.run([exe, "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    lines = res.stdout.strip().splitlines()
    return lines[0].strip() if lines else res.stderr.strip()


def device_record() -> dict:
    """Platform, kind and count as JAX reports them, plus the card line."""
    import jax
    dev = jax.devices()[0]
    rec = {"platform": dev.platform, "kind": dev.device_kind,
           "count": len(jax.devices())}
    if dev.platform == "gpu":
        rec["card"] = card_name_and_power_limit()
    return rec
