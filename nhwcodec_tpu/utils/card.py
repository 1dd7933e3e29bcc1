"""What the benchmark and the smoke run print about the card they ran on."""

from __future__ import annotations

import subprocess


def require_gpu():
    """JAX's default device, which must be a GPU: device measurements
    and checks never fall back to the CPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX's default device is {dev.platform} "
                         f"({dev.device_kind})")
    return dev


def name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` for every card, one
    line each (the power limit bounds the clocks under load, so it goes
    beside every number)."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip()
