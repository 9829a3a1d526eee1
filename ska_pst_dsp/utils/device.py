"""The accelerator a measurement runs on.

Every device number this repository prints names its card: JAX's platform,
device kind and device count, and the card's name and power limit as
``nvidia-smi`` reports them (a card set below its top power limit runs
slower under load).
"""

from __future__ import annotations

import subprocess


def require_gpu() -> dict:
    """Return ``{"platform", "kind", "count"}`` of the first JAX device, or
    exit non-zero when JAX found no GPU: a measurement never falls back to
    the CPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX's first device is {dev.platform!r} ({dev}); "
            "device measurements refuse to run on it"
        )
    return {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
    }


def record() -> dict:
    """The device a product was made on, for its report: JAX's platform
    and device kind, plus the card's name and power limit on a GPU."""
    import jax

    dev = jax.devices()[0]
    rec = {"backend": dev.platform, "device": dev.device_kind}
    if dev.platform == "gpu":
        rec["nvidia_smi"] = nvidia_smi()
    return rec


def nvidia_smi() -> str:
    """``name, power.limit`` of each card, one line per card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
