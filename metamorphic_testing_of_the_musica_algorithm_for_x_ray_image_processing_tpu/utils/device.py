"""The accelerator a measurement runs on: JAX's view of it and the card's
own name and power limit (read with ``nvidia-smi``, without JAX)."""

from __future__ import annotations

import subprocess


def card_line() -> str:
    """``"<name>, <power limit>"`` of the first card, exactly as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints
    it.  A card may be set below its maximum power and then runs slower
    under load, so every timing is reported beside this line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def require_gpu():
    """JAX's first device; ``RuntimeError`` when it is not a GPU, so that a
    measurement never falls back to the CPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(f"no GPU: JAX's first device is {dev.platform} "
                           f"({dev.device_kind})")
    return dev


def device_record() -> dict:
    """The device keys every result line carries."""
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}
