"""What the process runs on: the GPU check and the card's name and power
limit, as the bench and the smoke check report them beside every time."""

from __future__ import annotations

import subprocess

NVIDIA_SMI_QUERY = (
    "nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
)


def require_gpu(devices):
    """Return ``devices`` when the first is a GPU; otherwise raise
    ``SystemExit`` (there is no CPU fallback for a measurement)."""
    if not devices or devices[0].platform != "gpu":
        found = devices[0].platform if devices else "no device"
        raise SystemExit(f"needs an NVIDIA GPU; JAX found {found}")
    return devices


def nvidia_smi_lines() -> list[str]:
    """The ``name, power.limit`` line of each card, as ``nvidia-smi``
    prints it (empty when the tool is missing or fails)."""
    try:
        out = subprocess.run(
            NVIDIA_SMI_QUERY, capture_output=True, text=True, timeout=30,
            check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def parse_nvidia_smi_line(line: str) -> dict:
    """``"NVIDIA H100 80GB HBM3, 700.00 W"`` -> ``{"name": ..., "power_limit_w":
    700.0}``; a limit the tool cannot read (``[N/A]``) gives None."""
    name, sep, limit = line.rpartition(",")
    if not sep:
        raise ValueError(f"not a 'name, power.limit' line: {line!r}")
    value = limit.strip().removesuffix("W").strip()
    try:
        watts = float(value)
    except ValueError:
        watts = None
    return {"name": name.strip(), "power_limit_w": watts}
