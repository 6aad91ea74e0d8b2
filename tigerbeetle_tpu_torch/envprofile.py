"""Environment fingerprint for benchmark records.

Every benchmark line (`cli benchmark`'s BENCH_JSON) is stamped with a
machine-readable profile of the environment that produced it, so a
number taken on an H100 is distinguishable from one taken on a
CPU-only host by construction.

The stable identity is `profile_id`: a short hash over the fields that
decide what a number means —

    system / machine / cpu_count   (the host)
    accel_backend / accel_kind / accel_count
                                   (the CUDA card the port runs on:
                                    "cuda", torch's device name and
                                    count; "none" without a card)

Recorded beside them but not hashed: the card's power limit (a card may
be capped below its maximum and then runs slower under load), the
driver, and the CUDA, torch, numpy and Python versions. A library
upgrade on the same host continues the same series; a power cap is a
fact to read beside every number.
"""

from __future__ import annotations

import hashlib
import json
import os
import platform
import subprocess

# The fields that participate in the profile_id hash, in hash order.
PROFILE_ID_FIELDS = (
    "system",
    "machine",
    "cpu_count",
    "accel_backend",
    "accel_kind",
    "accel_count",
)


def profile_id_from(fields: dict) -> str:
    """Stable 12-hex-char id over PROFILE_ID_FIELDS (missing keys hash
    as null)."""
    blob = json.dumps([fields.get(k) for k in PROFILE_ID_FIELDS])
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:12]


def _nvidia_smi(query: str) -> str:
    """The first card's `query` fields as nvidia-smi prints them, or ""
    where it is missing or fails."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired):
        return ""
    lines = out.stdout.strip().splitlines() if out.returncode == 0 else []
    return lines[0].strip() if lines else ""


def fingerprint() -> dict:
    """The environment profile of this process, profile_id included."""
    info = {
        "system": platform.system(),
        "machine": platform.machine(),
        "cpu_count": int(os.cpu_count() or 0),
        "accel_backend": "none",
        "accel_kind": "none",
        "accel_count": 0,
        "python": platform.python_version(),
    }
    import numpy
    import torch

    info["numpy"] = numpy.__version__
    info["torch"] = torch.__version__
    info["cuda"] = torch.version.cuda or "none"
    if torch.cuda.is_available():
        info["accel_backend"] = "cuda"
        info["accel_kind"] = torch.cuda.get_device_name(0)
        info["accel_count"] = torch.cuda.device_count()
        # "NVIDIA H100 80GB HBM3, 700.00 W": the line every number of the
        # port is quoted beside.
        info["name_power_limit"] = _nvidia_smi("name,power.limit")
        info["driver"] = _nvidia_smi("driver_version")
    info["profile_id"] = profile_id_from(info)
    return info
