"""The H100 SXM's published peaks (NVIDIA's data sheet, dense rates, at
the 700 W power limit): the yardstick for the shares of a roofline and
for the model FLOP utilisation. float32 work is held against the TF32
tensor-core rate, which no float32-accurate path can pass."""

from __future__ import annotations

import subprocess

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 495e12}
HBM_BYTES_PER_S = 3.35e12


def peak_flops(dtype: str) -> float:
    return PEAK_FLOPS[dtype]


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e})"
