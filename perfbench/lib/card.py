"""The cards a run uses: their number, name and power limit."""

from __future__ import annotations

import shutil
import subprocess
from typing import List


def power_limits(count: int) -> List[str]:
    """``power.limit`` of cards 0..count-1 as ``nvidia-smi`` reports it
    (e.g. "700.00 W"); raises where nvidia-smi is missing or fails."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        raise RuntimeError("nvidia-smi not found: the cards' power limits cannot be read")
    lines = subprocess.run([smi, "--query-gpu=power.limit", "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60, check=True).stdout.strip().splitlines()
    return [ln.strip() for ln in lines[:count]]


def missing(chips: int) -> str:
    """Why this machine cannot run a cell of ``chips`` cards, or ""."""
    import torch

    if not torch.cuda.is_available():
        return "no CUDA device is available"
    if torch.cuda.device_count() < chips:
        return f"the cell needs {chips} cards, the machine has {torch.cuda.device_count()}"
    return ""
