"""The card's line: its name and power limit, printed beside every number.

A frozen copy of ``mamdr_tpu_torch.utils.timing.card_line``: what
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints for
the first card, or "unknown" where it cannot be read.
"""

from __future__ import annotations

import subprocess


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    lines = out.strip().splitlines()
    return lines[0] if lines else "unknown"
