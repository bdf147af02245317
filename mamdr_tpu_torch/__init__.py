"""mamdr_tpu_torch — the PyTorch/CUDA port of mamdr_tpu for NVIDIA Hopper.

The JAX package ``mamdr_tpu`` is the reference; this package mirrors its
layout module for module and imports nothing of it. Entry points run on the
card: they take ``device="cpu"`` only when the caller asks for it (the CPU
tests do), and never fall back to the CPU on their own.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.

    Raises when no device is named and no CUDA card is present, so that a
    run meant for the card never silently lands on the CPU.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "mamdr_tpu_torch runs on a CUDA card and none is available; "
                "pass device='cpu' to run on the CPU explicitly"
            )
        return torch.device("cuda")
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device
