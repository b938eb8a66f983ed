"""Device resolution: ``device_type`` -> ``torch.device``.

The port runs on the card unless the caller asks for the CPU: with
``device_type=cuda`` (the default) and no card present it raises
instead of falling back.
"""
from __future__ import annotations

import torch

from .log import LightGBMError

__all__ = ["resolve_device"]


def resolve_device(device_type: str) -> torch.device:
    dt = str(device_type).strip().lower()
    if dt == "cpu":
        return torch.device("cpu")
    if dt in ("cuda", "gpu"):
        if not torch.cuda.is_available():
            raise LightGBMError(
                "device_type=cuda but torch sees no CUDA device; pass "
                "device_type=cpu to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    raise LightGBMError(f"unknown device_type {device_type!r} "
                        "(expected cuda or cpu)")
