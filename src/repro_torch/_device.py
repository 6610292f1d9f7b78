"""Device resolution for the port's entry points.

The entry points run on the card unless the caller asks for the CPU by
name. There is no fallback: asking for ``cuda`` (the default) on a
machine without a card raises.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "device_info"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``cuda``. A CUDA device that is absent raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def device_info(device: torch.device) -> dict:
    """What a result records about where it ran."""
    if device.type == "cuda":
        return {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(device),
            "count": torch.cuda.device_count(),
        }
    return {"platform": "cpu", "kind": "cpu", "count": 1}
