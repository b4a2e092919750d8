"""Device selection for the port's entry points.

Every entry point takes an explicit ``device`` that defaults to ``cuda``.
Without a GPU it raises unless the caller asked for the CPU, where the
kernels' plain PyTorch versions run. It never carries on quietly on the
CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises for ``cuda`` without a GPU
    and for any device type other than ``cuda`` and ``cpu``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions of the kernels on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def check_on(device: torch.device, **tensors) -> None:
    """Raise unless every named tensor lies on ``device``."""
    for name, t in tensors.items():
        if t.device.type != device.type or (
                device.index is not None and t.device.index != device.index):
            raise ValueError(f"{name} is on {t.device}, expected {device}")
