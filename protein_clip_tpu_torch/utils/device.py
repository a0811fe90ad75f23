"""The device an entry point runs on: ``cuda`` unless the caller asks for
another (the tests pass ``cpu``). Asking for CUDA where there is none
raises; nothing falls back to the CPU."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` (a name or a ``torch.device``) as a ``torch.device``;
    raises when it is a CUDA device and CUDA is absent."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r}: CUDA is not available here "
                           "(pass device='cpu', or --device cpu, to run on the CPU)")
    return device
