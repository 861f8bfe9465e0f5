"""Device selection for the port's entry points.

Every entry point takes an explicit ``device`` (default ``"cuda"``) and
resolves it here.  Asking for CUDA on a machine without a card raises: no
entry point carries on silently on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} was asked for but torch sees no CUDA card; "
            f"pass device='cpu' to run the plain PyTorch paths")
    return dev
