"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def require_device(device) -> torch.device:
    """Resolve `device`; a CUDA device must exist.

    Entry points default to "cuda" and never fall back to the CPU when the
    card is missing: a run that silently lands on the CPU would report CPU
    numbers under the card's name. Callers that want the CPU ask for it.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    return device
