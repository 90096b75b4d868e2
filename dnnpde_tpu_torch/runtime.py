"""Device selection for the PyTorch port.

Entry points take ``device=None``, which means the first CUDA card. The CPU
is used only when the caller asks for it by name; there is no silent fallback.
"""

from __future__ import annotations

import torch


def default_device(device=None) -> torch.device:
    """Resolve ``device``: None → ``cuda:0``; raises if CUDA is absent and the
    caller did not ask for the CPU explicitly."""
    if device is None:
        device = "cuda:0"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU"
        )
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def device_of(*xs, device=None) -> torch.device:
    """``device`` when given; else the device of the first tensor among
    ``xs``; else the first CUDA card (as :func:`default_device`). Tensors
    stay where they are; Python numbers and numpy arrays go to the card
    unless the caller names the CPU."""
    if device is None:
        for x in xs:
            if isinstance(x, torch.Tensor):
                return x.device
    return default_device(device)
