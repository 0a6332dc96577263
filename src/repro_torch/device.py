"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

import torch


def resolve(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on.

    ``cuda`` (the default everywhere) raises when CUDA is absent: the port
    never carries on on the CPU in silence.  The CPU is used only when the
    caller asks for it, as the parity tests do."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    # "cuda" names the current card; tensors report it with its index
    return dev if dev.index is not None else torch.device(
        "cuda", torch.cuda.current_device())
