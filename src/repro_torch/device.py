"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

import os

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
    if dev.index is not None:
        return dev
    # a rank of a process group (one process a card, ``launch/mesh``)
    # serves on card LOCAL_RANK; otherwise "cuda" names the current card,
    # which tensors report with its index
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return torch.device("cuda", torch.cuda.current_device())
