"""The port's device rule: entry points run on ``"cuda"`` unless the
caller asks for the CPU, and refuse a card that is not there rather than
carry on on the CPU."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a torch device, refusing CUDA where there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} needs a CUDA device, but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "on the CPU")
    return dev
