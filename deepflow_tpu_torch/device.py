"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: the
default is ``"cuda"``, and a missing CUDA device is an error, never a
silent fall back to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The torch.device to run on; raises RuntimeError for a CUDA device
    when CUDA is not available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run on the CPU")
    return dev
