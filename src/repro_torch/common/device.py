"""The port's device rule for functions that create tensors."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises for CUDA where there is none.

    Tensor-creating entry points default to ``"cuda"`` and never drop to
    the CPU on their own: the caller asks for ``device="cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' to run on the CPU")
    return dev


def check_generator(generator: torch.Generator, device: torch.device) -> None:
    if generator.device.type != device.type:
        raise ValueError(f"generator is on {generator.device}, tensors go to {device}")
