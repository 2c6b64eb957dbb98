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


class MetaGenerator(torch.Generator):
    """The meta device's stand-in generator: a CPU generator that random ops
    on meta tensors take and draw nothing from. Only it passes
    ``check_generator`` for the meta device."""


def make_generator(device, seed: int) -> torch.Generator:
    """A generator seeded with ``seed`` for tensors on ``device``: the
    device's own, or on the meta device (which has none) a
    ``MetaGenerator``."""
    dev = torch.device(device)
    gen = MetaGenerator() if dev.type == "meta" else torch.Generator(device=dev)
    return gen.manual_seed(seed)


def check_generator(generator: torch.Generator, device: torch.device) -> None:
    if device.type == "meta" and isinstance(generator, MetaGenerator):
        return  # nothing is drawn
    if generator.device.type != device.type:
        raise ValueError(f"generator is on {generator.device}, tensors go to {device}")
