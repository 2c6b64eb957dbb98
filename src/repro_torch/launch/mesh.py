"""Mesh construction (port of ``repro.launch.mesh``).

Functions, not module-level constants, so importing this module touches
no device state. Single pod: (16, 16) = 256 devices ("data", "model");
multi-pod: (2, 16, 16) = 512 devices ("pod", "data", "model"). The
production shapes take one CUDA device each and raise, naming the count,
where the machine has fewer, or repeat one named device (the dry run);
``make_test_mesh`` may repeat one device (a (1, 4) mesh of four shards on
one card).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.common.device import resolve_device
from repro_torch.distributed.meshinfo import DeviceMesh, MeshInfo


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> DeviceMesh:
    """The production mesh. ``device="cuda"`` takes one CUDA device a
    position and raises where the machine has fewer; any other device
    (``"meta"``, ``"cpu"``, ``"cuda:0"``) fills every position, as the dry
    run's one controller does."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 1
    for s in shape:
        need *= s
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return DeviceMesh.create([dev] * need, shape, axes)
    have = torch.cuda.device_count()
    if have < need:
        raise RuntimeError(f"the {'x'.join(map(str, shape))} production mesh needs {need} CUDA "
                           f"devices; this machine has {have}")
    return DeviceMesh.create([torch.device("cuda", i) for i in range(need)], shape, axes)


def make_production_meshinfo(*, multi_pod: bool = False, device="cuda") -> MeshInfo:
    return MeshInfo(mesh=make_production_mesh(multi_pod=multi_pod, device=device))


def make_test_mesh(n_devices: Optional[int] = None, model: int = 1,
                   device="cuda") -> DeviceMesh:
    """A (n_devices // model, model) mesh for tests and the launcher.

    ``device="cuda"`` spreads the grid over the CUDA devices there are,
    repeating them round-robin when the grid has more positions (one card
    holds every shard of a (1, 4) mesh); ``n_devices`` defaults to the
    device count. Any other device (``"cpu"``, ``"cuda:0"``) fills every
    position with that one device, and ``n_devices`` defaults to 1.
    """
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        pool = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        pool = [dev]
    n = n_devices or len(pool)
    if n % model:
        raise ValueError(f"{n} devices do not split into model groups of {model}")
    data = n // model
    return DeviceMesh.create([pool[i % len(pool)] for i in range(data * model)],
                             (data, model), ("data", "model"))
