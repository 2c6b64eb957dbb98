"""Hand-written CUDA kernels for Hopper, their plain PyTorch versions, and
the build that turns ``repro_torch/csrc/*.cu`` into shared libraries.

Dispatch (``dispatch``) is the reference's platform rule
(``repro/kernels/__init__.py::dispatch_kernel``) with the platforms
swapped: tensors on a CUDA device launch the kernel, or the call raises;
tensors on the CPU take the plain version. Nothing falls back.

Build: each ``csrc/<stem>.cu`` compiles on first use with ``nvcc`` into a
shared library with a plain C interface (``build/repro_torch/`` at the
repository root, keyed by a hash of the sources and flags), loaded with
``ctypes``. ``build_all`` starts one ``nvcc`` per source at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
KERNEL_STEMS = ("gather_distance", "fused_expand", "fused_expand_adc", "pq_adc", "l2_matmul",
                "embedding_bag", "embedding_bag_backward")

_LIBS: Dict[str, ctypes.CDLL] = {}
# Last ptxas report (registers, spills) per stem, for the smoke's log.
BUILD_LOGS: Dict[str, str] = {}


def dispatch(device: torch.device, kernel_fn: Callable, plain_fn: Callable) -> Callable:
    """The kernel for CUDA tensors, the plain version for CPU tensors and for
    meta tensors (the dry run's shapes: nothing runs)."""
    if device.type == "cuda":
        return kernel_fn
    if device.type in ("cpu", "meta"):
        return plain_fn
    raise RuntimeError(f"no kernel or plain version for device {device}")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the toolkit is")
    return str(path)


def _library_path(stem: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{stem}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{stem}-{h.hexdigest()[:16]}.so"


def build_all(stems: Iterable[str] = KERNEL_STEMS) -> Dict[str, Path]:
    """Compile every missing library, one ``nvcc`` per source, all at once.

    Each output is written under a temporary name and renamed into place,
    so concurrent builders never load a half-written library.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {stem: _library_path(stem) for stem in stems}
    procs = {}
    for stem, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{stem}.cu")]
        procs[stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp)
    failures = []
    for stem, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOGS[stem] = out
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {stem}.cu:\n{out}")
            continue
        os.replace(tmp, paths[stem])
    if failures:
        raise RuntimeError("\n".join(failures))
    return paths


def kernel_entry(stem: str, name: str, argtypes) -> Callable[..., int]:
    """The C entry ``name`` of ``csrc/<stem>.cu``, typed (every pointer and
    the stream as ``c_void_p``) and returning its ``cudaGetLastError()``;
    the library is built and loaded on first use."""
    lib = _LIBS.get(stem)
    if lib is None:
        lib = ctypes.CDLL(str(build_all([stem])[stem]))
        _LIBS[stem] = lib
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return fn


def launch(name: str, device: torch.device, fn: Callable, *args) -> None:
    """``fn(*args, stream)``, a C entry point, on ``device``'s current stream
    with ``device`` the current device (a kernel launched into another
    device's stream fails; a mesh puts its positions on several cards:
    only then is the current device switched, as a switch costs the host
    time on every launch of a walk); raises if it reported a CUDA error
    (``cudaGetLastError``)."""
    stream = torch.cuda.current_stream(device).cuda_stream
    if device.index is None or device.index == torch.cuda.current_device():
        status = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            status = fn(*args, stream)
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status} at launch")


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


__all__ = [
    "BUILD_DIR",
    "BUILD_LOGS",
    "CSRC",
    "KERNEL_STEMS",
    "build_all",
    "dispatch",
    "kernel_entry",
    "launch",
    "require",
]
