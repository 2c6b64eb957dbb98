"""Fault-tolerant checkpoints: atomic, manifest-driven, elastic (port of
``repro.ckpt.checkpoint``).

Layout, the reference's exactly::

    <dir>/step_<N:08d>/
        manifest.json   {"step": N, "leaves": [{"key", "file", "shape", "dtype"}]}
        leaf_<i:05d>.npy

A tree is nested dicts of tensors: the train state is ``{"params":
param_leaves(model), "opt": opt_state}``, where a resident table and its
moments are ``Blocks``: ``save`` writes such a leaf whole (``Blocks.whole``,
``layout.gather``) and ``restore`` places it back as blocks of its
``like`` leaf's layout, so the files are the reference's layout whatever
the mesh. Each leaf's key is its
reference keypath joined by "/": a dict key that is a port parameter name
expands through ``train.reference_key`` (``bot.layers.0.weight`` ->
``bot/layers/0/w``, a ``StackedLayers`` leaf ``dense_layers.attn.wq.weight``
-> ``dense_layers/attn/wq/w``, one stacked leaf), so the port's state and
the reference's ``{"params": params, "opt": opt_state}`` write the same
keys, shapes and dtypes, and leaves are numbered in ``jax.tree.leaves``
order. A checkpoint written by either package restores into the other.
SASRec's blocks are the exception: the port holds them as a module list,
so its keys are ``blocks/<i>/...`` where the reference stacks them.

bf16 has no numpy dtype where ``ml_dtypes`` is missing: a bf16 leaf is
written as its 2-byte words under the header the reference's ``ml_dtypes``
arrays get (``'<V2'``), and read back through ``torch.int16`` as
``torch.bfloat16``; the manifest names the dtype, as the reference's does.

Writes go to ``step_<N>.tmp`` and are published by ``os.rename``, so a
checkpoint directory is complete or absent: a writer killed mid-write
leaves a ``.tmp`` that ``latest_step`` ignores and the next ``save`` of
that step clears. ``restore`` puts the leaves on the device the caller
names, or, given a layout (a mesh and a spec for each leaf), as each mesh
position's block: the elastic restart onto another mesh.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.distributed.layout import Blocks, place
from repro_torch.train.train_step import reference_key

BF16_DESCR = "<V2"  # the .npy header of an ml_dtypes bfloat16 array


def _paths(tree, path=()):
    """(reference keypath, leaf) of every leaf of a nested dict tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, path + reference_key(str(k)))
    else:
        yield path, tree


def leaf_key(path) -> str:
    return "/".join(str(p) for p in path)


def _flat(tree) -> list:
    """(key, leaf) in ``jax.tree.leaves`` order: dict keys sorted, list
    indices in order (siblings are all names or all indices)."""
    return [(leaf_key(p), leaf) for p, leaf in sorted(_paths(tree), key=lambda pl: pl[0])]


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).rpartition(".")[2]


def _write(path: str, t: torch.Tensor) -> None:
    t = t.detach().to("cpu").contiguous()
    if t.dtype == torch.bfloat16:
        words = t.view(torch.int16).numpy()
        with open(path, "wb") as f:
            np.lib.format.write_array_header_1_0(
                f, {"descr": BF16_DESCR, "fortran_order": False, "shape": tuple(t.shape)})
            f.write(words.tobytes())
    else:
        np.save(path, t.numpy())


def _read(path: str, dtype_name: str) -> torch.Tensor:
    arr = np.load(path)  # C order: written so by either package
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save(ckpt_dir: str, step: int, tree: Any) -> str:
    """Atomically write ``tree`` as ``step``; returns the final directory."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": []}
    for i, (key, leaf) in enumerate(_flat(tree)):
        t = leaf.whole() if isinstance(leaf, Blocks) else torch.as_tensor(leaf)
        fname = f"leaf_{i:05d}.npy"
        _write(os.path.join(tmp, fname), t)
        manifest["leaves"].append({"key": key, "file": fname, "shape": list(t.shape),
                                   "dtype": _dtype_name(t.dtype)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    return final


def _steps(ckpt_dir: str) -> list:
    if not os.path.isdir(ckpt_dir):
        return []
    return [d for d in os.listdir(ckpt_dir) if d.startswith("step_") and not d.endswith(".tmp")]


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = [int(d.split("_")[1]) for d in _steps(ckpt_dir)]
    return max(steps) if steps else None


def _specs_of(layout, path) -> tuple:
    """The spec of the leaf at ``path`` in a layout's spec tree (nested
    dicts keyed as the state, a leaf's spec a tuple); () where none is
    given (replicated)."""
    node = layout
    for k in path:
        if not isinstance(node, dict) or k not in node:
            return ()
        node = node[k]
    return tuple(node)


def restore(ckpt_dir: str, step: int, like: Any, device=None, layout=None) -> Any:
    """The checkpoint ``step`` in the structure of ``like`` (nested dicts of
    tensors, their shapes and dtypes), each leaf cast to its ``like``
    leaf's dtype as the reference casts.

    Leaves land on ``device``, or on their ``like`` leaf's device. With
    ``layout=(mesh, specs)`` (a ``DeviceMesh`` or ``MeshInfo``, and specs
    nested as ``like``, a leaf's a tuple, a leaf without one replicated),
    each leaf is instead the list of its blocks, one a mesh position in the
    mesh's order on that position's device (``distributed.layout.place``).
    """
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        by_key = {leaf["key"]: leaf for leaf in json.load(f)["leaves"]}

    def load(path, leaf):
        key = leaf_key(sum((reference_key(str(k)) for k in path), ()))
        rec = by_key[key]
        t = _read(os.path.join(d, rec["file"]), rec["dtype"])
        if list(t.shape) != list(leaf.shape):
            raise ValueError(f"shape mismatch for {key}: {tuple(t.shape)} vs {tuple(leaf.shape)}")
        dev = torch.device(device) if device is not None else leaf.device
        t = t.to(device=dev, dtype=leaf.dtype)
        if isinstance(leaf, Blocks):  # a resident leaf: placed as its blocks
            return Blocks.place(t, leaf.layout.spec, leaf.layout.mesh)
        if layout is None:
            return t
        mesh, specs = layout
        return place(t, _specs_of(specs, path), mesh)

    def build(tree, path=()):
        if isinstance(tree, dict):
            return {k: build(v, path + (k,)) for k, v in tree.items()}
        return load(path, tree)

    return build(like)


def prune_old(ckpt_dir: str, keep: int = 3) -> None:
    """Keep the newest ``keep`` checkpoints (bounded disk under failure
    loops)."""
    for name in sorted(_steps(ckpt_dir))[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, name))
