"""Deterministic synthetic batches (port of ``repro.data.pipeline``; the
two-tower generator so far).

Every batch is a pure function of (seed, step), drawn with numpy exactly
as the reference draws it, so the port's batches equal the reference's
bit for bit; only the last step moves them to ``device``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.common.device import resolve_device


def _rng(seed: int, step: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step]))


def _tensor(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)


def two_tower_batch(seed: int, step: int, batch: int, user_vocab: int, item_vocab: int,
                    hist: int, device="cuda") -> dict:
    """{"user_id": (batch,), "hist": (batch, hist), "item_id": (batch,)}
    int32 on ``device``; about 30% of the history slots are -1 (ragged
    histories as padding)."""
    dev = resolve_device(device)
    r = _rng(seed, step)
    h = r.integers(0, item_vocab, size=(batch, hist)).astype(np.int32)
    h[r.random(size=h.shape) < 0.3] = -1
    return {
        "user_id": _tensor(r.integers(0, user_vocab, size=batch), dev),
        "hist": _tensor(h, dev),
        "item_id": _tensor(r.integers(0, item_vocab, size=batch), dev),
    }
