"""Deterministic synthetic batches (port of ``repro.data.pipeline``: the LM,
DLRM, DeepFM, SASRec and two-tower generators; the GNN one is ROADMAP
item 14d).

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


def _tensor(a: np.ndarray, dev: torch.device, dtype=np.int32) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(dev)


def _sparse(r: np.random.Generator, batch: int, vocabs) -> np.ndarray:
    return np.stack([r.integers(0, v, size=batch) for v in vocabs], axis=1)


def lm_batch(seed: int, step: int, batch: int, seq: int, vocab: int, device="cuda") -> dict:
    """{"tokens": (batch, seq) int32} on ``device``: a zipf(1.3) marginal
    over the vocab, clamped at vocab - 1."""
    dev = resolve_device(device)
    z = _rng(seed, step).zipf(1.3, size=(batch, seq)).astype(np.int64)
    return {"tokens": _tensor(np.minimum(z, vocab - 1), dev)}


def dlrm_batch(seed: int, step: int, batch: int, n_dense: int, vocabs, device="cuda") -> dict:
    """{"dense": (batch, n_dense) float32 normal, "sparse": (batch, F) int32
    uniform in each field's vocab, "label": (batch,) float32 0 / 1} on
    ``device``."""
    dev = resolve_device(device)
    r = _rng(seed, step)
    sparse = _sparse(r, batch, vocabs)
    return {
        "dense": _tensor(r.normal(size=(batch, n_dense)), dev, np.float32),
        "sparse": _tensor(sparse, dev),
        "label": _tensor(r.integers(0, 2, size=batch), dev, np.float32),
    }


def deepfm_batch(seed: int, step: int, batch: int, vocabs, device="cuda") -> dict:
    """{"sparse": (batch, F) int32, "label": (batch,) float32 0 / 1} on
    ``device``."""
    dev = resolve_device(device)
    r = _rng(seed, step)
    sparse = _sparse(r, batch, vocabs)
    return {
        "sparse": _tensor(sparse, dev),
        "label": _tensor(r.integers(0, 2, size=batch), dev, np.float32),
    }


def sasrec_batch(seed: int, step: int, batch: int, seq: int, vocab: int, device="cuda") -> dict:
    """{"seq", "pos", "neg"}: (batch, seq) int32 item ids in [1, vocab) on
    ``device``; ``pos`` is ``seq`` shifted by one (the next item), ``neg``
    drawn on its own."""
    dev = resolve_device(device)
    r = _rng(seed, step)
    seqs = r.integers(1, vocab, size=(batch, seq + 1)).astype(np.int32)
    return {
        "seq": _tensor(seqs[:, :-1], dev),
        "pos": _tensor(seqs[:, 1:], dev),
        "neg": _tensor(r.integers(1, vocab, size=(batch, seq)), dev),
    }


def sasrec_serve_batch(seed: int, step: int, batch: int, seq: int, vocab: int,
                       n_candidates: int, device="cuda") -> dict:
    """{"seq": (batch, seq), "candidates": (batch, n_candidates)} int32 item
    ids in [1, vocab) on ``device``: ``seq`` is ``sasrec_batch``'s at the
    same (seed, step), the candidates are drawn after it. The reference
    gives the serve cells' inputs as shapes only; this is the port's draw."""
    dev = resolve_device(device)
    r = _rng(seed, step)
    seqs = r.integers(1, vocab, size=(batch, seq + 1)).astype(np.int32)
    return {
        "seq": _tensor(seqs[:, :-1], dev),
        "candidates": _tensor(r.integers(1, vocab, size=(batch, n_candidates)), dev),
    }


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
