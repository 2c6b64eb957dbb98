"""Carry the reference's state across: numpy arrays in, the port's objects out.

Tests build worlds with the JAX package, call ``np.asarray`` on its arrays
and hand them here. uint32 words (tombstones, label words) are
reinterpreted as int32 with ``.view(np.int32)``: the same bits, no change
of value. Nothing of the JAX package is imported.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.core.constraints import LabelSetConstraint, RangeConstraint
from repro_torch.core.pq import PQIndex
from repro_torch.core.types import Corpus, GraphIndex
from repro_torch.models.recsys.models import RecsysConfig, TwoTower
from repro_torch.streaming.slots import SlotPool, StreamingIndex


def _tensor(a: np.ndarray, dtype, dev: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if dtype == np.int32 and a.dtype == np.uint32:
        a = a.view(np.int32)
    # np.array copies: the tensor owns writable, contiguous memory.
    return torch.from_numpy(np.array(a, dtype=dtype)).to(dev)


def from_reference_arrays(
    *,
    vectors: np.ndarray,
    labels: np.ndarray,
    neighbors: np.ndarray,
    sample_ids: np.ndarray,
    entry_point: np.ndarray,
    attrs: Optional[np.ndarray] = None,
    tombstones: Optional[np.ndarray] = None,
    label_words: Optional[np.ndarray] = None,
    lo: Optional[np.ndarray] = None,
    hi: Optional[np.ndarray] = None,
    col: int = 0,
    device="cuda",
):
    """-> (Corpus, GraphIndex, constraint) on ``device``.

    The constraint is a ``LabelSetConstraint`` when ``label_words`` is
    given, a ``RangeConstraint`` over column ``col`` when ``lo``/``hi`` are,
    else None (a UDF has no arrays to carry).
    """
    dev = resolve_device(device)
    corpus = Corpus(
        vectors=_tensor(vectors, np.float32, dev),
        labels=_tensor(labels, np.int32, dev),
        attrs=None if attrs is None else _tensor(attrs, np.float32, dev),
        tombstones=None if tombstones is None else _tensor(tombstones, np.int32, dev),
    )
    graph = GraphIndex(
        neighbors=_tensor(neighbors, np.int32, dev),
        sample_ids=_tensor(sample_ids, np.int32, dev),
        entry_point=_tensor(np.asarray(entry_point).reshape(()), np.int32, dev),
    )
    constraint = None
    if label_words is not None:
        constraint = LabelSetConstraint(words=_tensor(label_words, np.int32, dev))
    elif lo is not None and hi is not None:
        constraint = RangeConstraint(lo=_tensor(lo, np.float32, dev),
                                     hi=_tensor(hi, np.float32, dev), col=int(col))
    return corpus, graph, constraint


def pq_index_from_reference(*, codebooks: np.ndarray, codes: np.ndarray, device="cuda") -> PQIndex:
    """The reference's ``PQIndex`` arrays ((m_sub, n_cent, d_sub) float32
    codebooks, (n, m_sub) int32 codes) -> the port's ``PQIndex`` on
    ``device``."""
    dev = resolve_device(device)
    return PQIndex(codebooks=_tensor(codebooks, np.float32, dev),
                   codes=_tensor(codes, np.int32, dev))


def streaming_index_from_reference(
    *,
    vectors: np.ndarray,
    labels: np.ndarray,
    attrs: Optional[np.ndarray],
    tombstones: np.ndarray,
    neighbors: np.ndarray,
    sample_ids: np.ndarray,
    entry_point: int,
    free,
    pending,
    n_live: int,
    epoch: int,
    ef_insert: int,
    consolidations: int,
    rng_state,
    dirty: bool = True,
    device="cuda",
) -> StreamingIndex:
    """A reference ``StreamingIndex`` part-way through its life -> the port's,
    on ``device``, so that the same later mutations give the same state.

    Arrays are the reference pool's (capacity-sized) vectors, labels, attrs
    (or None) and uint32 tombstone words (int32 views are accepted), its
    (capacity, degree) neighbors and sample; ``free`` / ``pending`` are its
    slot lists in order, ``rng_state`` its ``RandomState.get_state()``,
    ``dirty`` its ``_dirty`` flag: where False, the reference has published
    ``epoch`` for this state and the port's first ``snapshot()`` publishes
    the same epoch number.
    The histograms and postings are rebuilt from the live set: the label
    counts and postings equal the reference's, and the range histograms'
    bin edges come from the live attributes' extent.
    """
    pool = SlotPool(vectors, labels, attrs, np.asarray(vectors).shape[0], device=device)
    pool.tombstones = np.array(np.asarray(tombstones).view(np.uint32))
    pool.free = [int(s) for s in free]
    pool.pending = [int(s) for s in pending]
    pool.n_live = int(n_live)
    pool.check_accounting()
    index = StreamingIndex(pool, torch.from_numpy(np.asarray(neighbors, np.int32)), sample_ids,
                           int(entry_point), ef_insert=ef_insert)
    index.rng.set_state(rng_state)
    index.epoch = int(epoch) if dirty else int(epoch) - 1
    index.consolidations = int(consolidations)
    return index


def two_tower_params_from_reference(params, cfg: RecsysConfig, *, device="cuda") -> TwoTower:
    """The reference's two-tower param tree as numpy arrays (``user_emb``,
    ``item_emb``, ``user_tower`` / ``item_tower`` {"layers": [{"w", "b"}]},
    ``log_tau``) -> a ``TwoTower`` for ``cfg`` on ``device``. The
    reference's ``w`` is (in, out); ``nn.Linear.weight`` takes ``w.T``."""
    dev = resolve_device(device)
    model = TwoTower(cfg, device=dev)
    with torch.no_grad():
        for name in ("user_emb", "item_emb", "log_tau"):
            want = getattr(model, name)
            got = _tensor(params[name], np.float32, dev)
            if got.shape != want.shape:
                raise ValueError(f"{name}: shape {tuple(got.shape)}, {cfg.name} has "
                                 f"{tuple(want.shape)}")
            want.copy_(got)
        for name in ("user_tower", "item_tower"):
            layers = getattr(model, name).layers
            ref = params[name]["layers"]
            if len(ref) != len(layers):
                raise ValueError(f"{name}: {len(ref)} layers, {cfg.name} has {len(layers)}")
            for layer, p in zip(layers, ref):
                w = _tensor(np.asarray(p["w"]).T, np.float32, dev)
                if w.shape != layer.weight.shape:
                    raise ValueError(f"{name}: weight (in, out) {tuple(w.T.shape)}, "
                                     f"{cfg.name} has {tuple(layer.weight.T.shape)}")
                layer.weight.copy_(w)
                layer.bias.copy_(_tensor(p["b"], np.float32, dev))
    return model
