"""Carry the reference's state across: numpy arrays in, the port's objects out.

Tests build worlds with the JAX package, call ``np.asarray`` on its arrays
and hand them here. uint32 words (tombstones, label words) are
reinterpreted as int32 with ``.view(np.int32)``: the same bits, no change
of value. A bf16 array (``np.asarray`` of a JAX bf16 array, whose dtype
is named "bfloat16") crosses as its uint16 bits viewed as
``torch.bfloat16``. The reference stacks a model's layers on a leading
axis (SASRec's ``blocks``, the LM's ``dense_layers`` and ``moe_layers``); where the port
holds them as an ``nn.ModuleList`` they are unstacked in order, or, where
the list's parameters are rows of stacked tensors (the LM's), copied into
those whole. Nothing of the JAX package is imported.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from repro_torch.common.device import resolve_device
from repro_torch.core.constraints import LabelSetConstraint, RangeConstraint
from repro_torch.core.pq import PQIndex
from repro_torch.core.types import Corpus, GraphIndex
from repro_torch.models.common.modules import StackedLayers
from repro_torch.models.gnn.mace import MACE, MACEConfig
from repro_torch.models.recsys.models import DLRM, DeepFM, RecsysConfig, SASRec, TwoTower
from repro_torch.models.transformer.model import Transformer, TransformerConfig
from repro_torch.streaming.slots import SlotPool, StreamingIndex
from repro_torch.train.train_step import reference_layout


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


def _param_tensor(a, dev: torch.device) -> torch.Tensor:
    """A leaf as a tensor of its own dtype: bf16 through its uint16 bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a.view(np.uint16))).view(torch.bfloat16).to(dev)
    return _tensor(a, np.float32, dev)


def _unstacked(tree, model: nn.Module):
    """``tree`` with each top-level entry that ``model`` holds as an
    ``nn.ModuleList`` split along its leading (layer) axis into a list,
    except a ``StackedLayers``, whose parameters are stacked as the
    reference's."""
    def take(t, i):
        return {k: take(v, i) for k, v in t.items()} if isinstance(t, dict) else t[i]

    out = dict(tree)
    for k, v in tree.items():
        layers = getattr(model, k, None)
        if (isinstance(layers, nn.ModuleList) and isinstance(v, dict)
                and not isinstance(layers, StackedLayers)):
            out[k] = [take(v, i) for i in range(len(layers))]
    return out


def _leaves(tree, path=()):
    """(path, array) of every leaf of a nested dict / list param tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _port_name(path) -> str:
    """The port's parameter name of a reference tree path (the inverse of
    ``train.reference_key``): ("bot", "layers", 0, "w") ->
    ``bot.layers.0.weight``; a layer's "b" -> ``bias``."""
    parts = [str(p) for p in path]
    if parts[-1] == "w":
        parts[-1] = "weight"
    elif parts[-1] == "b" and len(path) > 1 and isinstance(path[-2], int):
        parts[-1] = "bias"
    return ".".join(parts)


def _by_port_name(tree, name: str) -> dict:
    """The leaves of a reference tree keyed by the port's names."""
    out = {_port_name(path): np.asarray(a) for path, a in _leaves(tree)}
    if not out:
        raise ValueError(f"{name}: an empty tree")
    return out


_MODELS = {"dlrm": DLRM, "deepfm": DeepFM, "sasrec": SASRec, "two_tower": TwoTower}


def _load(model: nn.Module, params, name: str, dev: torch.device) -> nn.Module:
    """Copy each leaf of the reference's tree into ``model``'s parameter view
    in the reference's layout (``train.reference_layout``), so the
    reference's (in, out) ``w`` lands in a (out, in) ``weight`` as ``w.T``.
    Every parameter must be given, with its shape and dtype."""
    views = reference_layout(model)
    leaves = _by_port_name(_unstacked(params, model), name)
    if set(leaves) != set(views):
        raise ValueError(f"{name}: the reference's leaves {sorted(set(leaves) - set(views))} "
                         f"have no parameter, the parameters {sorted(set(views) - set(leaves))} "
                         f"no leaf")
    with torch.no_grad():
        for k, view in views.items():
            got = _param_tensor(leaves[k], dev)
            if got.shape != view.shape or got.dtype != view.dtype:
                raise ValueError(f"{k}: {got.dtype} {tuple(got.shape)} (the reference's layout), "
                                 f"{name} has {view.dtype} {tuple(view.shape)}")
            view.copy_(got)
    return model


def recsys_params_from_reference(params, cfg: RecsysConfig, *, device="cuda"):
    """The reference's recsys param tree as numpy arrays (``dlrm_init``,
    ``deepfm_init``, ``sasrec_init`` or ``two_tower_init``'s) -> the port's
    ``DLRM``, ``DeepFM``, ``SASRec`` or ``TwoTower`` for ``cfg`` on
    ``device``."""
    if cfg.model not in _MODELS:
        raise ValueError(f"{cfg.name}: no port of a {cfg.model} model")
    dev = resolve_device(device)
    return _load(_MODELS[cfg.model](cfg, device=dev), params, cfg.name, dev)


def sasrec_params_from_reference(params, cfg: RecsysConfig, *, device="cuda") -> SASRec:
    """The reference's SASRec param tree as numpy arrays (``items``, ``pos``,
    ``blocks`` stacked on a leading axis, ``final_ln``) -> a trainable
    ``SASRec`` for ``cfg`` on ``device``, one block a stacked entry."""
    if cfg.model != "sasrec":
        raise ValueError(f"{cfg.name} is a {cfg.model} config, not sasrec")
    return recsys_params_from_reference(params, cfg, device=device)


def lm_params_from_reference(params, cfg: TransformerConfig, *, device="cuda") -> Transformer:
    """The reference's transformer param tree as numpy arrays
    (``init_params``': ``embed``, ``final_norm``, ``lm_head``, the stacked
    ``dense_layers`` and ``moe_layers``, and ``mtp``; bf16 leaves as
    ml_dtypes bfloat16 arrays) -> the port's ``Transformer`` for ``cfg`` on
    ``device``, layer l of each stack in ``dense_layers[l]`` /
    ``moe_layers[l]``. The experts' (E, D, Fe) / (E, Fe, D) stacks load as
    they are, the float32 router as every ``w``, transposed."""
    dev = resolve_device(device)
    return _load(Transformer(cfg, device=dev), params, cfg.name, dev)


def mace_params_from_reference(params, cfg: MACEConfig, *, device="cuda") -> MACE:
    """The reference's MACE param tree as numpy arrays (``init_params``':
    ``embed``, ``readout`` {"layers": [{"w", "b"}]}, and ``layers`` stacked
    on a leading axis) -> the port's ``MACE`` for ``cfg`` on ``device``."""
    dev = resolve_device(device)
    return _load(MACE(cfg, device=dev), params, cfg.name, dev)


def two_tower_params_from_reference(params, cfg: RecsysConfig, *, device="cuda") -> TwoTower:
    """The reference's two-tower param tree as numpy arrays (``user_emb``,
    ``item_emb``, ``user_tower`` / ``item_tower`` {"layers": [{"w", "b"}]},
    ``log_tau``) -> a trainable ``TwoTower`` for ``cfg`` on ``device``
    (``recsys_params_from_reference``)."""
    if cfg.model != "two_tower":
        raise ValueError(f"{cfg.name} is a {cfg.model} config, not two_tower")
    return recsys_params_from_reference(params, cfg, device=device)


def adamw_state_from_reference(state, model, *, device="cuda") -> dict:
    """The reference's AdamW state ({"m": tree, "v": tree, "count": int})
    as numpy arrays -> the port's, keyed by ``model``'s parameter names in
    the reference's layout (``train.optimizer.adamw``; stacked layers split
    as the parameters are), on ``device``: a step can start from the
    reference's state mid-run."""
    dev = resolve_device(device)
    views = reference_layout(model)
    out = {"count": torch.tensor(int(np.asarray(state["count"])), dtype=torch.int32, device=dev)}
    for key in ("m", "v"):
        leaves = _by_port_name(_unstacked(state[key], model), key)
        if set(leaves) != set(views):
            raise ValueError(f"state {key}: leaves {sorted(leaves)} differ from the model's "
                             f"parameters {sorted(views)}")
        out[key] = {}
        for k, view in views.items():
            t = _tensor(leaves[k], np.float32, dev)
            if t.shape != view.shape:
                raise ValueError(f"state {key}[{k}]: shape {tuple(t.shape)}, the parameter's "
                                 f"{tuple(view.shape)}")
            out[key][k] = t
    return out
