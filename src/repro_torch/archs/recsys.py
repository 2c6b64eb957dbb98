"""RecSys serve shapes: serve_p99 / serve_bulk / retrieval_cand (port of
``repro.archs.recsys``, the two-tower model's serve branches of
``RecsysArch.make_cell``).

serve_p99 and serve_bulk score each user against the item of its row,
sum(user . item(item_id)); retrieval_cand (one user against 1M candidate
item embeddings) is the brute-force top-k that AIRSHIP's constrained graph
search replaces. Training (train_batch) and the dlrm / deepfm / sasrec
models are not ported yet (ROADMAP item 14).
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional

import torch

from repro_torch.common.device import resolve_device
from repro_torch.data.pipeline import two_tower_batch
from repro_torch.distributed.meshinfo import MeshInfo
from repro_torch.models.recsys.models import RecsysConfig, TwoTower

RECSYS_SHAPES: Dict[str, dict] = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
    "retrieval_cand": dict(kind="serve", batch=1, n_candidates=1_000_000),
}


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP item 14)")


def train_batch(*args, **kwargs):
    """The recsys training step: not ported yet (ROADMAP item 14)."""
    _not_ported("the recsys training step")


def _serve_shape(cfg: RecsysConfig, shape: str, shapes: Optional[Dict[str, dict]]) -> dict:
    sh = (shapes or RECSYS_SHAPES)[shape]
    if sh["kind"] == "train":
        train_batch()
    if cfg.model != "two_tower":
        _not_ported(f"{cfg.model} serving")
    return sh


@torch.inference_mode()
def serve_scores(model: TwoTower, batch: dict):
    """serve_p99 / serve_bulk: (B,) float32 sum(user . item(item_id))."""
    u = model.user(batch)
    v = model.item(batch["item_id"])
    return (u * v).sum(-1)


@torch.inference_mode()
def serve_retrieval(model: TwoTower, batch: dict, mesh: Optional[MeshInfo] = None):
    """retrieval_cand: (values, int32 ids) of the top min(100, C) candidates;
    with a ``mesh``, the two-phase top-k over its model axis."""
    return model.score_candidates(batch, mesh, two_phase_topk=True)


def serve_fn(cfg: RecsysConfig, shape: str, shapes: Optional[Dict[str, dict]] = None,
             mesh: Optional[MeshInfo] = None) -> Callable[[TwoTower, dict], object]:
    """The serve function of ``shape``: ``fn(model, batch)``; retrieval_cand
    runs its two-phase top-k over ``mesh`` when one is given."""
    sh = _serve_shape(cfg, shape, shapes)
    if sh.get("n_candidates"):
        return functools.partial(serve_retrieval, mesh=mesh)
    return serve_scores


def shape_batch(cfg: RecsysConfig, shape: str, seed: int = 0, step: int = 0, *,
                shapes: Optional[Dict[str, dict]] = None, candidates=None,
                device="cuda") -> dict:
    """The batch of ``shape`` from ``two_tower_batch(seed, step)`` on
    ``device``; retrieval_cand takes ``candidates`` ((n_candidates, D)
    item-tower rows) in place of the item ids."""
    sh = _serve_shape(cfg, shape, shapes)
    dev = resolve_device(device)
    batch = two_tower_batch(seed, step, sh["batch"], cfg.user_vocab, cfg.item_vocab,
                            cfg.hist_len, device=dev)
    n_cand = sh.get("n_candidates", 0)
    if n_cand:
        if candidates is None or candidates.shape[0] != n_cand:
            raise ValueError(f"{shape} takes ({n_cand}, D) candidates")
        del batch["item_id"]
        batch["candidates"] = candidates.to(dev)
    return batch
