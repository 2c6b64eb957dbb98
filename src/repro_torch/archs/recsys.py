"""RecSys cells: train_batch / serve_p99 / serve_bulk / retrieval_cand (port
of ``repro.archs.recsys``) for DLRM, DeepFM, SASRec and the two-tower
model.

train_batch is one AdamW step (lr 1e-3, as the reference's
``make_cell``) of the model's loss through ``make_train_step``.
serve_p99 and serve_bulk score rows: the two-tower model each user
against the item of its row, sum(user . item(item_id)); DLRM and DeepFM
sigmoid(logit) of each feature row; SASRec each sequence's last position
against its 100 candidate items. retrieval_cand is, for the two-tower
model, one user against 1M candidate item embeddings (the brute-force
top-k that AIRSHIP's constrained graph search replaces), for SASRec one
sequence against 1M candidate item ids and, for DLRM and DeepFM, bulk
scoring of ``n_candidates`` feature rows for one request.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional

import torch

from repro_torch.archs.base import Arch, CellSpec
from repro_torch.common.device import make_generator, resolve_device
from repro_torch.data.pipeline import (
    deepfm_batch,
    dlrm_batch,
    sasrec_batch,
    sasrec_serve_batch,
    two_tower_batch,
)
from repro_torch.distributed.meshinfo import MeshInfo
from repro_torch.models.recsys import models as rs
from repro_torch.models.recsys.models import RecsysConfig, TwoTower
from repro_torch.train.optimizer import adamw
from repro_torch.train.train_step import init_state, make_train_step

RECSYS_SHAPES: Dict[str, dict] = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
    "retrieval_cand": dict(kind="serve", batch=1, n_candidates=1_000_000),
}

_INIT = {"dlrm": rs.dlrm_init, "deepfm": rs.deepfm_init, "sasrec": rs.sasrec_init,
         "two_tower": rs.two_tower_init}
_LOSS = {"dlrm": rs.dlrm_loss, "deepfm": rs.deepfm_loss, "sasrec": rs.sasrec_loss,
         "two_tower": rs.two_tower_loss}
SASREC_CANDIDATES = 100  # candidates a sequence in serve_p99 / serve_bulk


def _check_model(cfg: RecsysConfig) -> None:
    if cfg.model not in _INIT:
        raise ValueError(f"{cfg.name}: no recsys model {cfg.model!r}")


def _shape(cfg: RecsysConfig, shape: str, shapes: Optional[Dict[str, dict]]) -> dict:
    _check_model(cfg)
    return (shapes or RECSYS_SHAPES)[shape]


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


@torch.inference_mode()
def serve_sasrec(model, batch: dict):
    """SASRec serving: (B, C) scores of each sequence's last position
    against its candidates."""
    return rs.sasrec_serve(model, batch)


@torch.inference_mode()
def serve_ranking(model, batch: dict):
    """DLRM / DeepFM serving: (B,) sigmoid of each feature row's logit."""
    return torch.sigmoid(model(batch))


def serve_fn(cfg: RecsysConfig, shape: str, shapes: Optional[Dict[str, dict]] = None,
             mesh: Optional[MeshInfo] = None) -> Callable[[torch.nn.Module, dict], object]:
    """The serve function of ``shape``: ``fn(model, batch)``; the two-tower
    retrieval_cand runs its two-phase top-k over ``mesh`` when one is
    given."""
    sh = _shape(cfg, shape, shapes)
    if sh["kind"] == "train":
        raise ValueError(f"{shape} is a train shape: RecsysArch.make_cell builds its step")
    if cfg.model == "sasrec":
        return serve_sasrec
    if cfg.model != "two_tower":
        return serve_ranking
    if sh.get("n_candidates"):
        return functools.partial(serve_retrieval, mesh=mesh)
    return serve_scores


def shape_batch(cfg: RecsysConfig, shape: str, seed: int = 0, step: int = 0, *,
                shapes: Optional[Dict[str, dict]] = None, candidates=None,
                device="cuda") -> dict:
    """The batch of ``shape`` from the model's generator at (seed, step) on
    ``device``: ``dlrm_batch`` / ``deepfm_batch`` (no label when serving;
    retrieval_cand scores ``n_candidates`` rows), ``sasrec_batch`` (serving:
    ``sasrec_serve_batch`` with ``n_candidates`` or 100 candidates a
    sequence) or ``two_tower_batch``, whose retrieval_cand takes
    ``candidates`` ((n_candidates, D) item-tower rows) in place of the item
    ids."""
    sh = _shape(cfg, shape, shapes)
    dev = resolve_device(device)
    n_cand = sh.get("n_candidates", 0)
    if cfg.model == "sasrec":
        if sh["kind"] == "train":
            return sasrec_batch(seed, step, sh["batch"], cfg.seq_len, cfg.item_vocab, device=dev)
        return sasrec_serve_batch(seed, step, sh["batch"], cfg.seq_len, cfg.item_vocab,
                                  n_cand or SASREC_CANDIDATES, device=dev)
    if cfg.model != "two_tower":
        b = n_cand or sh["batch"]
        if cfg.model == "dlrm":
            batch = dlrm_batch(seed, step, b, cfg.n_dense, cfg.vocab_sizes, device=dev)
        else:
            batch = deepfm_batch(seed, step, b, cfg.vocab_sizes, device=dev)
        if sh["kind"] == "serve":
            del batch["label"]
        return batch
    batch = two_tower_batch(seed, step, sh["batch"], cfg.user_vocab, cfg.item_vocab,
                            cfg.hist_len, device=dev)
    if n_cand:
        if candidates is None or candidates.shape[0] != n_cand:
            raise ValueError(f"{shape} takes ({n_cand}, D) candidates")
        del batch["item_id"]
        batch["candidates"] = candidates.to(dev)
    return batch


class RecsysArch(Arch):
    family = "recsys"

    def __init__(self, cfg: RecsysConfig, shapes: Optional[Dict[str, dict]] = None):
        self.name = cfg.name
        self.cfg = cfg
        self.shapes = shapes or RECSYS_SHAPES

    def shape_names(self):
        return list(self.shapes)

    def loss(self, model, batch, mi=None):
        """(loss, {"loss": loss}) of the model's objective, its tables read
        over ``mi``'s layout where given (``models.mesh_lookup``)."""
        return _LOSS[self.cfg.model](model, batch, mi)

    def make_cell(self, shape: str, mi: Optional[MeshInfo] = None) -> CellSpec:
        """train_batch: ``fn(model, opt_state, batch) -> (model, opt_state,
        metrics)``, one AdamW step (lr 1e-3) in place; over ``mi`` (a mesh of
        more than one position) the tables are resident as their blocks in
        the reference's layout, which ``specs`` gives (``models.param_specs``,
        ``models.make_resident``: from ``make_inputs`` on, or a whole model's
        first step), the batch split over the data groups. Serve shapes:
        ``fn(model, batch)`` (``serve_fn``). ``make_inputs(seed, device)``
        draws the model from ``seed`` and the batch of step 0 (retrieval_cand
        of the two-tower model: the item tower over items 0..C-1, modulo the
        vocab, as candidates)."""
        cfg = self.cfg
        sh = _shape(cfg, shape, self.shapes)
        name = f"{self.name}:{shape}"

        def model_of(seed, device):  # the reference's init laws, drawn from seed
            dev = resolve_device(device)
            gen = make_generator(dev, seed)
            return _INIT[cfg.model](gen, cfg, device=dev), dev

        if sh["kind"] == "train":
            opt = adamw(lr=1e-3)
            mesh = mi if mi is not None and len(mi.mesh.devices) > 1 else None

            def make_train_inputs(seed: int = 0, device="cuda"):
                model, dev = model_of(seed, device)
                rs.make_resident(model, mesh)
                batch = shape_batch(cfg, shape, seed, 0, shapes=self.shapes, device=dev)
                return model, init_state(opt, model), batch

            step = make_train_step(functools.partial(self.loss, mi=mesh), opt)

            def train_step(model, opt_state, batch, **kw):
                # a model built whole (a checkpoint's, the reference's) turns
                # resident at its first step over the mesh
                return step(rs.make_resident(model, mesh), opt_state, batch, **kw)

            return CellSpec(name=name, kind="train", fn=train_step if mesh else step,
                            make_inputs=make_train_inputs,
                            specs=None if mesh is None else rs.param_specs(cfg, mesh))

        def make_serve_inputs(seed: int = 0, device="cuda"):
            model, dev = model_of(seed, device)
            cand = None
            if cfg.model == "two_tower" and sh.get("n_candidates"):
                ids = torch.arange(sh["n_candidates"], device=dev) % cfg.item_vocab
                with torch.inference_mode():
                    cand = model.item(ids.to(torch.int32))
            return model, shape_batch(cfg, shape, seed, 0, shapes=self.shapes,
                                      candidates=cand, device=dev)

        return CellSpec(name=name, kind="serve", fn=serve_fn(cfg, shape, self.shapes, mi),
                        make_inputs=make_serve_inputs)
