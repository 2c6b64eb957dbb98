"""The two-tower retrieval model's serving path (port of
``repro.models.recsys.models``: ``RecsysConfig``, ``embedding_bag_sum``
and the two-tower functions).

The user tower reads the user's row and the bag of the user's item
history, the item tower the item's row; both end in a ReLU MLP and an L2
normalisation, so a dot product of their outputs is a cosine and
inner-product order equals L2 order (what lets an L2 proximity graph
serve this MIPS). The history bag is the ``embedding_bag`` kernel
(``kernels/embedding_bag.py``), the TPU package's hot path of this lookup.
The tower products and ``u @ cand.T`` are plain float32 products
(``nn.Linear``, ``torch.matmul``), as the reference leaves them to XLA:
they must run with TF32 off on the card.

Serving only: the model's tensors do not require gradients, and the
reference's ``mi`` (mesh) argument is gone (on one device its constraints
do nothing). DLRM, DeepFM, SASRec and the training loss are not ported
(ROADMAP item 14).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch
from torch import nn

from repro_torch.common.device import check_generator, resolve_device
from repro_torch.kernels.embedding_bag import embedding_bag
from repro_torch.models.common.modules import MLP

VOCAB_PAD = 256  # tables are padded to a multiple of this many rows
FILL_CHUNK_ELEMS = 1 << 28  # elements of one normal_ call when filling a table


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    model: str  # dlrm | deepfm | sasrec | two_tower
    embed_dim: int
    # categorical fields
    vocab_sizes: Tuple[int, ...] = ()
    n_dense: int = 0
    # mlps
    bot_mlp: Tuple[int, ...] = ()
    top_mlp: Tuple[int, ...] = ()
    mlp: Tuple[int, ...] = ()
    # sasrec
    seq_len: int = 0
    n_blocks: int = 0
    n_heads: int = 1
    item_vocab: int = 0
    # two-tower
    tower_mlp: Tuple[int, ...] = ()
    user_vocab: int = 0
    hist_len: int = 0
    table_shard_axis: str = "model"
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32

    def padded_vocab(self, v: int, tp: int) -> int:
        return ((v + tp - 1) // tp) * tp


def embedding_bag_sum(table, ids):
    """(V, D) x (B, L) -1-padded -> (B, D) float32: the sum of each bag's
    valid rows, through the ``embedding_bag`` kernel on the card."""
    return embedding_bag(table, ids, mode="sum")


def _normalise(x):
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-8)


def stable_topk(scores, k: int):
    """Top ``k`` along the last axis, ties lower index first (the order of
    ``jax.lax.top_k``; ``torch.topk`` promises none) -> (values, int32 ids)."""
    order = torch.sort(scores, dim=-1, descending=True, stable=True)
    return order.values[..., :k], order.indices[..., :k].to(torch.int32)


class TwoTower(nn.Module):
    """Parameters as in ``two_tower_init``: ``user_emb`` and ``item_emb``
    (padded vocab, D), ``user_tower`` (2D -> tower_mlp), ``item_tower``
    (D -> tower_mlp) and ``log_tau``. Built uninitialised; fill it with
    ``two_tower_init`` or ``interop.two_tower_params_from_reference``."""

    def __init__(self, cfg: RecsysConfig, device=None):
        super().__init__()
        if cfg.model != "two_tower":
            raise ValueError(f"{cfg.name} is a {cfg.model} config, not two_tower")
        d = cfg.embed_dim
        self.cfg = cfg

        def table(v):
            shape = (cfg.padded_vocab(v, VOCAB_PAD), d)
            return nn.Parameter(torch.empty(shape, dtype=cfg.param_dtype, device=device),
                                requires_grad=False)

        self.user_emb = table(cfg.user_vocab)
        self.item_emb = table(cfg.item_vocab)
        self.user_tower = MLP((2 * d,) + tuple(cfg.tower_mlp), device=device)
        self.item_tower = MLP((d,) + tuple(cfg.tower_mlp), device=device)
        self.log_tau = nn.Parameter(torch.zeros((), dtype=torch.float32, device=device),
                                    requires_grad=False)
        self.requires_grad_(False)

    def user(self, batch):
        """{"user_id": (B,), "hist": (B, hist_len)} int32 -> (B, tower_mlp[-1])
        unit rows (``two_tower_user``)."""
        cd = self.cfg.compute_dtype
        ue = self.user_emb.index_select(0, batch["user_id"].long()).to(cd)
        hist = embedding_bag_sum(self.item_emb, batch["hist"]).to(cd)
        return _normalise(self.user_tower(torch.cat([ue, hist], dim=-1)))

    def item(self, item_ids):
        """(N,) int32 -> (N, tower_mlp[-1]) unit rows (``two_tower_item``)."""
        ie = self.item_emb.index_select(0, item_ids.long()).to(self.cfg.compute_dtype)
        return _normalise(self.item_tower(ie))

    def score_candidates(self, batch):
        """retrieval_cand: the users of ``batch`` against its (C, D)
        ``candidates`` -> (values, int32 ids) of the top min(100, C) scores,
        ties lower index first. The reference's single-device branch; the
        two-phase sharded top-k needs a mesh (ROADMAP item 12)."""
        u = self.user(batch)
        cand = batch["candidates"].to(u.dtype)
        return stable_topk(u @ cand.T, min(100, cand.shape[0]))


@torch.no_grad()
def fill_normal_(t, generator: torch.Generator, scale: float):
    """``t`` <- normal draws * ``scale``, in row chunks of about
    ``FILL_CHUNK_ELEMS`` elements (one call over a 50M-row table would be
    1.28e10 draws at once)."""
    rows = max(1, FILL_CHUNK_ELEMS // max(1, t[0].numel()))
    for s in range(0, t.shape[0], rows):
        t[s : s + rows].normal_(generator=generator).mul_(scale)
    return t


def two_tower_init(generator: torch.Generator, cfg: RecsysConfig, device="cuda") -> TwoTower:
    """A ``TwoTower`` on ``device`` with the reference's init laws, drawn
    from ``generator`` in the reference's order: ``user_emb`` and
    ``item_emb`` normal * 0.02 at the padded vocab, the user tower, the
    item tower (``MLP.init_``), ``log_tau`` = 0."""
    dev = resolve_device(device)
    check_generator(generator, dev)
    model = TwoTower(cfg, device=dev)
    fill_normal_(model.user_emb, generator, 0.02)
    fill_normal_(model.item_emb, generator, 0.02)
    model.user_tower.init_(generator)
    model.item_tower.init_(generator)
    return model
