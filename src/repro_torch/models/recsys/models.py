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

Serving only: the model's tensors do not require gradients. The
reference's ``mi`` (mesh) argument survives only where it changes the
computation: ``score_candidates``'s two-phase top-k over a device mesh
(``distributed/meshinfo.py``); elsewhere its layout constraints do nothing
on one controller. DLRM, DeepFM, SASRec and the training loss are not
ported (ROADMAP item 14).
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

    def __init__(self, cfg: RecsysConfig, device="cuda"):
        super().__init__()
        if cfg.model != "two_tower":
            raise ValueError(f"{cfg.name} is a {cfg.model} config, not two_tower")
        device = resolve_device(device)
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

    def score_candidates(self, batch, mesh=None, *, two_phase_topk: bool = True):
        """retrieval_cand: the users of ``batch`` against its (C, D)
        ``candidates`` -> (values, int32 ids) of the top min(100, C) scores,
        ties lower index first.

        With a ``mesh`` (a ``MeshInfo``) whose model axis divides C, and
        ``two_phase_topk``, the candidates split over the model axis: each
        shard takes its own top-k and only (P x k) score / id pairs reach
        the merge (``two_phase_topk``). Otherwise the single-device branch:
        one product and one top-k."""
        u = self.user(batch)
        cand = batch["candidates"].to(u.dtype)
        c = cand.shape[0]
        k = min(100, c)
        if two_phase_topk and mesh is not None and mesh.tp_size > 1 and c % mesh.tp_size == 0:
            return two_phase_topk_scores(u, cand, mesh, k)
        return stable_topk(u @ cand.T, k)


def two_phase_topk_scores(u, cand, mesh, k: int):
    """The two-phase top-k of ``u @ cand.T`` over ``mesh`` (a ``MeshInfo``):
    candidate shard m (rows [m*C/P, (m+1)*C/P)) on device (g, m) of the
    mesh scores data group g's users (the whole batch when the data axes do
    not divide it), takes its stable top-k and offsets its ids by m*C/P;
    the group's first device merges the (B_g, P*k) pairs with one more
    stable top-k. The result lands on ``u``'s device."""
    grid = mesh.mesh.groups(mesh.tp_axis)  # (data groups, P)
    n_groups, p = grid.shape
    c_local = cand.shape[0] // p
    split = mesh.axes_if_divisible(u.shape[0], mesh.dp_axes) is not None
    rows_per = u.shape[0] // n_groups if split else u.shape[0]
    tops, ids = [], []
    for g in range(n_groups if split else 1):
        u_g = u[g * rows_per : (g + 1) * rows_per]
        head = grid[g, 0]
        parts = []
        for m in range(p):
            dev = grid[g, m]
            scores = u_g.to(dev) @ cand[m * c_local : (m + 1) * c_local].to(dev).T
            top, idx = stable_topk(scores, k)
            parts.append((top.to(head), (idx + m * c_local).to(head)))
        all_top = torch.stack([t for t, _ in parts], 1)  # (B_g, P, k)
        all_idx = torch.stack([i for _, i in parts], 1)
        t2, pos = stable_topk(all_top.reshape(all_top.shape[0], -1), k)
        i2 = all_idx.reshape(all_idx.shape[0], -1).gather(1, pos.long())
        tops.append(t2.to(u.device))
        ids.append(i2.to(u.device))
    return torch.cat(tops), torch.cat(ids)


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
