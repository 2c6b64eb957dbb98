"""RecSys models of the port (port of ``repro.models.recsys.models``):
``RecsysConfig``, DLRM, DeepFM and the two-tower retrieval model, with their
losses.

- ``DLRM`` (MLPerf): a bottom MLP over the dense features (ReLU after its
  last layer too), one row gather a sparse field (``_lookup``), the dot
  interaction of the 27 vectors by ``bmm`` and its strict lower triangle
  (``torch.tril_indices(k=-1)``, the order of ``jnp.tril_indices``), then
  the top MLP; ``dlrm_loss`` is the mean ``_bce`` of its logits.
- ``DeepFM``: the FM term 0.5 ((sum v)^2 - sum v^2), width-1 linear
  tables, the deep MLP over the flattened embeddings and a bias.
- ``TwoTower``: the user tower reads the user's row and the bag of the
  user's item history, the item tower the item's row; both end in a ReLU
  MLP and an L2 normalisation, so a dot product of their outputs is a
  cosine and inner-product order equals L2 order (what lets an L2
  proximity graph serve this MIPS). The history bag is the
  ``embedding_bag`` kernel (``kernels/embedding_bag.py``), the TPU
  package's hot path of this lookup, and its gradient the
  ``embedding_bag_backward`` kernel. ``two_tower_loss`` is the in-batch
  sampled softmax; past ``neg_chunk`` users its logsumexp is streamed
  over chunks of negatives, each chunk recomputed in the backward
  (``torch.utils.checkpoint``), so the logits in memory stay (B,
  neg_chunk).

- ``SASRec`` (arXiv 1808.09781): item and position embeddings, then
  ``n_blocks`` pre-norm blocks (LayerNorm, bias-free q / k / v / o
  projections around causal ``chunked_attention`` with chunk min(64, S),
  LayerNorm, a bias-free ReLU feed-forward), a final LayerNorm.
  ``sasrec_loss`` is the BCE of each position's next item against one
  sampled negative, masked by ``pos > 0``; ``sasrec_serve`` scores the
  last position against (B, C) candidate items.

Every model is trainable: its parameters require gradients. Serving
calls (``archs/recsys.py``) run under ``torch.inference_mode``. Products
are plain float32 products (``nn.Linear``, ``torch.bmm``,
``torch.matmul``), as the reference leaves them to XLA: they must run
with TF32 off on the card.

Over a mesh (``mi``, a ``MeshInfo`` of more than one position) the
tables are laid out as the reference's specs lay them (``table_spec``:
rows over the model axis, columns over the data axes where those divide
the width). A train cell makes them resident (``make_resident``): each
table becomes a ``distributed.layout.Resident``, its blocks on their positions (one
part for each distinct block on each device, the reference's
``NamedSharding``), and each table read (``mesh_lookup``) reads the
blocks in place. The read splits the ids over the data groups where the
data axes divide the batch (``shard_batch``); for group g and row block
m, every position holding a column block of row block m looks up group
g's ids in it (ids outside the block read zero, a bag's ids outside it
count as padding), and position (g, m) joins those columns in order (the
all-gather of the split columns); the row blocks' results are summed in
shard order on the group's first device, and the groups joined in group
order on the first position's device: the reference's masked gather and
``psum``. The MLPs, towers and blocks run on the model's device, and the
loss is the reference's over the whole batch (the two-tower model's
in-batch negatives span every group). Gradients land on the blocks, and
the optimizer updates each block on its device (``train_step``). A
whole table read over a mesh (a model not made resident) is placed
(``distributed.layout.place``) at each read. ``score_candidates``'s
two-phase top-k is the serving path over a mesh.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.common.device import check_generator, resolve_device
from repro_torch.data.pipeline import shard_batch
from repro_torch.distributed import layout
from repro_torch.distributed.layout import flat_specs, grouped, place
from repro_torch.distributed.meshinfo import sum_in_order
from repro_torch.roofline import collectives
from repro_torch.kernels.embedding_bag import embedding_bag
from repro_torch.models.common.modules import MLP, Dense, LayerNorm, chunked_attention

VOCAB_PAD = 256  # tables are padded to a multiple of this many rows
FILL_CHUNK_ELEMS = 1 << 28  # elements of one normal_ call when filling a table
NEG_CHUNK = 4096  # negatives a chunk of the streamed logsumexp (two_tower_loss)


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


def _tables(cfg: RecsysConfig, vocabs: Sequence[int], dim: int, device) -> nn.ParameterDict:
    """Tables ``t0``, ``t1``, ... of (padded vocab, dim), uninitialised."""
    return nn.ParameterDict({
        f"t{i}": nn.Parameter(torch.empty((cfg.padded_vocab(v, VOCAB_PAD), dim),
                                          dtype=cfg.param_dtype, device=device))
        for i, v in enumerate(vocabs)})


def _fill_tables_(tables: nn.ParameterDict, generator: torch.Generator, dim: int) -> None:
    """``_tables_init``'s law: normal / sqrt(dim), tables in field order."""
    for i in range(len(tables)):
        fill_normal_(tables[f"t{i}"], generator, 1.0 / math.sqrt(dim))


def _rows(table, ids):
    """table's rows of ``ids`` (any shape) -> ids.shape + (D,)."""
    rows = table.index_select(0, ids.reshape(-1).long())
    return rows.reshape(tuple(ids.shape) + tuple(table.shape[1:]))


def _masked_rows(table, ids):
    """``_rows`` with a zero row where an id is -1."""
    rows = _rows(table, ids.clamp_min(0))
    return torch.where((ids >= 0)[..., None], rows, 0.0)


def table_spec(width: int, mi) -> tuple:
    """A table's layout over ``mi``: rows over the model axis (the big
    dimension), the ``width`` columns over the data axes where they divide
    it (fully split tables keep the optimizer's state in budget)."""
    return (mi.tp_axis, mi.axes_if_divisible(width, mi.fsdp_axis))


def make_resident(model: nn.Module, mi) -> nn.Module:
    """Over ``mi`` (a mesh of more than one position) each table parameter
    of ``model`` (a ``table_spec`` leaf) becomes a ``Resident`` of its
    blocks, in place, and its whole tensor is let go; a table already
    resident, or any model on one position, is left as it is."""
    if mi is None or len(mi.mesh.devices) == 1:
        return model
    specs = param_specs(model.cfg, mi)
    tables = [k for k, _ in model.named_parameters() if (specs.get(k) or (None,))[0] == mi.tp_axis]
    return layout.make_resident(model, specs, mi, tables)


def mesh_lookup(table, ids, mi=None, bag: bool = False):
    """The rows of ``ids`` (``bag``: the sum of each -1-padded row of ids,
    ``embedding_bag_sum``) over ``mi``'s layout of ``table``
    (``table_spec``; the module docstring): a ``Resident`` table's blocks in
    place, a whole table's placed for this read; without ``mi``, or on one
    position, one read of the whole table. The result lands on the first
    position's device."""
    if mi is None or len(mi.mesh.devices) == 1:
        if isinstance(table, layout.Resident):
            table = table.blocks().whole()
        return embedding_bag_sum(table, ids) if bag else _rows(table, ids)
    spec = table_spec(table.shape[1], mi)
    devs = mi.mesh.groups(mi.tp_axis)  # (data groups, row blocks)
    if isinstance(table, layout.Resident):
        if table.layout.spec != spec:
            raise ValueError(f"resident blocks laid out by {table.layout.spec}, the mesh's "
                             f"spec is {spec}")
        blocks = table.grid(mi)
        part = grouped(list(table.layout.index), mi, mi.tp_axis)
    else:
        blocks = grouped(place(table, spec, mi), mi, mi.tp_axis)
        part = None
    if bag:  # the kernel reads a dense table
        read = lambda blk, local: embedding_bag_sum(blk.contiguous(), local)
    else:
        read = _masked_rows
    if mi.axes_if_divisible(ids.shape[0], mi.dp_axes) is None:
        id_blocks = [ids]  # one group reads for all, as the reference replicates
    else:
        id_blocks = [g["ids"] for g in shard_batch({"ids": ids}, mi)]
    n = table.shape[0] // devs.shape[1]
    out = []
    for g, blk_ids in enumerate(id_blocks):
        with collectives.group(g):
            parts = []
            for m, dev in enumerate(devs[g]):
                local = blk_ids.to(dev) - m * n
                local = torch.where((local >= 0) & (local < n), local, -1)
                if spec[1] is None:
                    parts.append(read(blocks[g, m], local))
                    if part is not None:
                        table.touch(part[g, m], local.clamp_min(0))
                else:  # column block c on position (c, m), joined in order on (g, m)
                    joined = torch.cat([read(blocks[c, m], local.to(devs[c, m])).to(dev)
                                        for c in range(devs.shape[0])], dim=-1)
                    if part is not None:
                        for c in range(devs.shape[0]):
                            table.touch(part[c, m], local.clamp_min(0).to(devs[c, m]))
                    if m == 0:
                        collectives.record("all-gather", joined)
                    parts.append(joined)
            out.append(sum_in_order(parts, devs[g, 0]).to(table.device))
    return torch.cat(out)


def _lookup(tables: nn.ParameterDict, ids, mi=None):
    """ids (B, F) -> (B, F, D): one gather per field table."""
    return torch.stack([mesh_lookup(tables[f"t{i}"], ids[:, i], mi)
                        for i in range(ids.shape[1])], dim=1)


def _tables_specs(n_tables: int, mi, dim: int) -> dict:
    """``table_spec`` for each of ``n_tables`` tables of width ``dim``. The
    reference takes the column split from ``embed_dim`` for every table,
    which its DeepFM linear tables (width 1) cannot take wherever the data
    axes divide ``embed_dim``; the port takes it from each table's own
    width."""
    return {f"t{i}": table_spec(dim, mi) for i in range(n_tables)}


def _mlp_specs(n_layers: int) -> dict:
    return {"layers": [{"w": (None, None), "b": (None,)} for _ in range(n_layers)]}


def param_specs(cfg: RecsysConfig, mi) -> dict:
    """The reference's layout (``dlrm_specs``, ``deepfm_specs``,
    ``sasrec_specs``, ``two_tower_specs``) of every parameter over ``mi``,
    keyed by the port's names; SASRec's blocks, one module a block here,
    each take the reference's stacked spec without its layer axis."""
    d = cfg.embed_dim
    if cfg.model == "dlrm":
        tree = {"tables": _tables_specs(len(cfg.vocab_sizes), mi, d),
                "bot": _mlp_specs(len(cfg.bot_mlp)), "top": _mlp_specs(len(cfg.top_mlp))}
    elif cfg.model == "deepfm":
        tree = {"tables": _tables_specs(len(cfg.vocab_sizes), mi, d),
                "linear": _tables_specs(len(cfg.vocab_sizes), mi, 1),
                "deep": _mlp_specs(len(cfg.mlp) + 1), "bias": ()}
    elif cfg.model == "sasrec":
        norm = {"scale": (None,), "bias": (None,)}
        blk = {"ln1": norm, "ln2": norm,
               **{k: {"w": (None, None)} for k in ("wq", "wk", "wv", "wo", "ff1", "ff2")}}
        tree = {"items": table_spec(d, mi), "pos": (None, None),
                "blocks": [blk] * cfg.n_blocks, "final_ln": norm}
    else:
        tree = {"user_emb": table_spec(d, mi), "item_emb": table_spec(d, mi),
                "user_tower": _mlp_specs(len(cfg.tower_mlp)),
                "item_tower": _mlp_specs(len(cfg.tower_mlp)), "log_tau": ()}
    return flat_specs(tree)


def _bce(logit, label):
    """max(logit, 0) - logit * label + log1p(exp(-|logit|)); ``torch.maximum``
    splits the gradient of a tie as ``jnp.maximum`` does."""
    return (torch.maximum(logit, logit.new_zeros(())) - logit * label
            + torch.log1p(torch.exp(-logit.abs())))


def _mean_bce(logit, label):
    loss = _bce(logit.float(), label.float()).mean()
    return loss, {"loss": loss}


class DLRM(nn.Module):
    """Parameters as in ``dlrm_init``: ``tables`` t0..t{F-1} (padded vocab,
    D), ``bot`` (n_dense -> bot_mlp) and ``top`` (F + 1 choose 2 + bot_mlp[-1]
    -> top_mlp). Built uninitialised; fill it with ``dlrm_init`` or
    ``interop.recsys_params_from_reference``."""

    def __init__(self, cfg: RecsysConfig, device="cuda"):
        super().__init__()
        if cfg.model != "dlrm":
            raise ValueError(f"{cfg.name} is a {cfg.model} config, not dlrm")
        device = resolve_device(device)
        self.cfg = cfg
        n_f = len(cfg.vocab_sizes) + 1  # + the dense projection
        n_inter = n_f * (n_f - 1) // 2
        self.tables = _tables(cfg, cfg.vocab_sizes, cfg.embed_dim, device)
        self.bot = MLP((cfg.n_dense,) + tuple(cfg.bot_mlp), final_act=True, device=device)
        self.top = MLP((n_inter + cfg.bot_mlp[-1],) + tuple(cfg.top_mlp), device=device)

    def forward(self, batch, mi=None):
        """{"dense": (B, n_dense) float32, "sparse": (B, F) int32} -> (B,) logits."""
        cd = self.cfg.compute_dtype
        x0 = self.bot(batch["dense"].to(cd))  # (B, D)
        emb = _lookup(self.tables, batch["sparse"], mi).to(cd)  # (B, F, D)
        z = torch.cat([x0[:, None], emb], dim=1)  # (B, F + 1, D)
        inter = torch.bmm(z, z.transpose(1, 2))  # (B, F + 1, F + 1) dot interaction
        n_f = z.shape[1]
        iu, ju = torch.tril_indices(n_f, n_f, -1, device=z.device)
        top_in = torch.cat([x0, inter[:, iu, ju]], dim=-1)
        return self.top(top_in)[..., 0]


def dlrm_loss(model: DLRM, batch, mi=None):
    """(mean binary cross-entropy of the logits against ``batch["label"]``,
    {"loss": it})."""
    return _mean_bce(model(batch, mi), batch["label"])


class DeepFM(nn.Module):
    """Parameters as in ``deepfm_init``: ``tables`` (padded vocab, D),
    ``linear`` (padded vocab, 1), ``deep`` (F * D -> mlp -> 1) and a scalar
    ``bias``."""

    def __init__(self, cfg: RecsysConfig, device="cuda"):
        super().__init__()
        if cfg.model != "deepfm":
            raise ValueError(f"{cfg.name} is a {cfg.model} config, not deepfm")
        device = resolve_device(device)
        self.cfg = cfg
        n_f = len(cfg.vocab_sizes)
        self.tables = _tables(cfg, cfg.vocab_sizes, cfg.embed_dim, device)
        self.linear = _tables(cfg, cfg.vocab_sizes, 1, device)
        self.deep = MLP((n_f * cfg.embed_dim,) + tuple(cfg.mlp) + (1,), device=device)
        self.bias = nn.Parameter(torch.zeros((), dtype=cfg.param_dtype, device=device))

    def forward(self, batch, mi=None):
        """{"sparse": (B, F) int32} -> (B,) logits."""
        cd = self.cfg.compute_dtype
        sparse = batch["sparse"]
        emb = _lookup(self.tables, sparse, mi).to(cd)  # (B, F, D)
        lin = _lookup(self.linear, sparse, mi)[..., 0].to(cd)  # (B, F)
        # FM second order: 0.5 * ((sum v)^2 - sum v^2)
        s = emb.sum(1)
        s2 = (emb * emb).sum(1)
        fm = 0.5 * (s * s - s2).sum(-1)
        deep = self.deep(emb.reshape(emb.shape[0], -1))[..., 0]
        return fm + lin.sum(-1) + deep + self.bias.float()


def deepfm_loss(model: DeepFM, batch, mi=None):
    return _mean_bce(model(batch, mi), batch["label"])


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
            return nn.Parameter(torch.empty(shape, dtype=cfg.param_dtype, device=device))

        self.user_emb = table(cfg.user_vocab)
        self.item_emb = table(cfg.item_vocab)
        self.user_tower = MLP((2 * d,) + tuple(cfg.tower_mlp), device=device)
        self.item_tower = MLP((d,) + tuple(cfg.tower_mlp), device=device)
        self.log_tau = nn.Parameter(torch.zeros((), dtype=torch.float32, device=device))

    def user(self, batch, mi=None):
        """{"user_id": (B,), "hist": (B, hist_len)} int32 -> (B, tower_mlp[-1])
        unit rows (``two_tower_user``)."""
        cd = self.cfg.compute_dtype
        ue = mesh_lookup(self.user_emb, batch["user_id"], mi).to(cd)
        hist = mesh_lookup(self.item_emb, batch["hist"], mi, bag=True).to(cd)
        return _normalise(self.user_tower(torch.cat([ue, hist], dim=-1)))

    def item(self, item_ids, mi=None):
        """(N,) int32 -> (N, tower_mlp[-1]) unit rows (``two_tower_item``)."""
        ie = mesh_lookup(self.item_emb, item_ids, mi).to(self.cfg.compute_dtype)
        return _normalise(self.item_tower(ie))

    @torch.inference_mode()
    def score_candidates(self, batch, mesh=None, *, two_phase_topk: bool = True):
        """retrieval_cand: the users of ``batch`` against its (C, D)
        ``candidates`` -> (values, int32 ids) of the top min(100, C) scores,
        ties lower index first.

        With a ``mesh`` (a ``MeshInfo``) whose model axis divides C, and
        ``two_phase_topk``, the candidates split over the model axis: each
        shard takes its own top-k and only (P x k) score / id pairs reach
        the merge (``two_phase_topk``). Otherwise the single-device branch:
        one product and one top-k. A serving call: it runs under
        ``torch.inference_mode``."""
        u = self.user(batch)
        cand = batch["candidates"].to(u.dtype)
        c = cand.shape[0]
        k = min(100, c)
        if two_phase_topk and mesh is not None and mesh.tp_size > 1 and c % mesh.tp_size == 0:
            return two_phase_topk_scores(u, cand, mesh, k)
        return stable_topk(u @ cand.T, k)


def _lse_chunk(m, lsum, u32, vc, tau):
    """One step of the online logsumexp over a chunk of negatives."""
    logits = (u32 @ vc.T) / tau  # (B, chunk)
    m_new = torch.maximum(m, logits.amax(-1))
    lsum = lsum * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(-1)
    return m_new, lsum


def two_tower_loss(model: TwoTower, batch, mi=None, *, neg_chunk: int = NEG_CHUNK):
    """In-batch sampled softmax (RecSys'19 two-tower retrieval objective):
    mean over users of logsumexp_j(u_b . v_j / tau) - u_b . v_b / tau.

    For B <= ``neg_chunk`` the (B, B) logits are taken whole. Past it (B a
    multiple of ``neg_chunk``) the logsumexp is the reference's online
    recurrence over chunks of ``neg_chunk`` negatives, each chunk under
    ``torch.utils.checkpoint``: the backward recomputes its (B, neg_chunk)
    logits instead of keeping all of them (17 GB in float32 at B = 65,536).
    """
    u = model.user(batch, mi)  # (B, D)
    v = model.item(batch["item_id"], mi)  # (B, D)
    tau = torch.maximum(torch.exp(model.log_tau), model.log_tau.new_tensor(1e-3))
    b = u.shape[0]
    diag = (u * v).sum(-1).float() / tau
    if b <= neg_chunk:
        lse = torch.logsumexp((u @ v.T).float() / tau, dim=-1)
    else:
        if b % neg_chunk:
            raise ValueError(f"batch {b} is not a multiple of neg_chunk {neg_chunk}")
        u32 = u.float()
        vc_all = v.float().reshape(b // neg_chunk, neg_chunk, -1)
        m = torch.full((b,), -math.inf, dtype=torch.float32, device=u.device)
        lsum = torch.zeros((b,), dtype=torch.float32, device=u.device)
        for vc in vc_all:
            m, lsum = checkpoint(_lse_chunk, m, lsum, u32, vc, tau, use_reentrant=False)
        lse = m + torch.log(torch.maximum(lsum, lsum.new_tensor(1e-30)))
    loss = (lse - diag).mean()
    return loss, {"loss": loss}


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


class SASRecBlock(nn.Module):
    """One block of ``sasrec_init``'s ``blocks``: ``ln1``, ``wq`` / ``wk`` /
    ``wv`` / ``wo``, ``ln2``, ``ff1`` / ``ff2``; no projection has a bias."""

    def __init__(self, d: int, dtype, device):
        super().__init__()
        self.ln1 = LayerNorm(d, dtype=dtype, device=device)
        self.wq, self.wk, self.wv, self.wo = (Dense(d, d, dtype=dtype, device=device)
                                              for _ in range(4))
        self.ln2 = LayerNorm(d, dtype=dtype, device=device)
        self.ff1, self.ff2 = (Dense(d, d, dtype=dtype, device=device) for _ in range(2))


class SASRec(nn.Module):
    """Parameters as in ``sasrec_init``: ``items`` (padded vocab, D), ``pos``
    (seq_len, D), ``blocks`` (one ``SASRecBlock`` each, where the reference
    stacks them on a leading axis) and ``final_ln``. Built uninitialised;
    fill it with ``sasrec_init`` or ``interop.sasrec_params_from_reference``."""

    def __init__(self, cfg: RecsysConfig, device="cuda"):
        super().__init__()
        if cfg.model != "sasrec":
            raise ValueError(f"{cfg.name} is a {cfg.model} config, not sasrec")
        device = resolve_device(device)
        d = cfg.embed_dim
        self.cfg = cfg
        self.items = nn.Parameter(torch.empty((cfg.padded_vocab(cfg.item_vocab, VOCAB_PAD), d),
                                              dtype=cfg.param_dtype, device=device))
        self.pos = nn.Parameter(torch.empty((cfg.seq_len, d), dtype=cfg.param_dtype,
                                            device=device))
        self.blocks = nn.ModuleList(SASRecBlock(d, cfg.param_dtype, device)
                                    for _ in range(cfg.n_blocks))
        self.final_ln = LayerNorm(d, dtype=cfg.param_dtype, device=device)

    def hidden(self, seq, mi=None):
        """seq (B, S) int32 item ids (0 = padding) -> (B, S, D)
        (``sasrec_hidden``)."""
        cfg = self.cfg
        b, s = seq.shape
        cd = cfg.compute_dtype
        h = mesh_lookup(self.items, seq, mi).to(cd) + self.pos[None, :s].to(cd)
        nh, d = cfg.n_heads, cfg.embed_dim
        for bp in self.blocks:
            x = bp.ln1(h)
            q, k, v = (w(x).reshape(b, s, nh, d // nh) for w in (bp.wq, bp.wk, bp.wv))
            a = chunked_attention(q, k, v, causal=True, chunk=min(64, s))
            h = h + bp.wo(a.reshape(b, s, d))
            x = bp.ln2(h)
            h = h + bp.ff2(torch.relu(bp.ff1(x)))
        return self.final_ln(h)

    def forward(self, seq, mi=None):
        return self.hidden(seq, mi)


def sasrec_loss(model: SASRec, batch, mi=None):
    """BCE over (positive next item, sampled negative) pairs, SASRec §3:
    the sum over positions with ``pos > 0`` over max(their count, 1)."""
    h = model.hidden(batch["seq"], mi)  # (B, S, D)
    pos_e = mesh_lookup(model.items, batch["pos"], mi).to(h.dtype)
    neg_e = mesh_lookup(model.items, batch["neg"], mi).to(h.dtype)
    pos_s = (h * pos_e).sum(-1).float()
    neg_s = (h * neg_e).sum(-1).float()
    mask = (batch["pos"] > 0).float()
    per = _bce(pos_s, torch.ones_like(pos_s)) + _bce(neg_s, torch.zeros_like(neg_s))
    loss = (per * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    return loss, {"loss": loss}


def sasrec_serve(model: SASRec, batch):
    """The last position of each sequence against its (B, C) candidate
    items -> (B, C) scores."""
    h = model.hidden(batch["seq"])[:, -1]  # (B, D)
    cand = model.items[batch["candidates"].long()].to(h.dtype)  # (B, C, D)
    return torch.bmm(cand, h[:, :, None])[..., 0]


def sasrec_init(generator: torch.Generator, cfg: RecsysConfig, device="cuda") -> SASRec:
    """A ``SASRec`` on ``device`` with the reference's init laws, drawn from
    ``generator``: ``items`` and ``pos`` normal * 0.02, then each block's
    wq, wk, wv, wo, ff1, ff2 (``Dense.init_``); LayerNorms at ones and
    zeros."""
    dev = resolve_device(device)
    check_generator(generator, dev)
    model = SASRec(cfg, device=dev)
    fill_normal_(model.items, generator, 0.02)
    fill_normal_(model.pos, generator, 0.02)
    for bp in model.blocks:
        for w in (bp.wq, bp.wk, bp.wv, bp.wo, bp.ff1, bp.ff2):
            w.init_(generator)
    return model


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


def dlrm_init(generator: torch.Generator, cfg: RecsysConfig, device="cuda") -> DLRM:
    """A ``DLRM`` on ``device`` with the reference's init laws, drawn from
    ``generator``: the tables normal / sqrt(D) in field order, then the
    bottom and top MLPs (``MLP.init_``)."""
    dev = resolve_device(device)
    check_generator(generator, dev)
    model = DLRM(cfg, device=dev)
    _fill_tables_(model.tables, generator, cfg.embed_dim)
    model.bot.init_(generator)
    model.top.init_(generator)
    return model


def deepfm_init(generator: torch.Generator, cfg: RecsysConfig, device="cuda") -> DeepFM:
    """A ``DeepFM`` on ``device`` with the reference's init laws: the tables
    normal / sqrt(D), the linear tables normal (width 1), the deep MLP, the
    bias 0."""
    dev = resolve_device(device)
    check_generator(generator, dev)
    model = DeepFM(cfg, device=dev)
    _fill_tables_(model.tables, generator, cfg.embed_dim)
    _fill_tables_(model.linear, generator, 1)
    model.deep.init_(generator)
    return model
