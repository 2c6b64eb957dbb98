"""Recsys and MACE configurations of the port (port of
``repro.configs.other_configs``'s recsys and MACE entries), the LM
configurations (``lm_configs.py``), and the registry of archs under the
reference's names (``repro/configs/__init__.py``). ``NOT_PORTED`` names
the archs the port lacks and the ROADMAP item that ports each."""
from __future__ import annotations

from repro_torch.archs.base import register
from repro_torch.archs.gnn import GNNArch
from repro_torch.archs.recsys import RecsysArch
from repro_torch.configs import lm_configs as lm
from repro_torch.models.gnn.mace import MACEConfig
from repro_torch.models.recsys.models import RecsysConfig

# MLPerf DLRM (Criteo 1TB) categorical vocab sizes: 26 fields.
CRITEO_VOCABS = (
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771,
    25641295, 39664984, 585935, 12972, 108, 36,
)

# DeepFM on Criteo-style features: 13 bucketized numeric (vocab 1024) +
# 26 categorical hashed to <= 1M rows (hash trick, standard DeepFM practice).
DEEPFM_VOCABS = tuple([1024] * 13 + [min(v, 1_000_000) for v in CRITEO_VOCABS])

# Serve shapes of the reference's smoke recsys arch (other_configs.py
# smoke_recsys); the published shapes are archs/recsys.py RECSYS_SHAPES.
SMOKE_RECSYS_SHAPES = {
    "train_batch": dict(kind="train", batch=16),
    "serve_p99": dict(kind="serve", batch=8),
    "serve_bulk": dict(kind="serve", batch=32),
    "retrieval_cand": dict(kind="serve", batch=1, n_candidates=256),
}


def dlrm_mlperf() -> RecsysConfig:
    """[arXiv:1906.00091] MLPerf config: 13 dense, 26 sparse, dim 128,
    bottom 512-256-128, top 1024-1024-512-256-1, dot interaction."""
    return RecsysConfig(
        name="dlrm-mlperf",
        model="dlrm",
        embed_dim=128,
        vocab_sizes=CRITEO_VOCABS,
        n_dense=13,
        bot_mlp=(512, 256, 128),
        top_mlp=(1024, 1024, 512, 256, 1),
    )


def deepfm() -> RecsysConfig:
    """[arXiv:1703.04247]: 39 fields, dim 10, MLP 400-400-400, FM interaction."""
    return RecsysConfig(
        name="deepfm",
        model="deepfm",
        embed_dim=10,
        vocab_sizes=DEEPFM_VOCABS,
        mlp=(400, 400, 400),
    )


def two_tower_retrieval() -> RecsysConfig:
    """[RecSys'19 YouTube] two-tower retrieval: dim 256, towers
    1024-512-256, dot interaction, history of 50 items, 50M users and
    items."""
    return RecsysConfig(
        name="two-tower-retrieval",
        model="two_tower",
        embed_dim=256,
        tower_mlp=(1024, 512, 256),
        item_vocab=50_000_000,
        user_vocab=50_000_000,
        hist_len=50,
    )


def sasrec() -> RecsysConfig:
    """[arXiv:1808.09781]: dim 50, 2 blocks, 1 head, seq 50; item vocab 1M
    (industrial scale: the paper does not pin it), so that retrieval_cand's
    1M candidates are defined."""
    return RecsysConfig(
        name="sasrec",
        model="sasrec",
        embed_dim=50,
        seq_len=50,
        n_blocks=2,
        n_heads=1,
        item_vocab=1_000_000,
    )


def smoke_sasrec() -> RecsysConfig:
    return RecsysConfig(
        name="smoke-sasrec", model="sasrec", embed_dim=16,
        seq_len=10, n_blocks=2, n_heads=1, item_vocab=200,
    )


def smoke_dlrm() -> RecsysConfig:
    return RecsysConfig(
        name="smoke-dlrm", model="dlrm", embed_dim=8,
        vocab_sizes=(100, 50, 30), n_dense=4, bot_mlp=(16, 8), top_mlp=(16, 1),
    )


def smoke_deepfm() -> RecsysConfig:
    return RecsysConfig(
        name="smoke-deepfm", model="deepfm", embed_dim=5,
        vocab_sizes=(40,) * 6, mlp=(16, 16),
    )


def smoke_two_tower() -> RecsysConfig:
    return RecsysConfig(
        name="smoke-two-tower", model="two_tower", embed_dim=16,
        tower_mlp=(32, 8), item_vocab=500, user_vocab=300, hist_len=5,
    )


def mace() -> GNNArch:
    """[arXiv:2206.07697]: 2 interaction layers, 128 channels, l_max 2,
    correlation order 3, 8 Bessel RBFs, E(3)-equivariant."""
    return GNNArch(MACEConfig(name="mace", n_layers=2, d_hidden=128, l_max=2,
                              correlation_order=3, n_rbf=8))


SMOKE_GNN_SHAPES = {
    "full_graph_sm": dict(kind="train", n_nodes=64, n_edges=256, d_feat=16, mode="simple"),
    "minibatch_lg": dict(kind="train", batch_nodes=8, fanouts=(3, 2), d_feat=16,
                         mode="sampled"),
    "ogb_products": dict(kind="train", n_nodes=128, n_edges=512, d_feat=8,
                         mode="dst_partitioned"),
    "molecule": dict(kind="train", n_nodes=6, n_edges=12, batch=4, mode="batched"),
}


def smoke_mace() -> GNNArch:
    return GNNArch(MACEConfig(name="smoke-mace", n_layers=2, d_hidden=8, n_rbf=4),
                   shapes=SMOKE_GNN_SHAPES)


# The reference's registered names the port does not have, and the ROADMAP
# item of each: the dry run's AIRSHIP cells (the serve path itself is
# archs/airship.py).
NOT_PORTED = dict.fromkeys(("airship-sift1m", "smoke-airship"), "14e")

register("dlrm-mlperf", lambda: RecsysArch(dlrm_mlperf()))
register("deepfm", lambda: RecsysArch(deepfm()))
register("two-tower-retrieval", lambda: RecsysArch(two_tower_retrieval()))
register("smoke-dlrm", lambda: RecsysArch(smoke_dlrm(), SMOKE_RECSYS_SHAPES))
register("smoke-deepfm", lambda: RecsysArch(smoke_deepfm(), SMOKE_RECSYS_SHAPES))
register("smoke-two-tower", lambda: RecsysArch(smoke_two_tower(), SMOKE_RECSYS_SHAPES))
register("sasrec", lambda: RecsysArch(sasrec()))
register("smoke-sasrec", lambda: RecsysArch(smoke_sasrec(), SMOKE_RECSYS_SHAPES))
register("deepseek-v2-236b", lm.deepseek_v2_236b)
register("deepseek-v3-671b", lm.deepseek_v3_671b)
register("command-r-plus-104b", lm.command_r_plus_104b)
register("command-r-35b", lm.command_r_35b)
register("granite-3-2b", lm.granite_3_2b)
register("smoke-gqa", lm.smoke_gqa)
register("smoke-mla-moe", lm.smoke_mla_moe)
register("mace", mace)
register("smoke-mace", smoke_mace)

__all__ = ["CRITEO_VOCABS", "DEEPFM_VOCABS", "NOT_PORTED", "SMOKE_GNN_SHAPES",
           "SMOKE_RECSYS_SHAPES", "deepfm", "dlrm_mlperf", "mace", "sasrec", "smoke_deepfm",
           "smoke_dlrm", "smoke_mace", "smoke_sasrec", "smoke_two_tower", "two_tower_retrieval"]
