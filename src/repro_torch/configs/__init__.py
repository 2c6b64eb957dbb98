"""Recsys configurations of the port (port of the two-tower entries of
``repro.configs.other_configs``), as ``RecsysConfig`` values."""
from __future__ import annotations

from repro_torch.models.recsys.models import RecsysConfig

# Serve shapes of the reference's smoke recsys arch (other_configs.py
# smoke_recsys); the published shapes are archs/recsys.py RECSYS_SHAPES.
SMOKE_RECSYS_SHAPES = {
    "train_batch": dict(kind="train", batch=16),
    "serve_p99": dict(kind="serve", batch=8),
    "serve_bulk": dict(kind="serve", batch=32),
    "retrieval_cand": dict(kind="serve", batch=1, n_candidates=256),
}


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


def smoke_two_tower() -> RecsysConfig:
    return RecsysConfig(
        name="smoke-two-tower", model="two_tower", embed_dim=16,
        tower_mlp=(32, 8), item_vocab=500, user_vocab=300, hist_len=5,
    )


__all__ = ["SMOKE_RECSYS_SHAPES", "smoke_two_tower", "two_tower_retrieval"]
