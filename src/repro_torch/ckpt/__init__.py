"""Fault-tolerant checkpoints (port of ``repro.ckpt``)."""
from repro_torch.ckpt.checkpoint import latest_step, leaf_key, prune_old, restore, save

__all__ = ["latest_step", "leaf_key", "prune_old", "restore", "save"]
