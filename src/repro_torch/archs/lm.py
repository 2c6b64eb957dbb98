"""LM-family cells (port of ``repro.archs.lm``): prefill_32k, decode_32k and
long_500k serve cells of a GQA or MLA / MoE transformer, on one device or
over a mesh (``make_cell(shape, mi)``).

prefill_32k runs the full sequence and returns the last position's
logits. decode_32k and long_500k run one decode step: one new token a
sequence against an S-token KV cache, written in place (the reference
donates its cache). long_500k decodes over a 524,288-token cache; its
quadratic prefill is skipped, as the reference skips it for these
pure full-attention archs. train_4k (``lm_loss`` through
``make_train_step``) is ROADMAP item 14c's LM training.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import torch

from repro_torch.archs.base import Arch, CellSpec
from repro_torch.common.device import resolve_device
from repro_torch.data.pipeline import lm_batch
from repro_torch.models.transformer import model as tm

NEXT_ITEM = "ROADMAP item 14c (LM training)"

LM_SHAPES: Dict[str, dict] = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="serve", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="serve", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="serve", seq_len=524288, global_batch=1),
}


@torch.inference_mode()
def serve_prefill(model: tm.Transformer, tokens, mi=None):
    """prefill: tokens (B, S) -> the last position's (B, vocab_padded) float32
    logits."""
    return tm.prefill_logits(model, tokens, mi)


@torch.inference_mode()
def serve_decode(model: tm.Transformer, cache: dict, tokens, mi=None):
    """decode: tokens (B,) at ``cache["pos"]`` -> (logits, the cache with pos
    + 1), the cache written in place."""
    return tm.decode_step(model, cache, tokens, mi)


class LMArch(Arch):
    family = "lm"

    def __init__(self, cfg: tm.TransformerConfig, optimizer: str = "adafactor",
                 shapes: Optional[Dict[str, dict]] = None, grad_accum: int = 1):
        self.name = cfg.name
        self.cfg = cfg
        self.optimizer_name = optimizer  # train_4k's (item 14c, LM training)
        self.shapes = shapes or LM_SHAPES
        self.grad_accum = grad_accum

    def shape_names(self):
        return list(self.shapes)

    def make_cell(self, shape: str, mi=None) -> CellSpec:
        """prefill: ``fn(model, tokens)``; decode cells: ``fn(model, cache,
        tokens) -> (logits, cache)``, over ``mi`` where given (the MoE's
        expert-parallel branch, the sequence-sharded cache).
        ``make_inputs(seed, device)`` draws the model from ``seed``
        (``init_params``), the tokens from ``lm_batch`` at step 0 (decode:
        its first column) and, for decode, a zero cache of the shape's
        length at position 0 laid out for ``mi`` (``init_cache``)."""
        cfg = self.cfg
        sh = self.shapes[shape]
        b, s = sh["global_batch"], sh["seq_len"]
        name = f"{self.name}:{shape}"
        if sh["kind"] == "train":
            raise NotImplementedError(f"{name}: lm_loss and LM training are {NEXT_ITEM}")
        prefill = shape.startswith("prefill")

        def make_inputs(seed: int = 0, device="cuda"):
            dev = resolve_device(device)
            gen = torch.Generator(device=dev).manual_seed(seed)
            model = tm.init_params(gen, cfg, device=dev)
            tokens = lm_batch(seed, 0, b, s if prefill else 1, cfg.vocab_size,
                              device=dev)["tokens"]
            if prefill:
                return model, tokens
            return model, tm.init_cache(cfg, b, s, device=dev, mi=mi), tokens[:, 0]

        fn = serve_prefill if prefill else serve_decode
        return CellSpec(name=name, kind="serve", fn=functools.partial(fn, mi=mi),
                        make_inputs=make_inputs)
