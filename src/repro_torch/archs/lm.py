"""LM-family cells (port of ``repro.archs.lm``): the train_4k cell, and the
prefill_32k, decode_32k and long_500k serve cells of a GQA or MLA / MoE
transformer, the serve cells on one device or over a mesh
(``make_cell(shape, mi)``).

train_4k is one step of ``lm_loss`` through ``make_train_step`` with the
arch's optimizer (Adafactor lr 1e-3 with momentum 0.9, or AdamW lr 3e-4
with weight decay 0.1), gradients clipped at global norm 1.0, and the
arch's ``grad_accum`` microbatches; it runs on one device (training over
a mesh is ROADMAP item 14e).

prefill_32k runs the full sequence and returns the last position's
logits. decode_32k and long_500k run one decode step: one new token a
sequence against an S-token KV cache, written in place (the reference
donates its cache). long_500k decodes over a 524,288-token cache; its
quadratic prefill is skipped, as the reference skips it for these
pure full-attention archs.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import torch

from repro_torch.archs.base import Arch, CellSpec
from repro_torch.common.device import resolve_device
from repro_torch.data.pipeline import lm_batch
from repro_torch.models.transformer import model as tm
from repro_torch.train.optimizer import adafactor, adamw
from repro_torch.train.train_step import make_train_step, reference_layout

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
        self.optimizer_name = optimizer  # train_4k's
        self.shapes = shapes or LM_SHAPES
        self.grad_accum = grad_accum

    def shape_names(self):
        return list(self.shapes)

    def optimizer(self):
        if self.optimizer_name == "adafactor":
            return adafactor(lr=1e-3, momentum=0.9)
        return adamw(lr=3e-4, weight_decay=0.1)

    def loss(self, model, batch):
        return tm.lm_loss(model, batch)

    def make_cell(self, shape: str, mi=None) -> CellSpec:
        """train_4k: ``fn(model, opt_state, batch) -> (model, opt_state,
        metrics)``, on one device (``mi`` is refused). prefill: ``fn(model,
        tokens)``; decode cells: ``fn(model, cache, tokens) -> (logits,
        cache)``, over ``mi`` where given (the MoE's expert-parallel branch,
        the sequence-sharded cache). ``make_inputs(seed, device)`` draws the
        model from ``seed`` (``init_params``), the tokens from ``lm_batch``
        at step 0 (decode: its first column) and, for train_4k, the
        optimizer's initial state, for decode a zero cache of the shape's
        length at position 0 laid out for ``mi`` (``init_cache``)."""
        cfg = self.cfg
        sh = self.shapes[shape]
        b, s = sh["global_batch"], sh["seq_len"]
        name = f"{self.name}:{shape}"
        if sh["kind"] == "train":
            if mi is not None and len(mi.mesh.devices) > 1:
                raise NotImplementedError(f"{name}: training over a mesh is ROADMAP item 14e")
            opt = self.optimizer()

            def make_train_inputs(seed: int = 0, device="cuda"):
                dev = resolve_device(device)
                model = tm.init_params(torch.Generator(device=dev).manual_seed(seed), cfg,
                                       device=dev)
                batch = lm_batch(seed, 0, b, s, cfg.vocab_size, device=dev)
                return model, opt.init(reference_layout(model)), batch

            step = make_train_step(self.loss, opt, clip_norm=1.0, grad_accum=self.grad_accum)
            return CellSpec(name=name, kind="train", fn=step, make_inputs=make_train_inputs)
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
