"""LM-family cells (port of ``repro.archs.lm``): the train_4k cell, and the
prefill_32k, decode_32k and long_500k serve cells of a GQA or MLA / MoE
transformer, the serve cells on one device or over a mesh
(``make_cell(shape, mi)``).

train_4k is one step of ``lm_loss`` through ``make_train_step`` with the
arch's optimizer (Adafactor lr 1e-3 with momentum 0.9, or AdamW lr 3e-4
with weight decay 0.1), gradients clipped at global norm 1.0, and the
arch's ``grad_accum`` microbatches, on one device or over a mesh: there
the MoE runs its expert-parallel branch, forward and backward, each data
group computing its own capacity as the reference's ``shard_map`` does,
and the cell's ``specs`` give the reference's parameter layout
(``model.param_specs``). Over a mesh every leaf is resident as its blocks
from ``make_inputs`` on (or from a whole model's first step:
``model.make_resident``), and so are its gradient and the optimizer's
state of it; attention, the feed-forwards and the vocabulary run
tensor-parallel over the model axis.

prefill_32k runs the full sequence and returns the last position's
logits. decode_32k and long_500k run one decode step: one new token a
sequence against an S-token KV cache, written in place (the reference
donates its cache). long_500k decodes over a 524,288-token cache; its
quadratic prefill is skipped, as the reference skips it for these
pure full-attention archs. Over a mesh of more than one position that
divides every leaf the serve cells hold the model resident as its blocks,
as the train cell does (from ``make_inputs`` on, or from a whole model's
first call), and run tensor-parallel; over a mesh that does not divide
them, whole, on the whole-parameter mesh path.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import torch

from repro_torch.archs.base import Arch, CellSpec
from repro_torch.common.device import make_generator, resolve_device
from repro_torch.data.pipeline import lm_batch
from repro_torch.distributed import layout
from repro_torch.models.transformer import model as tm
from repro_torch.train.optimizer import adafactor, adamw
from repro_torch.train.train_step import init_state, make_train_step, param_leaves

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


def resident_mesh(cfg: tm.TransformerConfig, mi):
    """The mesh a serve cell holds its model resident over: ``mi`` where it
    has more than one position and divides every leaf of ``param_specs``,
    else None (the parameters stay whole). An MoE also needs the whole
    path's expert-parallel branch (a model axis > 1 that divides E): where
    that branch is not taken, the whole path gives all tokens one capacity,
    and a resident MoE would give each data group its own."""
    if not tm.resident_names(cfg, mi):
        return None
    if cfg.is_moe and not (mi.tp_size > 1 and cfg.n_experts % mi.tp_size == 0):
        return None
    leaves = param_leaves(tm.Transformer(cfg, device="meta"))
    try:
        for k, spec in tm.param_specs(cfg, mi).items():
            layout.shard_shape(leaves[k].shape, spec, mi.mesh)
    except ValueError:
        return None
    return mi


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

    def loss(self, model, batch, mi=None):
        return tm.lm_loss(model, batch, mi)

    def make_cell(self, shape: str, mi=None) -> CellSpec:
        """train_4k: ``fn(model, opt_state, batch) -> (model, opt_state,
        metrics)``, over ``mi`` where given. prefill: ``fn(model,
        tokens)``; decode cells: ``fn(model, cache, tokens) -> (logits,
        cache)``, over ``mi`` where given (the MoE's expert-parallel branch,
        the sequence-sharded cache; the model resident over a mesh that
        ``resident_mesh`` admits, tensor-parallel). ``make_inputs(seed,
        device)`` draws the model from ``seed`` (``init_params``; resident
        where the cell's step is), the tokens from ``lm_batch`` at step 0
        (decode: its first column) and, for train_4k, the optimizer's
        initial state, for decode a zero cache of the shape's length at
        position 0 laid out for ``mi`` (``init_cache``)."""
        cfg = self.cfg
        sh = self.shapes[shape]
        b, s = sh["global_batch"], sh["seq_len"]
        name = f"{self.name}:{shape}"
        if sh["kind"] == "train":
            mesh = mi if mi is not None and len(mi.mesh.devices) > 1 else None
            opt = self.optimizer()

            def make_train_inputs(seed: int = 0, device="cuda"):
                dev = resolve_device(device)
                model = tm.make_resident(tm.init_params(make_generator(dev, seed), cfg,
                                                        device=dev), mesh)
                batch = lm_batch(seed, 0, b, s, cfg.vocab_size, device=dev)
                return model, init_state(opt, model), batch

            step = make_train_step(functools.partial(self.loss, mi=mesh), opt, clip_norm=1.0,
                                   grad_accum=self.grad_accum)

            def train_step(model, opt_state, batch, **kw):
                # a model built whole (a checkpoint's, the reference's) turns
                # resident at its first step over the mesh
                return step(tm.make_resident(model, mesh), opt_state, batch, **kw)

            return CellSpec(name=name, kind="train", fn=train_step if mesh else step,
                            make_inputs=make_train_inputs,
                            specs=None if mesh is None else tm.param_specs(cfg, mesh))
        prefill = shape.startswith("prefill")
        resident = resident_mesh(cfg, mi)

        def make_inputs(seed: int = 0, device="cuda"):
            dev = resolve_device(device)
            gen = make_generator(dev, seed)
            model = tm.make_resident(tm.init_params(gen, cfg, device=dev), resident)
            tokens = lm_batch(seed, 0, b, s if prefill else 1, cfg.vocab_size,
                              device=dev)["tokens"]
            if prefill:
                return model, tokens
            return model, tm.init_cache(cfg, b, s, device=dev, mi=mi), tokens[:, 0]

        serve = serve_prefill if prefill else serve_decode

        def fn(model, *args):
            # a model built whole turns resident at its first call over the mesh
            return serve(tm.make_resident(model, resident), *args, mi=mi)

        return CellSpec(name=name, kind="serve", fn=fn, make_inputs=make_inputs)
