"""Attention, SASRec and the GQA transformer on the card against the CPU.

Marked ``cuda``; each test skips where there is no CUDA device. This file
imports no JAX, so it also runs where only the port is installed:

    python -m pytest -m cuda tests/test_torch_cuda_lm.py

The same weights and inputs run on the card and on the CPU, in float32
with TF32 off on the card (set by the ``dev`` fixture and restored):

- ``flash_attention`` forward and its gradients (causal, GQA g = 2, a
  padded tail chunk; and a soft cap over a q_offset): within 2e-5
  absolute of values of O(1) (cuBLAS and the CPU's BLAS add in other
  orders; the card divides by a host scalar as a multiply by its
  reciprocal);
- ``SASRec.hidden`` at ``smoke-sasrec``: within 1e-5 relative of the
  largest element;
- ``smoke-gqa`` prefill logits and eight decode steps' logits and caches:
  within 1e-5 relative of the largest element;
- the decode step writes the cache in place on the card: the same storage
  (``data_ptr``) after each step, the written row equal to the CPU's,
  the rows past ``pos`` untouched.
"""
import copy

import pytest
import torch

from repro_torch.archs import get_arch
from repro_torch.configs import smoke_sasrec
from repro_torch.models.common.flash import AttnMeta, flash_attention
from repro_torch.models.recsys import sasrec_init
from repro_torch.models.transformer import decode_step, init_cache, init_params, prefill_logits


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = prev


def close(got, want, rtol=1e-5):
    want = want.detach().float().cpu()
    scale = max(float(want.abs().max()), 1e-30)
    err = float((got.detach().float().cpu() - want).abs().max())
    assert err <= rtol * scale, (err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("meta", [AttnMeta(True, 0, 7, 0.0), AttnMeta(True, 3, 5, 2.5)],
                         ids=["causal_padded", "soft_cap_offset"])
def test_flash_forward_and_backward_card_equals_cpu(dev, meta):
    gen = torch.Generator().manual_seed(0)
    q = torch.randn((2, 19, 4, 16), generator=gen)
    k = torch.randn((2, 19, 2, 16), generator=gen)
    v = torch.randn((2, 19, 2, 16), generator=gen)
    w = torch.randn((2, 19, 4, 16), generator=gen)
    outs, grads = [], []
    for d in ("cpu", dev):
        leaves = [t.to(d).detach().requires_grad_() for t in (q, k, v)]
        out = flash_attention(*leaves, meta)
        (out * w.to(d)).sum().backward()
        outs.append(out)
        grads.append([t.grad for t in leaves])
    assert outs[1].is_cuda
    assert float((outs[1].detach().cpu() - outs[0].detach()).abs().max()) <= 2e-5
    for want, got in zip(*grads):
        assert float((got.cpu() - want).abs().max()) <= 2e-5


@pytest.mark.cuda
def test_sasrec_hidden_card_equals_cpu(dev):
    cfg = smoke_sasrec()
    model = sasrec_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    card = copy.deepcopy(model).to(dev)
    seq = torch.randint(1, cfg.item_vocab, (16, cfg.seq_len), generator=torch.Generator()
                        .manual_seed(1), dtype=torch.int32)
    with torch.inference_mode():
        close(card.hidden(seq.to(dev)), model.hidden(seq))


@pytest.mark.cuda
def test_gqa_prefill_decode_and_cache_card_equals_cpu(dev):
    cfg = get_arch("smoke-gqa").cfg
    model = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    card = copy.deepcopy(model).to(dev)
    toks = torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(2),
                         dtype=torch.int32)
    with torch.inference_mode():
        close(prefill_logits(card, toks.to(dev)), prefill_logits(model, toks))
        cache = init_cache(cfg, 2, 8, device="cpu")
        cache_d = init_cache(cfg, 2, 8, device=dev)
        ptrs = (cache_d["k"].data_ptr(), cache_d["v"].data_ptr())
        for t in range(8):
            want, cache = decode_step(model, cache, toks[:, t])
            got, cache_d = decode_step(card, cache_d, toks[:, t].to(dev))
            close(got, want)
            assert (cache_d["k"].data_ptr(), cache_d["v"].data_ptr()) == ptrs
            for key in ("k", "v"):
                close(cache_d[key], cache[key])
                assert not cache_d[key][:, :, t + 1 :].any()
            assert int(cache_d["pos"]) == t + 1
