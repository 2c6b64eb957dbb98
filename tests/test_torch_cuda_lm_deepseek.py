"""MLA, the MoE and the sequence-sharded decode on the card against the CPU.

Marked ``cuda``; each test skips where there is no CUDA device. This file
imports no JAX, so it also runs where only the port is installed:

    python -m pytest -m cuda tests/test_torch_cuda_lm_deepseek.py

The same weights (``smoke-mla-moe``'s, ``init_params`` from a CPU
generator) and inputs run on the card and on the CPU, TF32 off on the
card (the ``dev`` fixture sets it and restores it):

- float32 prefill logits, eight decode steps' logits and the latent cache:
  within 1e-5 of the largest element (cuBLAS and the CPU's BLAS add in
  other orders); the cache written in place (``data_ptr`` unchanged, the
  rows past ``pos`` untouched);
- the same decode over a (1, 4) mesh of the card (four sequence shards,
  the MoE expert-parallel) against the (1, 4) mesh of the CPU and against
  the card's one-device decode: within 1e-5 of the largest element;
- the MoE in bf16 at the published routing width (160 experts, top-6,
  2,048 tokens): the card's float32 softmax may differ from the CPU's in
  the last ulp, which can flip a tie at the threshold after the bf16
  cast (and a flipped pair can push another token past an expert's
  capacity), so the tokens whose kept (token, expert) pairs differ are
  counted (at most 1% of them) and the rows of the others held within
  5e-2 of the largest element (bf16 products rounded in other orders);
- two card runs of that MoE equal bit for bit: the expert-major add is one
  ``index_add_`` an expert (no colliding rows in a launch), so no atomic
  order enters.
"""
import copy
import dataclasses

import pytest
import torch

from repro_torch.archs import get_arch
from repro_torch.distributed import MeshInfo
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models.transformer import (
    decode_step,
    gather_cache,
    init_cache,
    init_params,
    prefill_logits,
)
from repro_torch.models.recsys.models import stable_topk
from repro_torch.models.transformer.moe import MoE, _gates, _router_probs, capacity, moe_ffn


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


def smoke_model():
    cfg = get_arch("smoke-mla-moe").cfg
    return cfg, init_params(torch.Generator().manual_seed(0), cfg, device="cpu")


def tokens(b, s, vocab, seed=2):
    return torch.randint(0, vocab, (b, s), generator=torch.Generator().manual_seed(seed),
                         dtype=torch.int32)


@pytest.mark.cuda
def test_mla_moe_prefill_decode_and_cache_card_equals_cpu(dev):
    cfg, model = smoke_model()
    card = copy.deepcopy(model).to(dev)
    toks = tokens(2, 8, cfg.vocab_size)
    with torch.inference_mode():
        close(prefill_logits(card, toks.to(dev)), prefill_logits(model, toks))
        cache = init_cache(cfg, 2, 8, device="cpu")
        cache_d = init_cache(cfg, 2, 8, device=dev)
        ptr = cache_d["c"].data_ptr()
        for t in range(8):
            want, cache = decode_step(model, cache, toks[:, t])
            got, cache_d = decode_step(card, cache_d, toks[:, t].to(dev))
            close(got, want)
            close(cache_d["c"], cache["c"])
            assert cache_d["c"].data_ptr() == ptr and not cache_d["c"][:, :, t + 1 :].any()
            assert int(cache_d["pos"]) == t + 1


@pytest.mark.cuda
def test_sharded_decode_card_equals_cpu(dev):
    cfg, model = smoke_model()
    card = copy.deepcopy(model).to(dev)
    toks = tokens(4, 8, cfg.vocab_size, seed=3)
    mi_d = MeshInfo(mesh=make_test_mesh(4, model=4, device="cuda:0"))
    mi_c = MeshInfo(mesh=make_test_mesh(4, model=4, device="cpu"))
    with torch.inference_mode():
        close(prefill_logits(card, toks.to(dev), mi_d), prefill_logits(model, toks, mi_c))
        one = init_cache(cfg, 4, 8, device=dev)
        cache_c = init_cache(cfg, 4, 8, mi=mi_c)
        cache_d = init_cache(cfg, 4, 8, mi=mi_d)
        blocks = cache_d["c"][0]
        assert len(blocks) == 4 and all(b.is_cuda for b in blocks)
        ptrs = [b.data_ptr() for b in blocks]
        for t in range(8):
            want, cache_c = decode_step(model, cache_c, toks[:, t], mi_c)
            got, cache_d = decode_step(card, cache_d, toks[:, t].to(dev), mi_d)
            alone, one = decode_step(card, one, toks[:, t].to(dev))
            close(got, want)
            close(got, alone)
        assert [b.data_ptr() for b in cache_d["c"][0]] == ptrs
        close(gather_cache(cache_d)["c"], gather_cache(cache_c)["c"])


def published_width_moe(device):
    """smoke widths with deepseek-v2-236b's routing: 160 experts, top-6, bf16."""
    cfg = dataclasses.replace(get_arch("smoke-mla-moe").cfg, n_experts=160, top_k=6,
                              n_shared_experts=2, param_dtype=torch.bfloat16,
                              compute_dtype=torch.bfloat16)
    mp = MoE(cfg, device="cpu").init_(torch.Generator().manual_seed(4)).requires_grad_(False)
    x = torch.randn((4, 512, cfg.d_model), generator=torch.Generator().manual_seed(5))
    return cfg, mp, x.to(torch.bfloat16)


def kept_pairs(mp, cfg, x):
    """(T, E) bool, on the CPU: the (token, expert) pairs the dispatch keeps,
    the gate > 0 and among the expert's top-C by normalised gate."""
    pf = _router_probs(mp, x).to(x.dtype).reshape(-1, cfg.n_experts)
    gate, total = _gates(pf, cfg.top_k, 0, cfg.n_experts)
    gate = gate / total.clamp_min(1e-9)[:, None]
    t = pf.shape[0]
    top_w, idx = stable_topk(gate.T, min(capacity(cfg, t, cfg.n_experts), t))
    mask = torch.zeros((cfg.n_experts, t), dtype=torch.bool, device=x.device)
    return mask.scatter_(1, idx.long(), top_w > 0).T.cpu()


@pytest.mark.cuda
def test_moe_bf16_card_equals_cpu_up_to_flipped_ties(dev):
    cfg, mp, x = published_width_moe(dev)
    card = copy.deepcopy(mp).to(dev)
    with torch.inference_mode():
        want = moe_ffn(mp, cfg, x).reshape(-1, cfg.d_model)
        got = moe_ffn(card, cfg, x.to(dev)).reshape(-1, cfg.d_model)
        differ = (kept_pairs(mp, cfg, x) != kept_pairs(card, cfg, x.to(dev))).any(-1)
    assert int(differ.sum()) <= 0.01 * differ.numel(), int(differ.sum())
    same = ~differ
    close(got.cpu()[same], want[same], rtol=5e-2)


@pytest.mark.cuda
def test_moe_two_card_runs_equal_bit_for_bit(dev):
    cfg, mp, x = published_width_moe(dev)
    card = copy.deepcopy(mp).to(dev)
    with torch.inference_mode():
        a = moe_ffn(card, cfg, x.to(dev))
        b = moe_ffn(card, cfg, x.to(dev))
    assert torch.equal(a, b)
