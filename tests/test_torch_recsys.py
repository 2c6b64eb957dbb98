"""The port's two-tower serving path against the reference's, on the CPU.

The reference's two-tower model runs jitted on one CPU device
(``single_device_meshinfo``); its parameters cross into the port through
``interop.two_tower_params_from_reference``. Checked at the smoke
two-tower config and at the published widths of two-tower-retrieval
(dim 256, towers 1024-512-256, history 50) with a vocab of 1,024 rows:

- ``two_tower_batch`` equals the reference's bit for bit (numpy draws);
- the user and item towers within 1e-5 abs (the products add in another
  order), the serve_p99 / serve_bulk scores within 1e-5;
- retrieval_cand's top-k equal to the reference's, ties included: the
  candidates hold duplicated rows, whose equal scores come lower index
  first in both (``jax.lax.top_k``'s order).

Then ``examples/constrained_serving.py`` at n = 2,000, d = 32: the port's
AIRSHIP walk against the reference's on the same item-tower corpus, graph
and user-tower queries, recall@10 within 0.02, every returned id in its
category.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch as rt
from repro.archs.recsys import RECSYS_SHAPES as REF_SHAPES
from repro.configs.other_configs import smoke_recsys
from repro.configs.other_configs import two_tower_retrieval as ref_two_tower_retrieval
from repro.core import SearchParams as RefParams
from repro.core import constrained_search as ref_search
from repro.core import equal_constraint as ref_equal
from repro.core import exact_constrained_search as ref_exact
from repro.core import recall as ref_recall
from repro.core.types import Corpus as RefCorpus
from repro.data.pipeline import two_tower_batch as ref_batch
from repro.distributed.meshinfo import single_device_meshinfo
from repro.graph.index import build_index as ref_build_index
from repro.models.recsys import models as rs
from repro_torch.archs.recsys import RECSYS_SHAPES, serve_fn, serve_sasrec, shape_batch
from repro_torch.configs import SMOKE_RECSYS_SHAPES, smoke_two_tower, two_tower_retrieval
from repro_torch.data import two_tower_batch
from repro_torch.interop import from_reference_arrays, two_tower_params_from_reference
from repro_torch.models.recsys import RecsysConfig, stable_topk
from test_torch_parity_world import torch_threads  # noqa: F401 (autouse fixture)

MI = single_device_meshinfo()
PUBLISHED_SMALL = dict(item_vocab=1024, user_vocab=1024)  # published widths, vocab cut
B_PUBLISHED = 8


def port_cfg(ref_cfg):
    """The port's RecsysConfig with the reference config's fields."""
    fields = {f.name: getattr(ref_cfg, f.name) for f in dataclasses.fields(ref_cfg)
              if f.name not in ("param_dtype", "compute_dtype")}
    return RecsysConfig(**fields)


@functools.lru_cache(maxsize=None)
def world(which):
    """(ref cfg, port cfg, ref params, port model, batch size)."""
    if which == "smoke":
        ref_cfg, b = smoke_recsys("two_tower").cfg, SMOKE_RECSYS_SHAPES["serve_p99"]["batch"]
    else:
        ref_cfg = dataclasses.replace(ref_two_tower_retrieval().cfg, **PUBLISHED_SMALL)
        b = B_PUBLISHED
    params = rs.two_tower_init(jax.random.PRNGKey(0), ref_cfg)
    cfg = port_cfg(ref_cfg)
    model = two_tower_params_from_reference(jax.tree_util.tree_map(np.asarray, params), cfg,
                                            device="cpu")
    model.requires_grad_(False)  # serving: no autograd graph (the model is trainable)
    return ref_cfg, cfg, params, model, b


def torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def test_configs_match_reference():
    assert port_cfg(ref_two_tower_retrieval().cfg) == two_tower_retrieval()
    assert port_cfg(smoke_recsys("two_tower").cfg) == smoke_two_tower()
    assert RECSYS_SHAPES == REF_SHAPES
    assert SMOKE_RECSYS_SHAPES == smoke_recsys("two_tower").shapes
    # train_batch is a cell of its own (RecsysArch.make_cell), not a serve
    # function; SASRec serves through its own function; a model the recsys
    # family does not have is refused.
    with pytest.raises(ValueError, match="train shape"):
        serve_fn(two_tower_retrieval(), "train_batch")
    sasrec = dataclasses.replace(two_tower_retrieval(), model="sasrec")
    assert serve_fn(sasrec, "serve_p99") is serve_sasrec
    gnn = dataclasses.replace(two_tower_retrieval(), model="gnn")
    with pytest.raises(ValueError, match="no recsys model"):
        serve_fn(gnn, "serve_p99")


@pytest.mark.parametrize("seed,step,batch,hist", [(0, 0, 8, 5), (3, 17, 64, 50), (1, 2, 1, 1)])
def test_two_tower_batch_bit_for_bit(seed, step, batch, hist):
    want = ref_batch(seed, step, batch, 300, 500, hist)
    got = two_tower_batch(seed, step, batch, 300, 500, hist, device="cpu")
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == torch.int32
        assert np.array_equal(got[k].numpy(), np.asarray(v)), k
    if batch * hist >= 100:  # about 30% padding
        assert 0.2 < float((got["hist"] < 0).float().mean()) < 0.4


@pytest.mark.parametrize("which", ["smoke", "published"])
def test_towers_and_serve_scores_match_reference(which):
    ref_cfg, cfg, params, model, b = world(which)
    batch = ref_batch(5, 1, b, ref_cfg.user_vocab, ref_cfg.item_vocab, ref_cfg.hist_len)
    tb = torch_batch(batch)
    # The history bag: the model's take + mask + sum against the port's.
    want_bag = np.asarray(jax.jit(rs.embedding_bag_sum)(params["item_emb"], batch["hist"]))
    got_bag = rt.models.recsys.embedding_bag_sum(model.item_emb, tb["hist"]).numpy()
    np.testing.assert_allclose(got_bag, want_bag, rtol=0, atol=1e-6)
    u_ref = np.asarray(jax.jit(lambda p, x: rs.two_tower_user(p, ref_cfg, MI, x))(params, batch))
    v_ref = np.asarray(jax.jit(lambda p, i: rs.two_tower_item(p, ref_cfg, MI, i))(
        params, batch["item_id"]))
    with torch.inference_mode():
        u, v = model.user(tb).numpy(), model.item(tb["item_id"]).numpy()
    assert u.shape == (b, cfg.tower_mlp[-1]) and v.shape == u.shape
    np.testing.assert_allclose(u, u_ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(v, v_ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(u, axis=-1), 1.0, atol=1e-5)
    # serve_p99 / serve_bulk: sum(user . item) per row.
    want = np.sum(u_ref * v_ref, axis=-1)
    got = serve_fn(cfg, "serve_p99")(model, tb).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("which", ["smoke", "published"])
def test_retrieval_cand_topk_matches_reference_with_ties(which):
    ref_cfg, cfg, params, model, _ = world(which)
    n_cand = SMOKE_RECSYS_SHAPES["retrieval_cand"]["n_candidates"]
    item = jax.jit(lambda p, i: rs.two_tower_item(p, ref_cfg, MI, i))
    cand = np.array(item(params, jnp.arange(n_cand, dtype=jnp.int32)))
    cand[n_cand // 2 : n_cand // 2 + 40] = cand[:40]  # duplicated rows: exact ties
    batch = ref_batch(9, 0, 1, ref_cfg.user_vocab, ref_cfg.item_vocab, ref_cfg.hist_len)
    del batch["item_id"]
    ref = jax.jit(lambda p, x: rs.two_tower_score_candidates(p, ref_cfg, MI, x))
    top_ref, idx_ref = (np.asarray(a) for a in ref(params, dict(batch, candidates=cand)))
    tb = shape_batch(cfg, "retrieval_cand", 9, 0, shapes=SMOKE_RECSYS_SHAPES,
                     candidates=torch.from_numpy(cand), device="cpu")
    assert torch.equal(tb["hist"], torch.from_numpy(np.array(batch["hist"])))
    top, idx = serve_fn(cfg, "retrieval_cand", SMOKE_RECSYS_SHAPES)(model, tb)
    assert idx.dtype == torch.int32 and idx.shape == (1, min(100, n_cand))
    np.testing.assert_allclose(top.numpy(), top_ref, rtol=0, atol=1e-5)
    assert np.array_equal(idx.numpy(), idx_ref)
    # Both lists hold tied duplicates, each pair lower index first.
    pos = {int(i): p for p, i in enumerate(idx_ref[0])}
    pairs = [(pos[i], pos[i + n_cand // 2]) for i in range(40) if i in pos]
    assert pairs and all(a + 1 == b for a, b in pairs)


def test_stable_topk_keeps_lax_top_k_tie_order():
    rng = np.random.default_rng(4)
    scores = rng.integers(-3, 4, size=(6, 300)).astype(np.float32)  # many exact ties
    want_v, want_i = jax.lax.top_k(jnp.asarray(scores), 100)
    got_v, got_i = stable_topk(torch.from_numpy(scores), 100)
    assert np.array_equal(got_v.numpy(), np.asarray(want_v))
    assert np.array_equal(got_i.numpy(), np.asarray(want_i))


@functools.lru_cache(maxsize=1)
def serving_world():
    """examples/constrained_serving.py at n = 2,000 items, d = 32."""
    ref_cfg = rs.RecsysConfig(name="demo-two-tower", model="two_tower", embed_dim=32,
                              tower_mlp=(64, 32), item_vocab=2_000, user_vocab=500, hist_len=8)
    params = rs.two_tower_init(jax.random.PRNGKey(0), ref_cfg)
    n_items, nq = 2_000, 16
    item_emb = jax.jit(lambda p, i: rs.two_tower_item(p, ref_cfg, MI, i))(
        params, jnp.arange(n_items, dtype=jnp.int32))
    categories = jax.random.randint(jax.random.PRNGKey(1), (n_items,), 0, 10).astype(jnp.int32)
    corpus = RefCorpus(vectors=item_emb, labels=categories)
    graph = ref_build_index(jax.random.PRNGKey(2), corpus, degree=16, sample_size=512)
    batch = dict(user_id=jax.random.randint(jax.random.PRNGKey(3), (nq,), 0, 500),
                 hist=jax.random.randint(jax.random.PRNGKey(4), (nq, 8), -1, n_items))
    queries = jax.jit(lambda p, x: rs.two_tower_user(p, ref_cfg, MI, x))(params, batch)
    want = jax.random.randint(jax.random.PRNGKey(5), (nq,), 0, 10)
    cons = ref_equal(want, 10)
    _, true_ids = ref_exact(corpus, queries, cons, k=10)
    model = two_tower_params_from_reference(jax.tree_util.tree_map(np.asarray, params),
                                            port_cfg(ref_cfg), device="cpu")
    return dict(ref_cfg=ref_cfg, corpus=corpus, graph=graph, queries=queries, cons=cons,
                true_ids=true_ids, want=np.asarray(want), batch=batch, model=model,
                categories=np.asarray(categories))


def test_constrained_retrieval_over_item_tower_matches_reference():
    w = serving_world()
    corpus, graph = w["corpus"], w["graph"]
    sp = dict(mode="prefer", k=10, ef_result=128, n_start=32, max_iters=800)
    ref = ref_search(corpus, graph, w["queries"], w["cons"], RefParams(**sp))
    t_corpus, t_graph, t_cons = from_reference_arrays(
        vectors=np.asarray(corpus.vectors), labels=np.asarray(corpus.labels),
        neighbors=np.asarray(graph.neighbors), sample_ids=np.asarray(graph.sample_ids),
        entry_point=np.asarray(graph.entry_point), label_words=np.asarray(w["cons"].words),
        device="cpu")
    # The port's own towers give the same corpus and queries within 1e-5.
    with torch.inference_mode():
        items = w["model"].item(torch.arange(t_corpus.n, dtype=torch.int32))
        users = w["model"].user(torch_batch(w["batch"]))
    np.testing.assert_allclose(items.numpy(), np.asarray(corpus.vectors), rtol=0, atol=1e-5)
    np.testing.assert_allclose(users.numpy(), np.asarray(w["queries"]), rtol=0, atol=1e-5)
    port = rt.constrained_search(t_corpus, t_graph, torch.from_numpy(np.array(w["queries"])),
                                 t_cons, rt.SearchParams(**sp))
    ids = port.ids.numpy()
    assert ids.shape == (len(w["want"]), 10)
    hit = ids >= 0
    assert hit.any() and (w["categories"][ids[hit]] == np.broadcast_to(
        w["want"][:, None], ids.shape)[hit]).all()
    ref_r = float(ref_recall(ref.ids, w["true_ids"]))
    port_r = float(ref_recall(jnp.asarray(ids), w["true_ids"]))
    assert abs(port_r - ref_r) <= 0.02, (port_r, ref_r)
    assert port_r >= 0.5
