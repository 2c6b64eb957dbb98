"""The port's building blocks, recsys model identities, registry and
distances against the reference, on the CPU.

- ``tests/test_models.py``'s recsys checks, ported (one parametrised
  test): the two-tower in-batch softmax falls after a small gradient step,
  DeepFM's FM term equals the pairwise-dot double sum (1e-5 relative, and
  1e-6 of the squared field sum, since the trick cancels), and
  DLRM's top MLP takes F + 1 choose 2 interactions plus the bottom output.
- ``Dense``, ``MLP`` (tanh, no bias, final activation), ``RMSNorm``,
  ``LayerNorm`` and ``Embedding`` on the reference's weights against its
  ``*_apply`` (products within 1e-6 relative; the norms' means and rsqrt
  within 2e-6), and each ``init_`` draws the reference's law.
- The configs and the registry: the reference's names, the port's cells,
  and the names it lacks raising with their ROADMAP item.
- ``squared_l2_one_to_many``, ``neg_inner_product`` and
  ``cosine_distance`` within 1e-6 relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import distances as ref_dist
from repro.configs import ASSIGNED
from repro.configs import other_configs as ref_oc
from repro.distributed.meshinfo import single_device_meshinfo
from repro.models.common import modules as ref_mod
from repro.models.recsys import models as rs
from repro_torch import configs
from repro_torch.archs import get_arch, list_archs
from repro_torch.archs.recsys import RecsysArch
from repro_torch.common import cosine_distance, neg_inner_product, squared_l2_one_to_many
from repro_torch.models.common.modules import MLP, Dense, Embedding, LayerNorm, RMSNorm
from repro_torch.models.recsys import (
    RecsysConfig,
    deepfm_init,
    dlrm_init,
    two_tower_init,
    two_tower_loss,
)
from repro_torch.models.recsys.models import _lookup
from repro_torch.train import reference_layout
from test_torch_parity_world import torch_threads  # noqa: F401 (autouse fixture)

MI = single_device_meshinfo()


def load(module, tree):
    """The reference's leaves into ``module``'s parameters (both in the
    reference's leaf order and layout)."""
    views = reference_layout(module)
    leaves = jax.tree.leaves(tree)
    assert len(leaves) == len(views)
    with torch.no_grad():
        for view, leaf in zip(views.values(), leaves):
            view.copy_(torch.from_numpy(np.array(leaf)))
    return module


@pytest.mark.parametrize("case", ["two_tower_learns", "fm_identity", "dlrm_interaction_count"])
def test_recsys_model_identities(case):
    gen = torch.Generator().manual_seed(0)
    if case == "two_tower_learns":
        cfg = RecsysConfig(name="tt", model="two_tower", embed_dim=8, tower_mlp=(16, 4),
                           item_vocab=64, user_vocab=64, hist_len=4)
        model = two_tower_init(gen, cfg, device="cpu")
        batch = dict(user_id=torch.arange(8, dtype=torch.int32),
                     hist=torch.randint(-1, 64, (8, 4), generator=gen, dtype=torch.int32),
                     item_id=torch.arange(8, dtype=torch.int32))
        l0, _ = two_tower_loss(model, batch)
        params = dict(model.named_parameters())
        grads = torch.autograd.grad(l0, list(params.values()))
        with torch.no_grad():
            for p, g in zip(params.values(), grads):
                p.sub_(1e-5 * g)  # L2-normalised towers at 0.02 init: a tiny step
        assert float(two_tower_loss(model, batch)[0].detach()) < float(l0.detach())
    elif case == "fm_identity":
        cfg = RecsysConfig(name="fm", model="deepfm", embed_dim=4, vocab_sizes=(10,) * 5,
                           mlp=(8,))
        model = deepfm_init(gen, cfg, device="cpu")
        ids = torch.randint(0, 10, (3, 5), generator=gen, dtype=torch.int32)
        with torch.no_grad():
            emb = _lookup(model.tables, ids)
            s = emb.sum(1)
            fm_trick = 0.5 * (s * s - (emb * emb).sum(1)).sum(-1)
            pair = sum((emb[:, i] * emb[:, j]).sum(-1)
                       for i in range(5) for j in range(i + 1, 5))
        # The trick subtracts two sums of squares: its error scales with them.
        scale = float((s * s).sum(-1).abs().max())
        np.testing.assert_allclose(fm_trick.numpy(), pair.numpy(), rtol=1e-5, atol=1e-6 * scale)
    else:
        cfg = RecsysConfig(name="d", model="dlrm", embed_dim=8, vocab_sizes=(20, 20),
                           n_dense=4, bot_mlp=(8, 8), top_mlp=(8, 1))
        model = dlrm_init(gen, cfg, device="cpu")
        batch = dict(dense=torch.ones((2, 4)), sparse=torch.zeros((2, 2), dtype=torch.int32))
        assert model(batch).shape == (2,)
        # top MLP input dim = 3 fields choose 2 = 3 interactions + bot output 8
        assert model.top.layers[0].in_features == 3 + 8
        ref = rs.dlrm_init(jax.random.PRNGKey(0), rs.RecsysConfig(**{
            f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name not in ("param_dtype", "compute_dtype")}))
        assert ref["top"]["layers"][0]["w"].shape == (model.top.layers[0].in_features, 8)


@pytest.mark.parametrize("name", ["dense", "mlp", "rmsnorm", "layernorm", "embedding"])
def test_modules_match_reference(name):
    rng = np.random.default_rng(1)
    key = jax.random.PRNGKey(4)
    x = (rng.standard_normal((6, 12)) * 2.0 + 3.0).astype(np.float32)
    gen = torch.Generator().manual_seed(2)
    tol = dict(rtol=1e-6, atol=1e-6)
    if name == "dense":
        tree = ref_mod.dense_init(key, 12, 5)
        want = ref_mod.dense_apply(tree, jnp.asarray(x))
        module = Dense(12, 5, device="cpu")
        module.init_(gen)
        assert float(module.weight.detach().abs().max()) <= 1 / np.sqrt(12)
    elif name == "mlp":
        tree = ref_mod.mlp_init(key, (12, 7, 3), bias=False)
        want = ref_mod.mlp_apply(tree, jnp.asarray(x), act=jax.nn.tanh, final_act=True)
        module = MLP((12, 7, 3), final_act=True, bias=False, act=torch.tanh, device="cpu")
        assert all(layer.bias is None for layer in module.layers)
        with_bias = MLP((12, 7), device="cpu").init_(gen)
        assert not with_bias.layers[0].bias.any()
    elif name in ("rmsnorm", "layernorm"):
        init = ref_mod.rmsnorm_init if name == "rmsnorm" else ref_mod.layernorm_init
        apply = ref_mod.rmsnorm_apply if name == "rmsnorm" else ref_mod.layernorm_apply
        tree = jax.tree.map(lambda a: a + 0.5 * jax.random.normal(key, a.shape), init(12))
        want = jax.jit(apply)(tree, jnp.asarray(x))
        module = (RMSNorm if name == "rmsnorm" else LayerNorm)(12, device="cpu")
        assert float(module.scale.detach().sum()) == 12.0
        tol = dict(rtol=2e-6, atol=2e-6)
    else:
        tree = ref_mod.embedding_init(key, 50, 8)
        ids = rng.integers(0, 50, size=(4, 3)).astype(np.int32)
        want = ref_mod.embedding_apply(tree, jnp.asarray(ids))
        module = Embedding(50, 8, device="cpu")
        module.init_(gen)
        assert 0.015 < float(module.table.detach().std()) < 0.025
        x = ids
    got = load(module, tree)(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def test_configs_and_registry_match_reference():
    def port_cfg(ref_cfg):
        return RecsysConfig(**{f.name: getattr(ref_cfg, f.name)
                               for f in dataclasses.fields(ref_cfg)
                               if f.name not in ("param_dtype", "compute_dtype")})

    assert configs.CRITEO_VOCABS == ref_oc.CRITEO_VOCABS
    assert configs.DEEPFM_VOCABS == ref_oc.DEEPFM_VOCABS
    pairs = {"dlrm-mlperf": ref_oc.dlrm_mlperf(), "deepfm": ref_oc.deepfm(),
             "two-tower-retrieval": ref_oc.two_tower_retrieval(),
             "sasrec": ref_oc.sasrec(),
             "smoke-dlrm": ref_oc.smoke_recsys("dlrm"),
             "smoke-deepfm": ref_oc.smoke_recsys("deepfm"),
             "smoke-sasrec": ref_oc.smoke_recsys("sasrec"),
             "smoke-two-tower": ref_oc.smoke_recsys("two_tower")}
    # the LM archs, compared field for field in test_torch_lm.py and
    # test_torch_lm_deepseek.py
    lm_names = {"granite-3-2b", "command-r-35b", "command-r-plus-104b", "smoke-gqa",
                "deepseek-v2-236b", "deepseek-v3-671b", "smoke-mla-moe"}
    # the MACE archs, compared in test_torch_gnn_arch.py
    gnn_names = {"mace", "smoke-mace"}
    assert list_archs() == sorted(set(pairs) | lm_names | gnn_names)
    for name, ref_arch in pairs.items():
        arch = get_arch(name)
        assert arch.cfg == port_cfg(ref_arch.cfg) and arch.shapes == ref_arch.shapes, name
        assert arch.shape_names() == ref_arch.shape_names()
    for name in set(ASSIGNED) | {"smoke-mla-moe", "smoke-mace", "airship-sift1m"}:
        if name in pairs or name in lm_names or name in gnn_names:
            continue
        with pytest.raises(NotImplementedError, match="ROADMAP item 14e"):
            get_arch(name)
    assert get_arch("mace").family == "gnn"
    with pytest.raises(KeyError):
        get_arch("no-such-arch")
    gnn = RecsysConfig(name="g", model="gnn", embed_dim=4)
    with pytest.raises(ValueError, match="no recsys model"):
        RecsysArch(gnn).make_cell("train_batch")


def test_distances_match_reference():
    rng = np.random.default_rng(5)
    a = rng.standard_normal((7, 16)).astype(np.float32)
    b = rng.standard_normal((9, 16)).astype(np.float32)
    q = a[0]
    cases = [(squared_l2_one_to_many(torch.from_numpy(q), torch.from_numpy(b)),
              ref_dist.squared_l2_one_to_many(q, b)),
             (neg_inner_product(torch.from_numpy(a), torch.from_numpy(b)),
              ref_dist.neg_inner_product(a, b)),
             (cosine_distance(torch.from_numpy(a), torch.from_numpy(b)),
              ref_dist.cosine_distance(a, b))]
    for got, want in cases:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
