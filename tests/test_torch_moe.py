"""The MoE feed-forward in the port against the reference's, on the CPU.

The reference's parameters (``smoke-mla-moe``'s first MoE layer at
PRNGKey(0); 8 experts, top-2, one shared expert) cross through
``interop.lm_params_from_reference``. Checked:

- ``moe_ffn`` against the reference's at 16 and 64 tokens (capacity 5 and
  20): float32 within 1e-5 of the output's largest element;
- a bf16 case with a forced tie at the threshold: three experts' router
  columns equal and dominant, so every token selects three experts (top_k
  2) in the port and in the reference alike; the output within 3e-2 of
  its largest (bf16 products rounded in other orders; 6.5e-3 seen);
- capacity drops: 8 tokens (capacity 2) all routed to expert 0:
  ``capacity_drops`` counts the routed and dropped pairs as a count from
  the reference's probabilities does, and the output equals the
  reference's within 1e-5;
- the expert-major add order: ``_scatter_add`` equals the reference's
  ``out.at[idx].add`` bit for bit in bf16 on values where the order
  decides the rounding (1 + 2^-8 + 2^-8 is 1 in expert order and 1 +
  2^-7 the other way);
- the expert-parallel branch on a (1, 4) mesh of the CPU equals the one-
  device result within 1e-6 of its largest (only the sums' order
  differs);
- ``router_aux_loss`` within 1e-6 relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.archs.base import get_arch as ref_get_arch
from repro.distributed.meshinfo import single_device_meshinfo
from repro.models.transformer import model as ref_tm
from repro.models.transformer import moe as ref_moe
from repro_torch.distributed import MeshInfo
from repro_torch.interop import lm_params_from_reference
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models.transformer.moe import (
    _scatter_add,
    capacity,
    capacity_drops,
    moe_ffn,
    router_aux_loss,
)
from test_torch_lm import close, port_cfg
from test_torch_mla import normal, to_torch
from test_torch_parity_world import torch_threads  # noqa: F401 (autouse fixture)

MI = single_device_meshinfo()


def setup(dtype=jnp.float32, edit=None):
    """(ref_cfg, the reference's MoE params, cfg, the port's MoE);
    ``edit(params)`` may change the reference's tree before it crosses."""
    ref_cfg = dataclasses.replace(ref_get_arch("smoke-mla-moe").cfg, param_dtype=dtype,
                                  compute_dtype=dtype)
    params = jax.tree.map(np.asarray, ref_tm.init_params(jax.random.PRNGKey(0), ref_cfg))
    params = jax.tree.map(np.array, params)
    if edit is not None:
        edit(params["moe_layers"]["ffn"])
    cfg = port_cfg(ref_cfg)
    model = lm_params_from_reference(params, cfg, device="cpu")
    model.requires_grad_(False)
    ref_mp = jax.tree.map(lambda a: a[0], params["moe_layers"])["ffn"]
    return ref_cfg, ref_mp, cfg, model.moe_layers[0].ffn


def ref_ffn(ref_cfg, ref_mp, x):
    return jax.jit(lambda p, x: ref_moe.moe_ffn(p, ref_cfg, MI, x))(ref_mp, x)


@pytest.mark.parametrize("b,s", [(2, 8), (4, 16)])
def test_moe_ffn_matches_reference(b, s):
    ref_cfg, ref_mp, cfg, mp = setup()
    assert capacity(cfg, b * s, cfg.n_experts) == {16: 5, 64: 20}[b * s]
    x = normal((b, s, cfg.d_model), 1)
    got = moe_ffn(mp, cfg, torch.from_numpy(x))
    assert got.shape == x.shape and got.dtype == torch.float32
    close(got.numpy(), ref_ffn(ref_cfg, ref_mp, x))


def test_bf16_tie_at_threshold_selects_more_than_top_k():
    d = 64
    u = normal((d,), 2)
    u /= np.linalg.norm(u)

    def tie(ffn):  # experts 0, 1, 2 share one dominant router column
        ffn["router"]["w"][:, :, :3] = 5.0 * u[None, :, None]

    ref_cfg, ref_mp, cfg, mp = setup(jnp.bfloat16, tie)
    assert mp.router.weight.dtype == torch.float32
    x = (normal((2, 8, d), 3) + 3.0 * u).astype(jnp.bfloat16)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x, jnp.float32) @ ref_mp["router"]["w"]
                                      ).astype(jnp.bfloat16), np.float32).reshape(16, -1)
    thresh = -np.sort(-probs, axis=-1)[:, cfg.top_k - 1 : cfg.top_k]
    assert ((probs >= thresh).sum(-1) == 3).all()
    routed, _ = capacity_drops(mp, cfg, to_torch(x))
    assert routed == 3 * 16
    got = moe_ffn(mp, cfg, to_torch(x)).float().numpy()
    close(got, np.asarray(ref_ffn(ref_cfg, ref_mp, x), np.float32), rtol=3e-2)


def test_capacity_drops_match_the_reference():
    d = 64
    u = normal((d,), 4)
    u /= np.linalg.norm(u)

    def skew(ffn):  # expert 0 first for every token
        ffn["router"]["w"][:, :, 0] = 5.0 * u[None]

    ref_cfg, ref_mp, cfg, mp = setup(edit=skew)
    x = normal((1, 8, d), 5) + 3.0 * u
    t, e = 8, cfg.n_experts
    cap = capacity(cfg, t, e)
    assert cap == 2
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x) @ ref_mp["router"]["w"])).reshape(t, e)
    thresh = -np.sort(-probs, axis=-1)[:, cfg.top_k - 1 : cfg.top_k]
    per_expert = (probs >= thresh).sum(0)
    assert per_expert[0] == t
    want = (int(per_expert.sum()), int((per_expert - np.minimum(per_expert, cap)).sum()))
    assert capacity_drops(mp, cfg, torch.from_numpy(x)) == want and want[1] >= t - cap
    close(moe_ffn(mp, cfg, torch.from_numpy(x)).numpy(), ref_ffn(ref_cfg, ref_mp, x))


def test_scatter_add_is_expert_major_like_the_reference():
    small = 2.0 ** -8
    idx = np.array([[0, 1], [0, 2], [0, 1]], np.int32)  # 3 experts, C = 2
    vals = np.zeros((3, 2, 4), np.float32)
    vals[0, 0], vals[1, 0], vals[2, 0] = 1.0, small, small  # token 0: 1, then two halves
    vals[0, 1], vals[1, 1], vals[2, 1] = small, 3.0, 1.0  # tokens 1 and 2
    y = vals.astype(jnp.bfloat16)
    want = np.asarray(jnp.zeros((3, 4), jnp.bfloat16).at[idx.reshape(-1)].add(
        jnp.asarray(y).reshape(-1, 4), mode="drop"), np.float32)
    got = _scatter_add(torch.from_numpy(idx).long(), to_torch(y), 3)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert want[0, 0] == 1.0  # expert order; small values first would give 1 + 2^-7
    assert float(torch.tensor(small, dtype=torch.bfloat16) * 2 + 1) == 1.0 + 2.0 ** -7


def test_expert_parallel_equals_one_device():
    _, _, cfg, mp = setup()
    x = torch.from_numpy(normal((2, 8, cfg.d_model), 6))
    mi = MeshInfo(mesh=make_test_mesh(4, model=4, device="cpu"))
    want = moe_ffn(mp, cfg, x)
    close(moe_ffn(mp, cfg, x, mi).numpy(), want.numpy(), rtol=1e-6)
    close(mp(x, mi).numpy(), want.numpy(), rtol=1e-6)


def test_router_aux_loss_matches_reference():
    ref_cfg, ref_mp, cfg, mp = setup()
    x = normal((2, 8, cfg.d_model), 7)
    want = float(jax.jit(lambda p, x: ref_moe.router_aux_loss(p, ref_cfg, x))(ref_mp, x))
    got = router_aux_loss(mp, cfg, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
