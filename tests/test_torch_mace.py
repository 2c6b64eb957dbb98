"""MACE in the port against the reference's, on the CPU (float32).

The reference's parameters cross through ``interop.mace_params_from_reference``
(PRNGKey(0)); graphs come from the reference's and the port's
``gnn_batch`` (equal arrays, tests/test_torch_gnn_arch.py). Checked, on
each of smoke-mace's four cells (its per-cell ``d_feat``; float32 here,
the bf16 of ogb_products is held on the card):

- the energy within 1e-5 relative, and the forces within 1e-5 of their
  largest at every node without a self-loop edge;
- at a node with a self-loop the reference's force is rounding noise of a
  1e9-scale term that cancels (``mace.edge_geometry``): permuting the edge
  list moves it by up to ~8e-3 on forces of ~1e-2, while the port's,
  which takes that derivative as zero, moves by less than 1e-7;
- so the loss, its terms and every parameter gradient (1e-4 of each
  leaf's largest) are held on the cell's batch with its self-loop edges
  padded out (-1) in both packages;
- rotation and translation invariance (energy within 1e-3, forces
  rotating with the frame within 5e-3, the reference test's bounds);
- the dst-partitioned loss equal to the simple loss over 1, 2 and 4
  shards (1e-5 relative), and to the reference's on one shard (self-loops
  padded out, as above);
- the sampler with the reference's draws: ``nodes`` / ``senders`` /
  ``receivers`` equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.spatial.transform as sst
import torch

from repro.archs.base import get_arch as ref_get_arch
from repro.data import pipeline as ref_pipe
from repro.distributed.meshinfo import single_device_meshinfo
from repro.models.gnn import distributed as ref_dist
from repro.models.gnn import mace as ref_gm
from repro.models.gnn import sampler as ref_sampler
from repro_torch.archs import get_arch
from repro_torch.archs.gnn import graph_size
from repro_torch.data import gnn_batch
from repro_torch.distributed import MeshInfo
from repro_torch.interop import mace_params_from_reference
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models.gnn import mace as gm
from repro_torch.models.gnn.distributed import dst_partitioned_loss, partition_by_destination
from repro_torch.models.gnn.sampler import sample_subgraph, subgraph_sizes
from repro_torch.train import gradients
from test_torch_lm import close
from test_torch_lm_train import by_port_name
from test_torch_parity_world import torch_threads  # noqa: F401 (autouse fixture)

MI = single_device_meshinfo()
SHAPES = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")


def cell(shape):
    """(reference cfg, port cfg, reference params, port model, the shape) of
    a smoke-mace cell, in float32."""
    arch = get_arch("smoke-mace")
    sh = arch.shapes[shape]
    cfg = dataclasses.replace(arch.cfg_for(shape), compute_dtype=torch.float32)
    ref_cfg = dataclasses.replace(ref_get_arch("smoke-mace")._cfg_for(sh),
                                  compute_dtype=jnp.float32)
    params = ref_gm.init_params(jax.random.PRNGKey(0), ref_cfg)
    model = mace_params_from_reference(jax.tree.map(np.asarray, params), cfg, device="cpu")
    return ref_cfg, cfg, params, model, sh


def batches(cfg, sh, pad_loops=False):
    n, e = graph_size(sh)
    ref = ref_pipe.gnn_batch(0, 0, n, e, cfg.n_species, cfg.d_feat, sh.get("batch", 1))
    port = gnn_batch(0, 0, n, e, cfg.n_species, cfg.d_feat, sh.get("batch", 1), device="cpu")
    if pad_loops:
        loop = np.asarray(ref["senders"]) == np.asarray(ref["receivers"])
        s = np.where(loop, -1, np.asarray(ref["senders"])).astype(np.int32)
        ref = dict(ref, senders=jnp.asarray(s))
        port = dict(port, senders=torch.from_numpy(s))
    return ref, port


def ref_loss(ref_cfg, sh):
    def f(p, b):
        if sh.get("batch", 1) > 1:
            b = dict(b, n_graphs=sh["batch"])
        return ref_gm.loss(p, ref_cfg, b)
    return f


@pytest.mark.parametrize("shape", SHAPES)
def test_energy_forces_loss_and_grads_match_reference(shape):
    ref_cfg, cfg, params, model, sh = cell(shape)
    ref_b, b = batches(cfg, sh)
    ref_b = {k: v for k, v in ref_b.items() if k != "n_graphs"}
    ng = sh.get("batch", 1)
    e_want = jax.jit(lambda p, bb: ref_gm.energy(p, ref_cfg, dict(bb, n_graphs=ng)
                                                 if ng > 1 else bb))(params, ref_b)
    with torch.no_grad():
        e_got = gm.energy(model, cfg, dict(b, n_graphs=ng) if ng > 1 else b)
    close(e_got.numpy(), e_want)
    _, f_want = jax.jit(lambda p, bb: ref_gm.energy_and_forces(
        p, ref_cfg, dict(bb, n_graphs=ng) if ng > 1 else bb))(params, ref_b)
    _, f_got = gm.energy_and_forces(model, cfg, dict(b, n_graphs=ng) if ng > 1 else b)
    s, r = b["senders"].numpy(), b["receivers"].numpy()
    clean = np.setdiff1d(np.arange(f_got.shape[0]), s[s == r])
    f_want = np.asarray(f_want)
    np.testing.assert_allclose(f_got.detach().numpy()[clean], f_want[clean], rtol=0,
                               atol=1e-5 * np.abs(f_want).max())

    ref_b, b = batches(cfg, sh, pad_loops=True)
    (want, ref_metrics), ref_g = jax.jit(jax.value_and_grad(ref_loss(ref_cfg, sh), has_aux=True))(
        params, {k: v for k, v in ref_b.items() if k != "n_graphs"})
    loss, metrics = gm.loss(model, cfg, dict(b, n_graphs=ng) if ng > 1 else b)
    for k in ref_metrics:
        close(metrics[k].detach().numpy(), ref_metrics[k])
    got, ref_g = gradients(model, loss), by_port_name(ref_g)
    assert set(got) == set(ref_g)
    for k, g in got.items():
        close(g.numpy(), ref_g[k], rtol=1e-4)


def test_reference_forces_at_self_loops_are_noise():
    ref_cfg, cfg, params, model, sh = cell("full_graph_sm")
    ref_b, b = batches(cfg, sh)
    s, r = b["senders"].numpy(), b["receivers"].numpy()
    loops = np.unique(s[s == r])
    assert loops.size
    perm = np.random.default_rng(5).permutation(s.shape[0])
    fn = jax.jit(lambda p, bb: ref_gm.energy_and_forces(p, ref_cfg, bb)[1])
    f_ref = np.asarray(fn(params, ref_b))
    f_ref_perm = np.asarray(fn(params, dict(ref_b, senders=ref_b["senders"][perm],
                                            receivers=ref_b["receivers"][perm])))
    f = gm.energy_and_forces(model, cfg, b)[1].detach()
    f_perm = gm.energy_and_forces(model, cfg, dict(b, senders=b["senders"][perm],
                                                   receivers=b["receivers"][perm]))[1].detach()
    assert np.abs(f_ref - f_ref_perm)[loops].max() > 0.1 * np.abs(f_ref).max()
    assert float((f - f_perm).abs().max()) < 1e-7


def test_rotation_translation_invariance():
    cfg = gm.MACEConfig(n_layers=2, d_hidden=12, n_rbf=4, n_species=4)
    model = gm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    r = np.random.default_rng(0)
    n, e = 18, 50
    batch = dict(positions=torch.from_numpy(r.normal(size=(n, 3)).astype(np.float32)),
                 senders=torch.from_numpy(r.integers(0, n, size=e).astype(np.int32)),
                 receivers=torch.from_numpy(r.integers(0, n, size=e).astype(np.int32)),
                 species=torch.from_numpy(r.integers(0, 4, size=n).astype(np.int32)))
    e1, f1 = gm.energy_and_forces(model, cfg, batch)
    rot = torch.from_numpy(sst.Rotation.random(random_state=1).as_matrix().astype(np.float32))
    e2, f2 = gm.energy_and_forces(model, cfg, dict(batch, positions=batch["positions"] @ rot.T
                                                   + 5.0))
    assert abs(float(e1.detach()) - float(e2.detach())) < 1e-3
    torch.testing.assert_close(f1 @ rot.T, f2, rtol=0, atol=5e-3)


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_dst_partitioned_equals_simple(n_shards):
    cfg = gm.MACEConfig(n_layers=2, d_hidden=8, n_rbf=4, n_species=4)
    ref_cfg = ref_gm.MACEConfig(n_layers=2, d_hidden=8, n_rbf=4, n_species=4)
    params = ref_gm.init_params(jax.random.PRNGKey(0), ref_cfg)
    model = mace_params_from_reference(jax.tree.map(np.asarray, params), cfg, device="cpu")
    r = np.random.default_rng(1)
    n, e = 16, 40
    arrays = dict(positions=r.normal(size=(n, 3)).astype(np.float32),
                  senders=r.integers(0, n, size=e).astype(np.int32),
                  receivers=r.integers(0, n, size=e).astype(np.int32),
                  species=r.integers(0, 4, size=n).astype(np.int32),
                  energy=np.asarray([0.7], np.float32), forces=np.zeros((n, 3), np.float32))
    batch = {k: torch.from_numpy(v) for k, v in arrays.items()}
    simple, _ = gm.loss(model, cfg, batch)
    mi = MeshInfo(make_test_mesh(n_shards, device="cpu"))
    part = partition_by_destination(batch, n_shards)
    assert part["senders"].shape[0] % n_shards == 0
    dst, metrics = dst_partitioned_loss(model, cfg, mi, part)
    close(dst.detach().numpy(), simple.detach().numpy())
    assert set(metrics) == {"loss", "e_loss", "f_loss"}
    if n_shards == 1:  # against the reference, its self-loops padded out in both
        s = arrays["senders"]
        arrays["senders"] = np.where(s == arrays["receivers"], -1, s).astype(np.int32)
        ref_b = {k: jnp.asarray(v) for k, v in arrays.items()}
        want, _ = ref_dist.dst_partitioned_loss(params, ref_cfg, MI,
                                                dict(ref_b, receivers_local=ref_b["receivers"]))
        batch = {k: torch.from_numpy(v) for k, v in arrays.items()}
        got, _ = dst_partitioned_loss(model, cfg, mi, partition_by_destination(batch, 1))
        close(got.detach().numpy(), want)


def test_sampler_with_reference_draws_gives_equal_ids():
    r = np.random.default_rng(3)
    n, m = 500, 4000
    rows = np.sort(r.integers(0, n, size=m))
    rows = rows[rows != 7]  # node 7 has no neighbours: it samples itself
    indptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=n))]).astype(np.int32)
    indices = r.integers(0, n, size=rows.shape[0]).astype(np.int32)
    seeds = np.asarray([0, 7, 3, 499, 250, 7], np.int32)
    fanouts = (5, 3)
    rng = jax.random.PRNGKey(11)
    want = ref_sampler.sample_subgraph(rng, jnp.asarray(indptr), jnp.asarray(indices),
                                       jnp.asarray(seeds), fanouts)
    sizes = [seeds.shape[0]]
    for f in fanouts:
        sizes.append(sizes[-1] * f)
    draws = [np.array(jax.random.randint(jax.random.fold_in(rng, li), (sizes[li], f), 0,
                                         1 << 30)) for li, f in enumerate(fanouts)]
    got = sample_subgraph(torch.from_numpy(indptr), torch.from_numpy(indices),
                          torch.from_numpy(seeds), fanouts,
                          draws=[torch.from_numpy(d) for d in draws])
    for k in ("nodes", "senders", "receivers"):
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    assert (got["nodes"].shape[0], got["senders"].shape[0]) == subgraph_sizes(6, fanouts)
    assert int(got["nodes"][6 + 5]) == 7  # the second seed's first draw
    free = sample_subgraph(torch.from_numpy(indptr), torch.from_numpy(indices),
                           torch.from_numpy(seeds), fanouts,
                           generator=torch.Generator().manual_seed(0))
    assert free["nodes"].shape == got["nodes"].shape
