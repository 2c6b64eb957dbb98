"""Scatter-search-merge on multi-shard meshes, port against reference.

The reference runs in a subprocess with 4 virtual host devices (jax fixes
its device count at its first initialisation, so this cannot run
in-process): ``make_distributed_search`` on (1, 4) and (2, 2) meshes, for
exact label, range, PQ and PQ-fused searches over an integer-valued world
(integer rows, queries and PQ codebooks: every distance and ADC sum exact
in float32), plus the two-tower ``two_phase_topk`` on the same meshes. It
writes its results to an npz. The port runs the same grids on the CPU (a
``DeviceMesh`` whose positions all hold the CPU) over the same arrays and
must equal them bit for bit: ids, dists and every stat. The subprocess has
its own 120 s timeout.
"""
import dataclasses
import functools
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.models.recsys import models as rs
from repro_torch import (
    Corpus,
    GraphIndex,
    LabelSetConstraint,
    PQIndex,
    RangeConstraint,
    SearchParams,
    make_distributed_search,
    shard_corpus_for_mesh,
)
from repro_torch.distributed import MeshInfo
from repro_torch.interop import two_tower_params_from_reference
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models.recsys.models import RecsysConfig, stable_topk
from test_torch_parity_world import torch_threads  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESHES = {"1x4": (1, 4), "2x2": (2, 2)}
KINDS = ("exact", "range", "pq", "pq_fused")
PARAMS = dict(mode="prefer", k=8, ef_result=24, ef_sat=24, ef_other=24, n_start=6,
              max_iters=300)
STATS = ("dist_evals", "hops", "visited", "iters", "beam_expansions")

SCRIPT = textwrap.dedent(
    """
    import dataclasses, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from repro.common.compat import set_mesh
    from repro.core import (RangeConstraint, SearchParams, equal_constraint,
                            make_distributed_search, shard_corpus_for_mesh)
    from repro.core.pq import PQIndex
    from repro.core.types import Corpus
    from repro.distributed.meshinfo import MeshInfo
    from repro.graph.index import build_partitioned_index
    from repro.models.recsys import models as rs

    assert len(jax.devices()) == 4
    out_path, params_kw = sys.argv[1], eval(sys.argv[2])
    rng = np.random.default_rng(0)
    n, d, L, b = 800, 8, 5, 16
    vec = rng.integers(-6, 7, size=(n, d)).astype(np.float32)
    lab = rng.integers(0, L, size=n).astype(np.int32)
    attrs = rng.random((n, 2)).astype(np.float32)
    q = rng.integers(-6, 7, size=(b, d)).astype(np.float32)
    qlab = rng.integers(0, L, size=b).astype(np.int32)
    lo = rng.random(b).astype(np.float32) * 0.5
    hi = lo + np.float32(0.4)
    m_sub, n_cent = 4, 16
    cb = rng.integers(-6, 7, size=(m_sub, n_cent, d // m_sub)).astype(np.float32)
    corpus = Corpus(vectors=jnp.asarray(vec), labels=jnp.asarray(lab), attrs=jnp.asarray(attrs))
    cons = equal_constraint(jnp.asarray(qlab), L)
    rcons = RangeConstraint(lo=jnp.asarray(lo), hi=jnp.asarray(hi), col=jnp.int32(1))
    params = SearchParams(**params_kw)
    out = dict(q=q, words=np.asarray(cons.words), lo=lo, hi=hi, cb=cb)
    cfg = rs.RecsysConfig(name="tt", model="two_tower", embed_dim=16, tower_mlp=(32, 8),
                          item_vocab=512, user_vocab=256, hist_len=4)
    p_tt = rs.two_tower_init(jax.random.PRNGKey(5), cfg)
    batch = dict(user_id=jnp.asarray(rng.integers(0, 256, size=8).astype(np.int32)),
                 hist=jnp.asarray(rng.integers(-1, 512, size=(8, 4)).astype(np.int32)),
                 candidates=jnp.asarray(rng.standard_normal((512, 8)).astype(np.float32)))
    for k in ("user_id", "hist", "candidates"):
        out["tt_" + k] = np.asarray(batch[k])
    for name, shape in (("1x4", (1, 4)), ("2x2", (2, 2))):
        mesh = jax.make_mesh(shape, ("data", "model"))
        corpus_p, graph_p = build_partitioned_index(
            jax.random.PRNGKey(1), corpus, n_shards=shape[1], degree=8,
            sample_size_per_shard=32)
        vp = np.asarray(corpus_p.vectors)
        codes = ((vp.reshape(n, m_sub, 1, -1) - cb[None]) ** 2).sum(-1).argmin(-1)
        pq = PQIndex(codebooks=jnp.asarray(cb), codes=jnp.asarray(codes.astype(np.int32)))
        out.update({f"{name}_{k}": v for k, v in dict(
            vec=vp, lab=np.asarray(corpus_p.labels), attrs=np.asarray(corpus_p.attrs),
            nbrs=np.asarray(graph_p.neighbors), sample=np.asarray(graph_p.sample_ids),
            entry=np.asarray(graph_p.entry_point), codes=np.asarray(pq.codes)).items()})
        kinds = {
            "exact": (params, type(cons), cons, None),
            "range": (params, RangeConstraint, rcons, None),
            "pq": (dataclasses.replace(params, approx="pq"), type(cons), cons, pq),
            "pq_fused": (dataclasses.replace(params, approx="pq", fuse_expand="on"),
                         type(cons), cons, pq),
        }
        corpus_s, graph_s = shard_corpus_for_mesh(corpus_p, graph_p, mesh)
        for kind, (prm, ctype, c, pqi) in kinds.items():
            search = make_distributed_search(mesh, prm, constraint_type=ctype)
            with set_mesh(mesh):
                res = search(corpus_s, graph_s, jnp.asarray(q), c, pqi)
            out[f"{name}_{kind}_ids"] = np.asarray(res.ids)
            out[f"{name}_{kind}_dists"] = np.asarray(res.dists)
            for f in ("dist_evals", "hops", "visited", "iters", "beam_expansions"):
                out[f"{name}_{kind}_{f}"] = np.asarray(getattr(res.stats, f))
        mi = MeshInfo(mesh=mesh)
        with set_mesh(mesh):
            t2, i2 = jax.jit(lambda p, bt: rs.two_tower_score_candidates(
                p, cfg, mi, bt, two_phase_topk=True))(p_tt, batch)
            u = jax.jit(lambda p, bt: rs.two_tower_user(p, cfg, mi, bt))(p_tt, batch)
        out[f"{name}_tt_top"], out[f"{name}_tt_ids"] = np.asarray(t2), np.asarray(i2)
        out[f"{name}_tt_u"] = np.asarray(u)
    np.savez(out_path, **out)
    print("MULTIDEV_REFERENCE_OK")
    """
)


@functools.lru_cache(maxsize=1)
def reference(tmp_dir: str):
    path = pathlib.Path(tmp_dir) / "multidev_reference.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(path), repr(PARAMS)],
                          capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "MULTIDEV_REFERENCE_OK" in proc.stdout
    return dict(np.load(path))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return reference(str(tmp_path_factory.mktemp("multidev")))


def _port_inputs(r, mesh_name):
    def t(key):
        return torch.from_numpy(r[f"{mesh_name}_{key}"])

    corpus = Corpus(vectors=t("vec"), labels=t("lab"), attrs=t("attrs"))
    graph = GraphIndex(neighbors=t("nbrs"), sample_ids=t("sample"), entry_point=t("entry"))
    cons = LabelSetConstraint(words=torch.from_numpy(r["words"].view(np.int32)))
    rcons = RangeConstraint(lo=torch.from_numpy(r["lo"]), hi=torch.from_numpy(r["hi"]), col=1)
    pq = PQIndex(codebooks=torch.from_numpy(r["cb"]), codes=t("codes"))
    return corpus, graph, torch.from_numpy(r["q"]), cons, rcons, pq


def _mesh(name):
    data, model = MESHES[name]
    return make_test_mesh(data * model, model=model, device="cpu")


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("kind", KINDS)
def test_mesh_search_equals_reference_bit_for_bit(ref, mesh_name, kind):
    """Exact / range / PQ / PQ-fused on (1, 4) and (2, 2): ids, dists and
    every stat equal the reference's on 4 host devices (tolerance: none)."""
    corpus, graph, q, cons, rcons, pq = _port_inputs(ref, mesh_name)
    mesh = _mesh(mesh_name)
    params = SearchParams(**PARAMS)
    ctype, c, pqi = LabelSetConstraint, cons, None
    if kind == "range":
        ctype, c = RangeConstraint, rcons
    elif kind.startswith("pq"):
        params = dataclasses.replace(params, approx="pq",
                                     fuse_expand="on" if kind == "pq_fused" else "auto")
        pqi = pq
    search = make_distributed_search(mesh, params, constraint_type=ctype)
    walls = []
    res = search(shard_corpus_for_mesh(corpus, graph, mesh), q, c, pqi, shard_walls=walls)
    data, model = MESHES[mesh_name]
    assert [(g, m) for g, m, _ in walls] == [(g, m) for g in range(data) for m in range(model)]
    key = f"{mesh_name}_{kind}"
    np.testing.assert_array_equal(res.ids.numpy(), ref[f"{key}_ids"])
    np.testing.assert_array_equal(res.dists.numpy(), ref[f"{key}_dists"])
    for field in STATS:
        np.testing.assert_array_equal(getattr(res.stats, field).numpy(), ref[f"{key}_{field}"],
                                      err_msg=field)
    assert (res.ids >= 0).any()


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_two_phase_topk_equals_reference(ref, mesh_name):
    """The two-tower ``two_phase_topk`` on (1, 4) and (2, 2) against the
    reference's: the ids bit for bit, and the scores bit for bit on the
    reference's own user rows (the towers' float products may differ in
    the last bit between the two packages: held to 1e-6 abs)."""
    ref_cfg = rs.RecsysConfig(name="tt", model="two_tower", embed_dim=16, tower_mlp=(32, 8),
                              item_vocab=512, user_vocab=256, hist_len=4)
    cfg = RecsysConfig(**{f.name: getattr(ref_cfg, f.name)
                          for f in dataclasses.fields(RecsysConfig)
                          if f.name not in ("param_dtype", "compute_dtype")})
    params = rs.two_tower_init(jax.random.PRNGKey(5), ref_cfg)
    model = two_tower_params_from_reference(jax.tree_util.tree_map(np.asarray, params), cfg,
                                            device="cpu")
    batch = {k: torch.from_numpy(ref[f"tt_{k}"]) for k in ("user_id", "hist", "candidates")}
    mi = MeshInfo(mesh=_mesh(mesh_name))
    top, ids = model.score_candidates(batch, mi, two_phase_topk=True)
    np.testing.assert_array_equal(ids.numpy(), ref[f"{mesh_name}_tt_ids"])
    np.testing.assert_allclose(top.numpy(), ref[f"{mesh_name}_tt_top"], rtol=0, atol=1e-6)
    # The merge itself, on the reference's user rows: bit for bit.
    from repro_torch.models.recsys.models import two_phase_topk_scores

    u = torch.from_numpy(ref[f"{mesh_name}_tt_u"])
    top_u, ids_u = two_phase_topk_scores(u, batch["candidates"], mi, 100)
    np.testing.assert_array_equal(ids_u.numpy(), ref[f"{mesh_name}_tt_ids"])
    np.testing.assert_array_equal(top_u.numpy(), ref[f"{mesh_name}_tt_top"])
    # and the single-device top-100 of the same scores
    want_top, want_ids = stable_topk(u @ batch["candidates"].T, 100)
    np.testing.assert_array_equal(ids_u.numpy(), want_ids.numpy())
