"""The scatter-search-merge path on one device, port against reference.

``merge_topk`` against the reference's on distance ties and +inf padding;
1x1 meshes (the reference's ``make_distributed_search`` in-process on its
one CPU device, the port's over a ``DeviceMesh`` of the CPU) for label and
range, exact and PQ, fused and unfused, over an integer-valued world (every
distance and ADC sum exact in float32): ids, dists and every stat bit for
bit, and equal to the port's own ``constrained_search`` on the same shard;
the constraint / ``pq_index`` checks; a drained mixed stream through
``DistributedExecutor`` response for response against the reference's; the
mesh helpers; and the launcher's ``--distributed`` on the CPU. Tolerance:
none (bit for bit) throughout.
"""
import functools
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.compat import set_mesh
from repro.core import make_distributed_search as ref_make_search
from repro.core import shard_corpus_for_mesh as ref_shard
from repro.core.constraints import LabelSetConstraint as RefLabelSet
from repro.core.constraints import RangeConstraint as RefRange
from repro.core.distributed import merge_topk as ref_merge_topk
from repro.core.pq import PQIndex as RefPQIndex
from repro.core.types import Corpus as RefCorpus
from repro.core.types import SearchParams as RefParams
from repro.graph.index import build_partitioned_index as ref_partitioned
from repro.serving import DistributedExecutor as RefDistributedExecutor
from repro.serving import ServingRuntime as RefRuntime
from repro.serving import VirtualClock as RefClock
from repro.serving import make_tier_ladder as ref_tier_ladder
from repro_torch import (
    Corpus,
    GraphIndex,
    LabelSetConstraint,
    PQIndex,
    RangeConstraint,
    SearchParams,
    constrained_search,
    make_distributed_search,
    merge_topk,
    shard_corpus_for_mesh,
)
from repro_torch.distributed import DeviceMesh, MeshInfo, single_device_meshinfo
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
from repro_torch.serving import (
    DistributedExecutor,
    ServingRuntime,
    VirtualClock,
    make_tier_ladder,
    mixed_workload,
)
from test_torch_parity_world import torch_threads  # noqa: F401 (autouse)
from test_torch_serving_runtime import _assert_same_response

ROOT = pathlib.Path(__file__).resolve().parents[1]
N, D, L, B = 600, 8, 40, 16
M_SUB, N_CENT = 4, 16
PARAMS = dict(mode="prefer", k=8, ef_result=24, ef_sat=24, ef_other=24, n_start=6,
              max_iters=200)
STATS = ("dist_evals", "hops", "visited", "iters", "beam_expansions")
KINDS = {
    "exact": dict(),
    "exact_fused": dict(fuse_expand="on"),
    "range": dict(),
    "pq": dict(approx="pq"),
    "pq_fused": dict(approx="pq", fuse_expand="on"),
}


@functools.lru_cache(maxsize=1)
def world():
    """The reference's 1-shard partitioned index of an integer world, its
    queries and constraints, integer PQ codebooks and their codes."""
    rng = np.random.default_rng(4)
    vec = rng.integers(-6, 7, size=(N, D)).astype(np.float32)
    lab = rng.integers(0, L, size=N).astype(np.int32)
    attrs = rng.random((N, 2)).astype(np.float32)
    q = rng.integers(-6, 7, size=(B, D)).astype(np.float32)
    words = np.zeros((B, 2), np.uint32)
    for i, labs in enumerate(rng.integers(0, L, size=(B, 6))):
        for x in labs:
            words[i, x // 32] |= np.uint32(1) << np.uint32(x % 32)
    lo = (rng.random(B) * 0.5).astype(np.float32)
    hi = lo + np.float32(0.3)
    cb = rng.integers(-6, 7, size=(M_SUB, N_CENT, D // M_SUB)).astype(np.float32)
    codes = ((vec.reshape(N, M_SUB, 1, -1) - cb[None]) ** 2).sum(-1).argmin(-1).astype(np.int32)
    ref_corpus = RefCorpus(vectors=jnp.asarray(vec), labels=jnp.asarray(lab),
                           attrs=jnp.asarray(attrs))
    corpus_p, graph_p = ref_partitioned(jax.random.PRNGKey(1), ref_corpus, n_shards=1,
                                        degree=8, sample_size_per_shard=48)
    return dict(vec=vec, lab=lab, attrs=attrs, q=q, words=words, lo=lo, hi=hi, cb=cb,
                codes=codes, corpus_p=corpus_p, graph_p=graph_p,
                nbrs=np.asarray(graph_p.neighbors), sample=np.asarray(graph_p.sample_ids),
                entry=np.asarray(graph_p.entry_point))


def port_world():
    w = world()

    def t(a):
        return torch.from_numpy(np.array(a))

    corpus = Corpus(vectors=t(w["vec"]), labels=t(w["lab"]), attrs=t(w["attrs"]))
    graph = GraphIndex(neighbors=t(w["nbrs"]), sample_ids=t(w["sample"]),
                       entry_point=t(w["entry"]))
    return corpus, graph, PQIndex(codebooks=t(w["cb"]), codes=t(w["codes"]))


def ref_mesh():
    return jax.make_mesh((1, 1), ("data", "model"))


def test_merge_topk_equals_reference_on_ties_and_padding():
    rng = np.random.default_rng(0)
    d = rng.integers(0, 4, size=(6, 3, 5)).astype(np.float32)
    d[rng.random(d.shape) < 0.3] = np.inf
    d[5] = np.inf  # a query no shard filled
    ids = rng.integers(0, 50, size=d.shape).astype(np.int32)
    ids[np.isinf(d)] = -1
    for k in (1, 5, 15):
        want_d, want_i = jax.jit(ref_merge_topk, static_argnums=2)(d, ids, k)
        got_d, got_i = merge_topk(torch.from_numpy(d), torch.from_numpy(ids), k)
        np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    assert (got_i[5] == -1).all()


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_one_by_one_mesh_equals_reference_and_constrained_search(kind):
    w = world()
    corpus, graph, pq = port_world()
    extra = KINDS[kind]
    rng_c = kind == "range"
    ref_cons = (RefRange(lo=jnp.asarray(w["lo"]), hi=jnp.asarray(w["hi"]), col=jnp.int32(1))
                if rng_c else RefLabelSet(words=jnp.asarray(w["words"])))
    cons = (RangeConstraint(lo=torch.from_numpy(w["lo"]), hi=torch.from_numpy(w["hi"]), col=1)
            if rng_c else LabelSetConstraint(words=torch.from_numpy(w["words"].view(np.int32))))
    is_pq = extra.get("approx") == "pq"
    ref_pq = RefPQIndex(codebooks=jnp.asarray(w["cb"]), codes=jnp.asarray(w["codes"]))
    mesh = ref_mesh()
    ref_search = ref_make_search(mesh, RefParams(**PARAMS, **extra),
                                 constraint_type=type(ref_cons))
    corpus_s, graph_s = ref_shard(w["corpus_p"], w["graph_p"], mesh)
    with set_mesh(mesh):
        want = ref_search(corpus_s, graph_s, jnp.asarray(w["q"]), ref_cons,
                          ref_pq if is_pq else None)
    params = SearchParams(**PARAMS, **extra)
    pmesh = single_device_meshinfo("cpu").mesh
    search = make_distributed_search(pmesh, params, constraint_type=type(cons))
    got = search(shard_corpus_for_mesh(corpus, graph, pmesh), torch.from_numpy(w["q"]), cons,
                 pq if is_pq else None)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.dists.numpy(), np.asarray(want.dists))
    for field in STATS:
        np.testing.assert_array_equal(getattr(got.stats, field).numpy(),
                                      np.asarray(getattr(want.stats, field)), err_msg=field)
    # one shard is the plain search over the shard's rows (label searches
    # see no attrs column, as the reference's label in_spec drops it)
    own = corpus if rng_c else Corpus(vectors=corpus.vectors, labels=corpus.labels)
    single = constrained_search(own, graph, torch.from_numpy(w["q"]), cons, params,
                                pq_index=pq if is_pq else None)
    assert torch.equal(single.ids, got.ids) and torch.equal(single.dists, got.dists)
    assert (got.ids >= 0).sum() > B


def test_constraint_type_and_pq_index_checks():
    corpus, graph, pq = port_world()
    mesh = single_device_meshinfo("cpu").mesh
    with pytest.raises(TypeError, match="constraint_in_spec"):
        make_distributed_search(mesh, SearchParams(), constraint_type=dict)
    q = torch.from_numpy(world()["q"])
    cons = LabelSetConstraint(words=torch.from_numpy(world()["words"].view(np.int32)))
    index_s = shard_corpus_for_mesh(corpus, graph, mesh)
    with pytest.raises(ValueError, match="requires a pq_index"):
        make_distributed_search(mesh, SearchParams(approx="pq"))(index_s, q, cons)
    with pytest.raises(ValueError, match="silently ignore"):
        make_distributed_search(mesh, SearchParams())(index_s, q, cons, pq)
    # rows and batch must split over the mesh
    mesh4 = make_test_mesh(4, model=2, device="cpu")
    with pytest.raises(ValueError, match="shards"):
        shard_corpus_for_mesh(corpus, graph, mesh4)
    index4 = shard_corpus_for_mesh(
        Corpus(vectors=corpus.vectors, labels=corpus.labels),
        GraphIndex(neighbors=graph.neighbors, sample_ids=graph.sample_ids,
                   entry_point=torch.tensor([0, 0], dtype=torch.int32)), mesh4)
    with pytest.raises(ValueError, match="data groups"):
        make_distributed_search(mesh4, SearchParams())(
            index4, q[:3], LabelSetConstraint(words=cons.words[:3]))
    with pytest.raises(ValueError, match="index has 1 shards"):
        make_distributed_search(mesh4, SearchParams())(index_s, q, cons)


def test_distributed_executor_stream_equals_reference():
    """A drained mixed stream (no jitter) through the reference's
    ``DistributedExecutor`` and the port's: every response equal."""
    w = world()
    corpus, graph, _ = port_world()
    tiers_kw = dict(k_cap=8, base_ef=8, base_iters=8, base_n_start=4, n_tiers=2)
    items = mixed_workload(7, corpus, 40, L, k_choices=(2, 4, 8), jitter=0.0)
    mesh = ref_mesh()
    corpus_s, graph_s = ref_shard(w["corpus_p"], w["graph_p"], mesh)
    ref = RefRuntime(RefDistributedExecutor(mesh, corpus_s, graph_s), n_labels=L,
                     tiers=ref_tier_ladder(**tiers_kw), ladder=(4, 8), clock=RefClock())
    pmesh = single_device_meshinfo("cpu").mesh
    executor = DistributedExecutor(pmesh, shard_corpus_for_mesh(corpus, graph, pmesh))
    port = ServingRuntime(executor, n_labels=L, tiers=make_tier_ladder(**tiers_kw),
                          ladder=(4, 8), clock=VirtualClock())
    assert executor.device == torch.device("cpu") and executor.dim == D

    def drain(rt):
        ids = [rt.submit(it.query, it.k, it.family, it.operand) for it in items]
        rt.drain()
        return [rt.poll(i) for i in ids]

    ref_rs, port_rs = drain(ref), drain(port)
    for a, b in zip(ref_rs, port_rs):
        _assert_same_response(a, b)
    assert dict(ref.telemetry.counters) == dict(port.telemetry.counters)
    assert port.executor.traces == port.cache.trace_count > 0
    assert {it.family for it in items} == {"label", "range"}


def test_mesh_helpers():
    m = make_test_mesh(4, model=2, device="cpu")
    assert m.shape == {"data": 2, "model": 2} and len(m.devices) == 4
    assert m.groups("model").shape == (2, 2) and m.groups("data").shape == (2, 2)
    mi = MeshInfo(mesh=m)
    assert (mi.dp_axes, mi.tp_axis, mi.dp_size, mi.tp_size) == (("data",), "model", 2, 2)
    assert mi.axes_if_divisible(6, mi.dp_axes) == ("data",)
    assert mi.axes_if_divisible(5, mi.dp_axes) is None and not mi.has_pod
    pod = MeshInfo(mesh=DeviceMesh.create(["cpu"] * 8, (2, 2, 2), ("pod", "data", "model")))
    assert pod.has_pod and pod.dp_axes == ("pod", "data") and pod.dp_size == 4
    assert pod.mesh.groups("model").shape == (4, 2)
    assert single_device_meshinfo("cpu").mesh.grid == (1, 1)
    with pytest.raises(ValueError):
        make_test_mesh(3, model=2, device="cpu")
    with pytest.raises(ValueError):
        DeviceMesh.create(["cpu"] * 3, (2, 2), ("data", "model"))
    if torch.cuda.device_count() < 256:
        with pytest.raises(RuntimeError, match=f"has {torch.cuda.device_count()}"):
            make_production_mesh()
        with pytest.raises(RuntimeError, match="512"):
            make_production_mesh(multi_pod=True)


def test_launcher_distributed_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu", "--n", "2000",
         "--requests", "32", "--distributed"],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=240)
    assert out.returncode == 0, out.stderr
    assert "mesh: {'data': 1, 'model': 1}" in out.stdout
    assert "served 32/32 requests" in out.stdout
    refused = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu", "--n", "500",
         "--distributed", "--hybrid"],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=240)
    assert refused.returncode != 0 and "drop --distributed" in refused.stderr
