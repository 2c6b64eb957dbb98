"""The AIRSHIP registry cells, port against reference.

``get_arch("smoke-airship")`` and ``get_arch("airship-sift1m")`` in the port
build ``AirshipArch`` cells: ``make_cell(shape, mi)`` gives the
distributed search of the shape and a ``make_inputs`` that builds its
world. smoke-airship's configuration under each of the six
``AIRSHIP_SHAPES`` (batch 16, serve_bulk_8k 64: smoke-airship registers
only serve_256) runs on a (1, 1) and a (1, 4) CPU mesh over the port's own
``make_inputs`` world made integer-valued (vectors, queries and PQ
codebooks rounded after scaling: every distance and ADC sum exact in
float32), and the reference's cell, given the same arrays through numpy,
must return the same ids and dists bit for bit. The reference's (1, 4)
run is a subprocess with 4 virtual host devices, as in
``tests/test_torch_distributed_multidev.py``.
"""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.archs import airship as ref_airship
from repro.archs.base import list_archs as ref_list_archs
from repro.configs import other_configs as ref_oc
from repro.core.constraints import LabelSetConstraint as RefLabelSet
from repro.core.pq import PQIndex as RefPQIndex
from repro.core.types import Corpus as RefCorpus
from repro.core.types import GraphIndex as RefGraph
from repro.distributed.meshinfo import MeshInfo as RefMeshInfo
from repro_torch.archs import get_arch, list_archs
from repro_torch.archs.airship import AIRSHIP_SHAPES, AirshipArch
from repro_torch.core import Corpus, GraphIndex, LabelSetConstraint, PQIndex, shard_corpus_for_mesh
from repro_torch.distributed import MeshInfo
from repro_torch.launch.mesh import make_test_mesh
from test_torch_parity_world import torch_threads  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHAPES = {k: dict(v, batch=64 if v["batch"] > 256 else 16) for k, v in AIRSHIP_SHAPES.items()}
SCALE = 16.0  # vectors, queries and codebooks are rounded after this scaling

SCRIPT = textwrap.dedent(
    """
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from repro.archs.airship import AirshipArch
    from repro.common.compat import set_mesh
    from repro.configs import other_configs as oc
    from repro.core.constraints import LabelSetConstraint
    from repro.core.pq import PQIndex
    from repro.core.types import Corpus, GraphIndex
    from repro.distributed.meshinfo import MeshInfo

    assert len(jax.devices()) == 4
    in_path, shapes_path, out_path = sys.argv[1:4]
    x, shapes, out = np.load(in_path), json.load(open(shapes_path)), {}
    mesh = jax.make_mesh((1, 4), ("data", "model"))
    arch = AirshipArch(oc.smoke_airship().cfg, shapes=shapes)
    corpus = Corpus(vectors=jnp.asarray(x["vectors"]), labels=jnp.asarray(x["labels"]))
    graph = GraphIndex(neighbors=jnp.asarray(x["neighbors"]),
                       sample_ids=jnp.asarray(x["sample_ids"]),
                       entry_point=jnp.asarray(x["entry_point"]))
    pq = PQIndex(codebooks=jnp.asarray(x["codebooks"]), codes=jnp.asarray(x["codes"]))
    for shape, sh in shapes.items():
        b = sh["batch"]
        cell = arch.make_cell(shape, MeshInfo(mesh=mesh))
        args = (corpus, graph, jnp.asarray(x[f"queries_{b}"]),
                LabelSetConstraint(words=jnp.asarray(x[f"words_{b}"].view(np.uint32))))
        with set_mesh(mesh):
            res = cell.fn(*args, pq) if sh.get("pq") else cell.fn(*args)
        out[f"{shape}_ids"], out[f"{shape}_dists"] = np.asarray(res.ids), np.asarray(res.dists)
    np.savez(out_path, **out)
    print("AIRSHIP_REFERENCE_OK")
    """
)


def port_arch() -> AirshipArch:
    return AirshipArch(get_arch("smoke-airship").cfg, shapes=SHAPES)


def port_mesh(model: int) -> MeshInfo:
    return MeshInfo(make_test_mesh(model, model=model, device="cpu"))


def integer_world(model: int) -> dict:
    """The port's make_inputs world for a mesh of ``model`` shards (the PQ
    shape's, so the codebooks come too), integer-valued, as numpy arrays;
    each batch's queries and label words keyed by its size."""
    arch = port_arch()
    index, _, _, pq = arch.make_cell("serve_256_pq", port_mesh(model)).make_inputs(0, "cpu")
    out = dict(vectors=torch.round(index.corpus.vectors * SCALE), labels=index.corpus.labels,
               neighbors=index.graph.neighbors, sample_ids=index.graph.sample_ids,
               entry_point=index.graph.entry_point,
               codebooks=torch.round(pq.codebooks * SCALE), codes=pq.codes)
    for b in sorted({sh["batch"] for sh in SHAPES.values()}):
        bulk = arch.make_cell(next(s for s, sh in SHAPES.items() if sh["batch"] == b),
                              port_mesh(model))
        _, q, c = bulk.make_inputs(b, "cpu")[:3]
        out[f"queries_{b}"], out[f"words_{b}"] = torch.round(q * SCALE), c.words
    return {k: v.numpy() for k, v in out.items()}


def port_run(x: dict, model: int) -> dict:
    """Every shape of ``port_arch`` over ``x`` on a (1, model) CPU mesh."""
    arch, mi = port_arch(), port_mesh(model)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    index = shard_corpus_for_mesh(
        Corpus(vectors=t["vectors"], labels=t["labels"]),
        GraphIndex(neighbors=t["neighbors"], sample_ids=t["sample_ids"],
                   entry_point=t["entry_point"]), mi.mesh)
    pq = PQIndex(codebooks=t["codebooks"], codes=t["codes"])
    out = {}
    for shape, sh in SHAPES.items():
        b = sh["batch"]
        args = (index, t[f"queries_{b}"], LabelSetConstraint(words=t[f"words_{b}"]))
        res = arch.make_cell(shape, mi).fn(*args, *((pq,) if sh.get("pq") else ()))
        out[f"{shape}_ids"], out[f"{shape}_dists"] = res.ids.numpy(), res.dists.numpy()
    return out


def test_registered_names_equal_reference():
    assert list_archs() == ref_list_archs()
    assert get_arch("airship-sift1m").cfg.n == 1_000_000
    assert get_arch("smoke-airship").shape_names() == ref_oc.smoke_airship().shape_names()
    assert get_arch("airship-sift1m").shape_names() == list(ref_airship.AIRSHIP_SHAPES)


@pytest.fixture(scope="module")
def world_1x1():
    x = integer_world(1)
    return x, port_run(x, 1)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_smoke_airship_cells_equal_reference_1x1(world_1x1, shape):
    """Each shape on a (1, 1) mesh: the port's cell == the reference's cell."""
    x, got = world_1x1
    sh = SHAPES[shape]
    b = sh["batch"]
    mesh = jax.make_mesh((1, 1), ("data", "model"), devices=jax.devices()[:1])
    cell = ref_airship.AirshipArch(ref_oc.smoke_airship().cfg, shapes=SHAPES).make_cell(
        shape, RefMeshInfo(mesh=mesh))
    args = (RefCorpus(vectors=jnp.asarray(x["vectors"]), labels=jnp.asarray(x["labels"])),
            RefGraph(neighbors=jnp.asarray(x["neighbors"]),
                     sample_ids=jnp.asarray(x["sample_ids"]),
                     entry_point=jnp.asarray(x["entry_point"])),
            jnp.asarray(x[f"queries_{b}"]),
            RefLabelSet(words=jnp.asarray(x[f"words_{b}"].view(np.uint32))))
    if sh.get("pq"):
        args += (RefPQIndex(codebooks=jnp.asarray(x["codebooks"]),
                            codes=jnp.asarray(x["codes"])),)
    res = cell.fn(*args)
    np.testing.assert_array_equal(got[f"{shape}_ids"], np.asarray(res.ids))
    np.testing.assert_array_equal(got[f"{shape}_dists"], np.asarray(res.dists))
    assert (got[f"{shape}_ids"] >= 0).any(), shape


def test_smoke_airship_cells_equal_reference_1x4(tmp_path):
    """Every shape on a (1, 4) mesh against the reference's (1, 4) cells on
    4 virtual host devices."""
    x = integer_world(4)
    np.savez(tmp_path / "in.npz", **x)
    (tmp_path / "shapes.json").write_text(json.dumps(SHAPES))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(tmp_path / "in.npz"),
                           str(tmp_path / "shapes.json"), str(tmp_path / "out.npz")],
                          capture_output=True, text=True, env=env, cwd=ROOT, timeout=240)
    assert proc.returncode == 0 and "AIRSHIP_REFERENCE_OK" in proc.stdout, proc.stderr[-4000:]
    want = dict(np.load(tmp_path / "out.npz"))
    got = port_run(x, 4)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_meta_inputs_have_the_shapes_and_build_nothing():
    """make_inputs on the meta device: the reference's abstract argument
    shapes and dtypes (the corpus rounded up to the shards), no storage."""
    ref = ref_oc.airship_sift1m()
    for shape in ("serve_256", "serve_256_pq"):
        mi = MeshInfo(make_test_mesh(4, model=4, device="meta"))
        cell = get_arch("airship-sift1m").make_cell(shape, mi)
        args = cell.make_inputs(0, "meta")
        amesh = jax.sharding.AbstractMesh((1, 4), ("data", "model"))
        rcell = ref.make_cell(shape, RefMeshInfo(mesh=amesh))
        want = [tuple(a.shape) for a in jax.tree.leaves(rcell.args)]
        index = args[0]
        got = [tuple(t.shape) for t in (index.corpus.vectors, index.corpus.labels,
                                         index.graph.neighbors, index.graph.sample_ids,
                                         index.graph.entry_point, args[1], args[2].words)]
        if shape.endswith("pq"):
            got += [tuple(args[3].codebooks.shape), tuple(args[3].codes.shape)]
        assert sorted(got) == sorted(want), shape
        assert all(t.is_meta for t in (index.corpus.vectors, args[1]))
        assert set(cell.specs) == {
            "index.corpus.vectors", "index.corpus.labels", "index.graph.neighbors",
            "index.graph.sample_ids", "index.graph.entry_point", "queries",
            "constraint.words"} | ({"pq_index.codebooks", "pq_index.codes"}
                                   if shape.endswith("pq") else set())
