"""The port stands alone: no file under src/repro_torch/ nor chip_smoke.py
imports jax, jaxlib or the reference package (the checkpoints, the
training driver and the compression and layout modules among them),
importing the port leaves jax out of sys.modules, tensor-creating entry
points without ``device=`` (``TwoTower``, ``DLRM``, ``DeepFM``,
``SASRec``, ``Transformer``, ``MLP``, the recsys and LM batches, inits,
caches, interop, cells and the training driver too) raise where there is
no CUDA device instead of dropping to the CPU, and no
module says a path waits for ROADMAP item 11b, 12 or 14b (all are
ported)."""
import ast
import pathlib
import subprocess
import sys

import pytest
import torch

import repro_torch
from repro_torch.core.queue import queue_init
from repro_torch.core.visited import visited_init
from repro_torch.data import make_labeled_corpus
from repro_torch.graph import build_index, build_partitioned_index, nn_descent
from repro_torch.archs import get_arch
from repro_torch.archs.recsys import shape_batch
from repro_torch.configs import smoke_deepfm, smoke_dlrm, smoke_sasrec, smoke_two_tower
from repro_torch.data import (
    deepfm_batch,
    dlrm_batch,
    lm_batch,
    sasrec_batch,
    sasrec_serve_batch,
    two_tower_batch,
)
from repro_torch.interop import (
    adamw_state_from_reference,
    from_reference_arrays,
    lm_params_from_reference,
    pq_index_from_reference,
    recsys_params_from_reference,
    sasrec_params_from_reference,
    streaming_index_from_reference,
    two_tower_params_from_reference,
)
from repro_torch.distributed import single_device_meshinfo
from repro_torch.launch import serve, train
from repro_torch.common.device import make_generator
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
from repro_torch.models.common.modules import (
    MLP,
    Dense,
    Embedding,
    LayerNorm,
    RMSNorm,
    rope_frequencies,
)
from repro_torch.models.recsys import (
    DLRM,
    DeepFM,
    SASRec,
    deepfm_init,
    dlrm_init,
    sasrec_init,
    two_tower_init,
)
from repro_torch.models.recsys.models import TwoTower
from repro_torch.models.gnn import MACE, MACEConfig, sample_subgraph
from repro_torch.models.gnn import init_params as mace_init
from repro_torch.models.gnn.distributed import dst_partitioned_loss, partition_by_destination
from repro_torch.models.transformer import Transformer, init_cache, init_params
from repro_torch.models.transformer.model import lm_loss
from repro_torch.archs.gnn import GNNArch
from repro_torch.data import gnn_batch
from repro_torch.interop import mace_params_from_reference
from repro_torch.train import reference_layout
from repro_torch.train.parity import step_readings

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_reference_imports():
    files = _port_files()
    assert all(p.exists() for p in files) and len(files) > 20
    port = ROOT / "src" / "repro_torch"
    walked = {p.relative_to(port).as_posix() for p in files if port in p.parents}
    assert {"streaming/__init__.py", "streaming/slots.py", "streaming/mutate.py",
            "streaming/consolidate.py", "core/histogram.py", "core/posting.py",
            "core/estimator.py", "core/overlay.py", "core/router.py",
            "serving/__init__.py", "serving/types.py", "serving/batcher.py",
            "serving/cache.py", "serving/slo.py", "serving/controller.py",
            "serving/telemetry.py", "serving/retry.py", "serving/faults.py",
            "serving/runtime.py", "serving/workload.py", "obs/__init__.py",
            "obs/tracing.py", "obs/logs.py", "launch/__init__.py",
            "launch/serve.py", "obs/metrics.py", "obs/promparse.py", "obs/adapters.py",
            "obs/http.py", "serving/replicas.py", "core/distributed.py",
            "distributed/__init__.py", "distributed/meshinfo.py", "launch/mesh.py",
            "archs/airship.py", "tune/__init__.py", "tune/config.py", "tune/table.py",
            "tune/sweep.py", "roofline/__init__.py", "roofline/model.py",
            "train/__init__.py", "train/optimizer.py", "train/train_step.py",
            "archs/base.py", "archs/recsys.py", "configs/__init__.py",
            "models/common/modules.py", "models/recsys/models.py", "data/pipeline.py",
            "common/distances.py", "kernels/embedding_bag.py", "interop.py",
            "models/common/flash.py", "models/transformer/__init__.py",
            "models/transformer/attention.py", "models/transformer/model.py", "archs/lm.py",
            "configs/lm_configs.py", "models/transformer/moe.py", "models/gnn/__init__.py",
            "models/gnn/mace.py", "models/gnn/sampler.py", "models/gnn/distributed.py",
            "archs/gnn.py", "train/parity.py", "ckpt/__init__.py", "ckpt/checkpoint.py",
            "launch/train.py", "train/compression.py", "distributed/layout.py",
            "launch/dryrun.py", "roofline/report.py", "roofline/collectives.py"} <= walked
    bad = {str(p.relative_to(ROOT)): sorted(_imported_roots(p) & set(FORBIDDEN))
           for p in files if _imported_roots(p) & set(FORBIDDEN)}
    assert not bad, bad


def test_importing_the_port_leaves_jax_out():
    code = (
        "import sys, importlib, pkgutil, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""},
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_package_exports_resolve():
    for name in repro_torch.__all__:
        assert getattr(repro_torch, name) is not None


def test_tensor_creators_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    g = torch.Generator()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_labeled_corpus(g, 64, 4, 3)
    corpus = make_labeled_corpus(g, 64, 4, 3, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_index(g, corpus, degree=4, sample_size=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_partitioned_index(g, corpus, 2, degree=4, sample_size_per_shard=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        nn_descent(g, corpus.vectors, 4, iters=1)
    with pytest.raises(RuntimeError):
        visited_init(2, 64)
    with pytest.raises(RuntimeError):
        queue_init(2, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        from_reference_arrays(vectors=corpus.vectors.numpy(), labels=corpus.labels.numpy(),
                              neighbors=corpus.labels.numpy()[:, None],
                              sample_ids=corpus.labels.numpy(), entry_point=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        pq_index_from_reference(codebooks=corpus.vectors.numpy()[None],
                                codes=corpus.labels.numpy()[:, None])
    cfg = smoke_two_tower()
    with pytest.raises(RuntimeError, match="CUDA"):
        two_tower_init(g, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        TwoTower(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        MLP((4, 2))
    assert TwoTower(cfg, device="cpu").item_emb.device.type == "cpu"
    assert MLP((4, 2), device="cpu").layers[0].weight.device.type == "cpu"
    for module in (DLRM(smoke_dlrm(), device="cpu"), DeepFM(smoke_deepfm(), device="cpu")):
        assert all(p.device.type == "cpu" for p in module.parameters())
    for make in (lambda: DLRM(smoke_dlrm()), lambda: DeepFM(smoke_deepfm()),
                 lambda: dlrm_init(g, smoke_dlrm()), lambda: deepfm_init(g, smoke_deepfm()),
                 lambda: Dense(4, 2), lambda: RMSNorm(4), lambda: LayerNorm(4),
                 lambda: Embedding(8, 2),
                 lambda: dlrm_batch(0, 0, 4, 4, (10, 10)), lambda: deepfm_batch(0, 0, 4, (10,)),
                 lambda: shape_batch(smoke_dlrm(), "train_batch"),
                 lambda: get_arch("smoke-deepfm").make_cell("train_batch").make_inputs(0),
                 lambda: get_arch("smoke-airship").make_cell("serve_256"),
                 lambda: get_arch("smoke-airship").make_cell(
                     "serve_256", single_device_meshinfo("cpu")).make_inputs(0),
                 lambda: make_production_mesh()):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    dlrm = dlrm_init(g, smoke_dlrm(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        recsys_params_from_reference(dlrm.state_dict(), smoke_dlrm())
    state = {"m": {}, "v": {}, "count": 0}
    with pytest.raises(RuntimeError, match="CUDA"):
        adamw_state_from_reference(state, dlrm)
    assert reference_layout(dlrm)["bot.layers.0.weight"].shape == (4, 16)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_test_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        single_device_meshinfo()
    with pytest.raises(RuntimeError, match="CUDA"):
        two_tower_batch(0, 0, 4, cfg.user_vocab, cfg.item_vocab, cfg.hist_len)
    with pytest.raises(RuntimeError, match="CUDA"):
        shape_batch(cfg, "serve_p99")
    params = two_tower_init(g, cfg, device="cpu").state_dict()
    with pytest.raises(RuntimeError, match="CUDA"):
        two_tower_params_from_reference(params, cfg)
    index = build_index(g, corpus, degree=4, sample_size=8, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.StreamingIndex.from_static(corpus, index)
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.SlotPool(corpus.vectors, corpus.labels, None, 80)
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.build_overlay(0, [1, 2, 3], corpus.vectors, 0, generator=g)
    cpu_index = repro_torch.StreamingIndex.from_static(corpus, index, device="cpu")
    pool = cpu_index.pool
    with pytest.raises(RuntimeError, match="CUDA"):
        streaming_index_from_reference(
            vectors=pool.vectors.numpy(), labels=pool.labels, attrs=None,
            tombstones=pool.tombstones, neighbors=cpu_index.neighbors.numpy(),
            sample_ids=cpu_index.sample_ids, entry_point=cpu_index.entry_point,
            free=pool.free, pending=pool.pending, n_live=pool.n_live, epoch=0, ef_insert=32,
            consolidations=0, rng_state=cpu_index.rng.get_state())
    # the serve launcher's and the training driver's default device is the card, too
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--n", "64", "--requests", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", "smoke-dlrm", "--steps", "1"])
    assert train.parse_args(["--arch", "smoke-dlrm"]).device == "cuda"
    # SASRec and the LM
    sas = smoke_sasrec()
    lm_cfg = get_arch("smoke-gqa").cfg
    for make in (lambda: SASRec(sas), lambda: sasrec_init(g, sas),
                 lambda: sasrec_batch(0, 0, 2, 4, 10), lambda: lm_batch(0, 0, 2, 4, 10),
                 lambda: sasrec_serve_batch(0, 0, 2, 4, 10, 3),
                 lambda: shape_batch(sas, "serve_p99"),
                 lambda: get_arch("smoke-sasrec").make_cell("serve_p99").make_inputs(0),
                 lambda: Transformer(lm_cfg), lambda: init_params(g, lm_cfg),
                 lambda: init_cache(lm_cfg, 1, 8), lambda: rope_frequencies(8),
                 lambda: get_arch("smoke-gqa").make_cell("decode_32k").make_inputs(0),
                 lambda: Transformer(get_arch("smoke-mla-moe").cfg),
                 lambda: init_cache(get_arch("smoke-mla-moe").cfg, 1, 8),
                 lambda: get_arch("smoke-mla-moe").make_cell("long_500k").make_inputs(0)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    assert all(p.device.type == "cpu" for p in SASRec(sas, device="cpu").parameters())
    assert Transformer(lm_cfg, device="cpu").lm_head.weight.device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        sasrec_params_from_reference(sasrec_init(g, sas, device="cpu").state_dict(), sas)
    with pytest.raises(RuntimeError, match="CUDA"):
        lm_params_from_reference({}, lm_cfg)
    # LM training and MACE
    mace_cfg = MACEConfig(d_hidden=4, n_rbf=2)
    for make in (lambda: get_arch("smoke-gqa").make_cell("train_4k").make_inputs(0),
                 lambda: MACE(mace_cfg), lambda: mace_init(g, mace_cfg),
                 lambda: gnn_batch(0, 0, 4, 4), lambda: mace_params_from_reference({}, mace_cfg),
                 lambda: get_arch("smoke-mace").make_cell("molecule").make_inputs(0)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    assert all(p.device.type == "cpu" for p in MACE(mace_cfg, device="cpu").parameters())
    assert callable(lm_loss) and callable(dst_partitioned_loss)
    assert callable(partition_by_destination) and callable(sample_subgraph)
    assert isinstance(get_arch("mace"), GNNArch)


def test_no_module_waits_for_items_11b_or_12():
    """The launcher's flags, the package docstrings and the models no longer
    name ROADMAP item 11b, 12, 14b, 14c or 14d as missing; the launcher takes
    --serve-http, --replicas, --router and --distributed."""
    bad = {str(p.relative_to(ROOT)) for p in _port_files()
           if any(f"item {i}" in p.read_text()
                  for i in ("11b", "12", "14b", "14c", "14d", "14e"))}
    assert not bad, bad
    args = serve.parse_args(["--serve-http", "0", "--replicas", "2", "--router",
                             "least-loaded", "--distributed"])
    assert (args.serve_http, args.replicas, args.router, args.distributed) == (
        0, 2, "least-loaded", True)


def test_generator_must_match_device():
    with pytest.raises(ValueError, match="generator"):
        make_labeled_corpus(torch.Generator(), 64, 4, 3, device="meta")
    with pytest.raises(ValueError, match="generator"):
        two_tower_init(torch.Generator(), smoke_two_tower(), device="meta")
    # the meta device's stand-in draws nothing and passes there only
    assert make_labeled_corpus(make_generator("meta", 0), 64, 4, 3, device="meta",
                               use_kmeans_labels=False).vectors.is_meta
    model = two_tower_init(make_generator("meta", 0), smoke_two_tower(), device="meta")
    assert all(p.is_meta for p in model.parameters())
