"""The tuner's lattice on the card: every block shape gather_distance is
instantiated at gives the default config's bits (the other three kernels
have one shape each, run here beside it), an off-lattice config raises,
and ``build_context`` on a CUDA device picks the table's entry.

Marked ``cuda``; each test skips where there is no CUDA device. JAX-free:

    python -m pytest -m cuda tests/test_torch_cuda_tune.py

Shapes: small ones (B = 8, M of 1, 45 and 130, d of 128, 256 and 13: the
register path with one and two float4s a lane and the shared-memory path;
ADC tables of 16 KB and 256 KB, staged and read in device memory) and the
main path's (B = 256 over n = 1M at M = 32 and 128, d = 128; the PQ scan
over 1M rows, whose lattice is its one shape; gather_distance at one
NN-descent round's 2**20 candidates).
"""
import json

import pytest
import torch

import repro_torch as rt
from repro_torch.common.bits import n_words
from repro_torch.core.engine.context import build_context
from repro_torch.kernels.fused_expand import fused_expand_adc_cuda, fused_expand_cuda
from repro_torch.kernels.gather_distance import gather_distance, gather_distance_cuda
from repro_torch.kernels.pq_adc import pq_adc_cuda
from repro_torch.tune import DEFAULT_CONFIGS, KernelConfig, lattice_configs, table
from test_torch_cuda import dev  # noqa: F401 (a fixture)


def _words(gen, shape, dev):
    return torch.randint(-2**31, 2**31, shape, generator=gen, dtype=torch.int64,
                         device=dev).to(torch.int32)


def _probe_inputs(gen, dev, b, m, n, family, tomb):
    ids = torch.randint(-1, n, (b, m), generator=gen, dtype=torch.int32, device=dev)
    visited = _words(gen, (b, n_words(n)), dev)
    if family == "label":
        meta = torch.randint(0, 40, (n,), generator=gen, dtype=torch.int32, device=dev)
        cons = _words(gen, (b, n_words(40)), dev)
    elif family == "range":
        meta = torch.randint(0, 20, (n,), generator=gen, device=dev).float()
        lo = torch.randint(0, 10, (b,), generator=gen, device=dev).float()
        cons = torch.stack([lo, lo + 6], -1)
    else:
        meta = torch.randint(-1, 2, (n,), generator=gen, dtype=torch.int32, device=dev)
        cons = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    tombs = _words(gen, (n_words(n),), dev) if tomb else None
    return ids, visited, meta, cons, tombs


def _same_for_every_point(kernel, run):
    """run(config) -> tuple of tensors; every lattice point equals the default
    (for a kernel of one shape, its one point: a second launch gives the
    first one's bits)."""
    assert (len(lattice_configs(kernel)) == 1) == (kernel != "gather_distance")
    want = run(DEFAULT_CONFIGS[kernel])
    for cfg in lattice_configs(kernel):
        got = run(cfg)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w), (kernel, cfg)


@pytest.mark.cuda
def test_gather_distance_lattice_is_bit_invariant(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = [(8, m, 5000, d) for m in (1, 45, 130) for d in (128, 256, 13)]
    shapes += [(256, 32, 1_000_000, 128), (256, 128, 1_000_000, 128), (8192, 128, 100_000, 128)]
    for b, m, n, d in shapes:
        q = torch.randn((b, d), generator=gen, device=dev)
        x = torch.randn((n, d), generator=gen, device=dev)
        ids = torch.randint(-1, n, (b, m), generator=gen, dtype=torch.int32, device=dev)
        _same_for_every_point("gather_distance",
                              lambda cfg: (gather_distance_cuda(q, x, ids, config=cfg),))


@pytest.mark.cuda
def test_fused_expand_lattice_is_bit_invariant(dev):
    gen = torch.Generator(device=dev).manual_seed(1)
    cases = [(8, m, 5000, d, fam, tomb) for m in (1, 45, 130) for d in (128, 256, 13)
             for fam in ("label", "range", "udf") for tomb in (False, True)
             if (d == 128 or fam == "label") and (m == 45 or (fam, tomb) == ("label", False))]
    cases += [(256, 32, 1_000_000, 128, "label", False), (256, 128, 1_000_000, 128, "label", True)]
    for b, m, n, d, fam, tomb in cases:
        q = torch.randn((b, d), generator=gen, device=dev)
        x = torch.randn((n, d), generator=gen, device=dev)
        ids, visited, meta, cons, tombs = _probe_inputs(gen, dev, b, m, n, fam, tomb)
        _same_for_every_point("fused_exact", lambda cfg: fused_expand_cuda(
            q, x, ids, visited, meta, cons, tombs, family=fam))


@pytest.mark.cuda
def test_fused_expand_adc_lattice_is_bit_invariant(dev):
    gen = torch.Generator(device=dev).manual_seed(2)
    cases = [(8, m, 5000, 16, 256, fam, tomb) for m in (1, 45, 130)
             for fam in ("label", "range", "udf") for tomb in (False, True)
             if m == 45 or (fam, tomb) == ("label", False)]
    cases += [(8, 45, 5000, 64, 1024, "label", True),  # 256 KB: read in device memory
              (256, 32, 1_000_000, 16, 256, "label", False),
              (256, 128, 1_000_000, 16, 256, "label", False)]
    for b, m, n, m_sub, n_cent, fam, tomb in cases:
        lut = torch.rand((b, m_sub, n_cent), generator=gen, device=dev)
        codes = torch.randint(0, n_cent, (n, m_sub), generator=gen, dtype=torch.int32,
                              device=dev)
        ids, visited, meta, cons, tombs = _probe_inputs(gen, dev, b, m, n, fam, tomb)
        _same_for_every_point("fused_adc", lambda cfg: fused_expand_adc_cuda(
            lut, codes, ids, visited, meta, cons, tombs, family=fam))


@pytest.mark.cuda
def test_pq_adc_lattice_is_bit_invariant(dev):
    gen = torch.Generator(device=dev).manual_seed(3)
    for b, n, m_sub, n_cent in ((5, 1000, 16, 256), (3, 70_001, 13, 16), (256, 1_000_000, 16, 256)):
        lut = torch.rand((b, m_sub, n_cent), generator=gen, device=dev)
        codes = torch.randint(0, n_cent, (n, m_sub), generator=gen, dtype=torch.int32,
                              device=dev)
        _same_for_every_point("pq_adc", lambda cfg: (pq_adc_cuda(lut, codes),))


@pytest.mark.cuda
def test_off_lattice_config_raises(dev):
    gen = torch.Generator(device=dev).manual_seed(4)
    q = torch.randn((4, 128), generator=gen, device=dev)
    x = torch.randn((500, 128), generator=gen, device=dev)
    ids = torch.randint(-1, 500, (4, 16), generator=gen, dtype=torch.int32, device=dev)
    for cfg in (KernelConfig(tile_warps=3), KernelConfig(rows_in_flight=16),
                KernelConfig(tile_warps=16)):
        with pytest.raises(RuntimeError):
            gather_distance_cuda(q, x, ids, config=cfg)
        with pytest.raises(RuntimeError):  # the shared-memory path refuses it too
            gather_distance_cuda(q[:, :13].contiguous(), x[:, :13].contiguous(), ids, config=cfg)


@pytest.fixture
def tuned_table(tmp_path, monkeypatch):
    """Point the port's table at one whose "cuda" gather_distance entry for
    (d 16, deg 12, beam 1) is off the default; the loader's cache is
    cleared around it."""
    tuned = KernelConfig(tile_warps=8, rows_in_flight=2)
    doc = {"version": table.SCHEMA_VERSION, "device": "test", "lattice": table.lattice_doc(),
           "entries": [dict(kernel="gather_distance", platform="cuda", d=16, deg=12, beam=1,
                            config=tuned.to_dict())]}
    path = tmp_path / "table.json"
    path.write_text(json.dumps(doc))
    monkeypatch.setattr(table, "TABLE_PATH", str(path))
    table.load_table.cache_clear()
    yield tuned
    table.load_table.cache_clear()


@pytest.mark.cuda
def test_build_context_on_the_card_picks_the_table_entry(dev, tuned_table, tmp_path,
                                                         monkeypatch):
    tuned = tuned_table
    gen = torch.Generator(device=dev).manual_seed(5)
    corpus = rt.make_labeled_corpus(gen, 2000, 16, 10, device=dev)
    graph = rt.build_index(gen, corpus, degree=12, sample_size=64, device=dev)
    queries = corpus.vectors[:8].clone()
    cons = rt.equal_constraint(corpus.labels[:8], 10)
    params = rt.SearchParams(k=5, ef_result=16, ef_sat=16, ef_other=16, n_start=4,
                             max_iters=32, use_kernel=True, fuse_expand="off")
    assert build_context(corpus, cons, queries, params, degree=12).backend.gd_config == tuned
    # The walk launches at that shape and still equals the default's.
    before = gather_distance.launches
    res = rt.constrained_search(corpus, graph, queries, cons, params)
    assert gather_distance.launches > before
    table.load_table.cache_clear()
    monkeypatch.setattr(table, "TABLE_PATH", str(tmp_path / "absent.json"))
    ref = rt.constrained_search(corpus, graph, queries, cons, params)
    assert torch.equal(res.ids, ref.ids) and torch.equal(res.dists, ref.dists)
