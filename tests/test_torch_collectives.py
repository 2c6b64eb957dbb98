"""The port's collective tally (``roofline/collectives.py``) on known shapes.

The port compiles no HLO, so its moves across mesh positions report
themselves to an open ``tally``: each counted by its result's bytes at one
position (the reference's measure), once for the data groups the
controller runs one after another. Checked here: ``layout.gather``
(all-gather), ``sum_in_order`` (all-reduce), the scatter-search-merge's
gather and stats (2 all-gathers of (B_local, P, K), one all-reduce a
stats field), the MoE's expert-parallel psums, a kind given by name
(all-to-all), nested tallies, the first data group's reports only, and no
count outside a tally.
"""
import pytest
import torch

from repro_torch import (
    Corpus,
    SearchParams,
    build_partitioned_index,
    equal_constraint,
    make_distributed_search,
    make_labeled_corpus,
    make_queries,
    shard_corpus_for_mesh,
)
from repro_torch.distributed import MeshInfo
from repro_torch.distributed.layout import gather, place
from repro_torch.distributed.meshinfo import sum_in_order
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.roofline import collectives
from repro_torch.roofline.collectives import tally


def test_gather_counts_the_whole_leaf():
    mesh = make_test_mesh(4, model=2, device="cpu")
    t = torch.arange(96, dtype=torch.float32).reshape(8, 12)
    blocks = place(t, ("model", "data"), mesh)
    with tally() as tl:
        out = gather(blocks, ("model", "data"), mesh, t.shape)
    assert torch.equal(out, t)
    assert tl.result() == {"per_op_bytes": {"all-gather": 384},
                           "per_op_counts": {"all-gather": 1}, "total_bytes": 384}


def test_sum_in_order_counts_its_result():
    parts = [torch.ones(3, 5, dtype=torch.float64) for _ in range(4)]
    with tally() as tl:
        total = sum_in_order(parts, torch.device("cpu"))
    assert torch.equal(total, torch.full((3, 5), 4.0, dtype=torch.float64))
    assert tl.result()["per_op_bytes"] == {"all-reduce": 120}
    assert tl.result()["per_op_counts"] == {"all-reduce": 1}


def test_merge_counts_one_gather_a_result_and_one_reduce_a_stat():
    """A (2, 2) mesh, 16 queries (8 a data group), k = 5: each all-gather
    is (8, 2, 5) x 4 B = 320 B, dists and ids; the five stats fields one
    all-reduce each, at one group's shapes."""
    gen = torch.Generator().manual_seed(0)
    corpus = make_labeled_corpus(gen, 400, 8, 4, device="cpu")
    corpus_p, graph_p = build_partitioned_index(gen, corpus, 2, degree=8,
                                                sample_size_per_shard=16, device="cpu")
    q, qlab = make_queries(gen, corpus, 16)
    mesh = make_test_mesh(4, model=2, device="cpu")
    params = SearchParams(mode="prefer", k=5, ef_result=16, ef_sat=16, ef_other=16,
                          n_start=4, max_iters=32)
    search = make_distributed_search(mesh, params)
    index = shard_corpus_for_mesh(Corpus(vectors=corpus_p.vectors, labels=corpus_p.labels),
                                  graph_p, mesh)
    with tally() as tl:
        res = search(index, q, equal_constraint(qlab, 4))
    got = tl.result()
    assert got["per_op_bytes"]["all-gather"] == 640 and got["per_op_counts"]["all-gather"] == 2
    stats = res.stats
    want = sum(getattr(stats, f)[: 8 if getattr(stats, f).dim() else None].numel() * 4
               for f in ("dist_evals", "hops", "visited", "beam_expansions")) + 4
    assert got["per_op_counts"]["all-reduce"] == 5
    assert got["per_op_bytes"]["all-reduce"] == want
    assert got["total_bytes"] == 640 + want


def test_moe_expert_parallel_counts_its_psums():
    """smoke-mla-moe's MoE over a (1, 4) mesh: per layer the gate sums' and
    the outputs' psums (all-reduce), no all-to-all (the reference's branch
    keeps the tokens replicated over the model axis)."""
    from repro_torch.archs import get_arch
    from repro_torch.models.transformer import model as tm
    from repro_torch.models.transformer.moe import moe_ffn

    cfg = get_arch("smoke-mla-moe").cfg
    model = tm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    mp = model.moe_layers[0].ffn
    x = torch.randn(2, 8, cfg.d_model, generator=torch.Generator().manual_seed(1))
    mi = MeshInfo(make_test_mesh(4, model=4, device="cpu"))
    with tally() as tl:
        moe_ffn(mp, cfg, x, mi)
    got = tl.result()
    assert "all-to-all" not in got["per_op_counts"]
    assert got["per_op_counts"] == {"all-reduce": 2}
    t = 2 * 8  # one data group holds the batch: (t,) gate sums, (t, D) outputs
    assert got["per_op_bytes"]["all-reduce"] == (t + t * cfg.d_model) * 4


def test_a_kind_by_name_nested_tallies_and_the_first_group():
    t = torch.zeros(4, 4, dtype=torch.float32)
    with tally() as outer:
        collectives.record("all-to-all", t)
        with tally() as inner:
            collectives.record("collective-permute", t, t)
            with collectives.group(1):  # a later data group: not counted
                collectives.record("all-reduce", t)
            with collectives.group(0):
                collectives.record("all-reduce", t)
    assert outer.result()["per_op_counts"] == {"all-to-all": 1, "collective-permute": 2,
                                               "all-reduce": 1}
    assert inner.result()["total_bytes"] == 3 * 64
    with pytest.raises(ValueError, match="broadcast"), tally():
        collectives.record("broadcast", t)


def test_no_tally_outside_the_context():
    t = torch.zeros(8)
    collectives.record("all-reduce", t)  # no tally open: costs nothing, counts nowhere
    sum_in_order([t, t], torch.device("cpu"))
    with tally() as tl:
        pass
    collectives.record("all-gather", t)
    assert tl.result() == {"per_op_bytes": {}, "per_op_counts": {}, "total_bytes": 0}
    assert not collectives._open()
