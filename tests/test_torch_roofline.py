"""The port's roofline model (``repro_torch.roofline.model``) against the
reference's (``repro.roofline.model``) on the CPU: kernel flops where the
reference pads nothing, kernel bytes as the reference's plus the named
terms it leaves out, ``prune_configs``' rule, ``RooflineTerms``'
arithmetic, and ``airship_terms`` (at tp = 16) and ``recsys_terms`` equal
to the reference's on the published configs; ``lm_train_terms`` and
``mace_terms`` equal to the reference's, and the card's bounds built from
them at the rate and width of their operands' type."""
import dataclasses

import pytest
import torch

from repro.archs.airship import AirshipServeConfig as RefAirshipConfig
from repro.archs.recsys import RECSYS_SHAPES
from repro.configs import other_configs as ref_configs
from repro.roofline import model as ref_model
from repro.tune.config import DEFAULT_CONFIGS as REF_DEFAULTS
from repro_torch.archs.airship import AirshipServeConfig
from repro_torch.models.recsys.models import RecsysConfig
from repro_torch.roofline import model
from repro_torch.tune import DEFAULT_CONFIGS, lattice_configs

# Shapes the reference pads by nothing: m a multiple of 8 and <= its
# default m_blk (128 for the per-iteration kernels, 256 for the pq_adc scan).
SHAPES = {
    "gather_distance": [(1, 8, 8), (256, 32, 128), (256, 128, 128), (16, 64, 256)],
    "fused_exact": [(1, 8, 8), (256, 32, 128), (256, 128, 128), (16, 64, 256)],
    "fused_adc": [(1, 8, 4), (256, 32, 16), (256, 128, 16)],
    "pq_adc": [(1, 8, 4), (256, 256, 16), (4, 64, 8)],
}


def test_kernel_roofline_flops_equal_the_reference():
    for kernel, shapes in SHAPES.items():
        for b, m, d in shapes:
            for n_cent in (16, 256):
                ref = ref_model.kernel_roofline(kernel, REF_DEFAULTS[kernel], b=b, m=m, d=d,
                                                n_cent=n_cent)
                for cfg in lattice_configs(kernel):
                    got = model.kernel_roofline(kernel, cfg, b=b, m=m, d=d, n_cent=n_cent)
                    assert got.flops == ref.flops, (kernel, b, m, d, n_cent, cfg)


def test_kernel_bytes_are_the_reference_plus_the_named_terms_it_leaves_out():
    n_cent = 256
    for kernel, shapes in SHAPES.items():
        for b, m, d in shapes:
            cand = b * m
            ref = ref_model.kernel_roofline(kernel, REF_DEFAULTS[kernel], b=b, m=m, d=d,
                                            n_cent=n_cent).hbm_bytes
            for family, tomb in (("label", False), ("range", True), ("udf", False)):
                for cfg in lattice_configs(kernel):
                    terms = model.kernel_bytes(kernel, cfg, b=b, m=m, d=d, n_cent=n_cent,
                                               family=family, tomb=tomb)
                    got = model.kernel_roofline(kernel, cfg, b=b, m=m, d=d, n_cent=n_cent,
                                                family=family, tomb=tomb).hbm_bytes
                    assert got == sum(terms.values())
                    if kernel == "gather_distance":
                        # + the candidate ids the reference's scalar prefetch hides
                        want = ref + terms["ids"]
                    elif kernel == "pq_adc":
                        # the codes read once, not once a query
                        want = ref - (b - 1) * m * d * 4.0
                    else:
                        # + ids, visited, constraint and tombstone words; the
                        # outputs are a float32 and two bools (6 bytes, not the
                        # reference's three words); fused_adc stages its
                        # query's table once a block, not once a query
                        want = (ref + terms["ids"] + terms["visited"] + terms["cons"]
                                + terms["tomb"] - 6.0 * cand)
                        if kernel == "fused_adc":
                            blocks = terms["lut"] / (b * d * n_cent * 4.0)
                            assert blocks == int(blocks) >= 1
                            want += (blocks - 1) * b * d * n_cent * 4.0
                    assert got == want, (kernel, b, m, d, family, tomb, cfg)
                    assert terms["tomb" if kernel not in ("gather_distance", "pq_adc")
                                 else "out"] >= 0


def test_prune_configs_drops_only_memory_dominated_and_unfitting_configs(monkeypatch):
    rows = lattice_configs("gather_distance")
    # Every row kernel config moves the same bytes: nothing goes.
    assert model.prune_configs("gather_distance", rows, b=256, m=32, d=128) == (list(rows), [])
    # With bytes that grow with tile_warps, at a shape bound by bytes, each
    # config reading more than the best goes; bound by operations, none.
    kernel_bytes = model.kernel_bytes

    def by_tile(kernel, config, **shape):
        terms = kernel_bytes(kernel, config, **shape)
        return dict(terms, rows=terms["rows"] * config.tile_warps)

    monkeypatch.setattr(model, "kernel_bytes", by_tile)
    survivors, pruned = model.prune_configs("gather_distance", rows, b=256, m=32, d=128)
    assert model.kernel_roofline("gather_distance", rows[0], b=256, m=32, d=128).memory_bound()
    assert survivors == [c for c in rows if c.tile_warps == 2]
    assert pruned == [c for c in rows if c.tile_warps > 2]
    monkeypatch.setattr(model, "PEAK_FLOPS", 1e6)  # now bound by operations
    assert model.prune_configs("gather_distance", rows, b=256, m=32, d=128) == (list(rows), [])
    monkeypatch.setattr(model, "kernel_bytes", kernel_bytes)
    # What does not fit a block's shared memory goes, whatever its bytes.
    monkeypatch.setattr(model, "SMEM_BYTES", 1000)
    assert model.prune_configs("gather_distance", rows, b=8, m=32, d=300) == ([], list(rows))
    assert model.prune_configs("gather_distance", rows, b=8, m=32, d=128) == (list(rows), [])
    scans = lattice_configs("pq_adc")
    assert model.prune_configs("pq_adc", scans, b=8, m=1000, d=16, n_cent=256) == ([],
                                                                                   list(scans))
    assert DEFAULT_CONFIGS["pq_adc"] in scans


def test_roofline_terms_arithmetic_and_constants():
    assert (model.HBM_BW, model.FP32_FLOPS, model.BF16_FLOPS) == (3.35e12, 67e12, 989e12)
    assert (model.NVLINK_BW, model.SMEM_BYTES, model.PEAK_FLOPS) == (450e9, 232_448, 67e12)
    t = model.RooflineTerms(cell="c", mesh="1x2", chips=2, flops=2 * 67e12 * 3e-3,
                            hbm_bytes=2 * 3.35e12 * 1e-3, coll_bytes=450e9 * 2e-3,
                            model_flops=67e12 * 3e-3)
    assert t.t_compute == pytest.approx(3e-3) and t.t_memory == pytest.approx(1e-3)
    assert t.t_collective == pytest.approx(2e-3)
    assert t.bottleneck == "compute" and t.step_time == t.t_compute
    assert t.useful_fraction == pytest.approx(0.5)
    assert t.roofline_fraction == pytest.approx(0.5)
    k = model.KernelRoofline(flops=67e12 * 1e-6, hbm_bytes=3.35e12 * 2e-6, smem_bytes=0.0)
    assert k.time_bound("cuda") == pytest.approx(2e-6) and k.bound_by("cuda") == "bytes"
    assert k.time_bound("cpu") == pytest.approx(max(67e12 * 1e-6 / model.HOST_FLOPS,
                                                    3.35e12 * 2e-6 / model.HOST_BW))
    assert model.work_bound(3.35e9, 1.0) == (pytest.approx(1e-3), "bytes")
    assert model.work_bound(1.0, 67e9) == (pytest.approx(1e-3), "operations")


def test_airship_terms_equal_the_reference_at_tp16():
    ref_cfg, cfg = RefAirshipConfig(), AirshipServeConfig()
    for f in ("dim", "degree", "sample_per_shard"):
        assert getattr(cfg, f) == getattr(ref_cfg, f)
    assert cfg.params.k == ref_cfg.params.k
    for batch, chips, iters in ((256, 1, 200.0), (256, 4, 224.0), (8192, 16, 259.0),
                                (1, 512, 17.5)):
        assert model.airship_terms(cfg, batch, chips, iters) == \
            ref_model.airship_terms(ref_cfg, batch, chips, iters)
    # tp = 1: one walk a query, no merge fan-in.
    f, h, c, mf = model.airship_terms(cfg, 256, 1, 224.0, tp=1)
    assert f == 256 * 224.0 * 3.0 * 32 * 128 + 256 * 128 * 3.0 * 128 == mf
    assert h == 256 * 224.0 * 32 * 128 * 4.0 and c == 256 * 10 * 8.0


def _port_config(ref_cfg) -> RecsysConfig:
    names = {f.name for f in dataclasses.fields(RecsysConfig)} - {"param_dtype", "compute_dtype"}
    return RecsysConfig(**{k: getattr(ref_cfg, k) for k in names})


@pytest.mark.parametrize("arch", ("dlrm_mlperf", "deepfm", "sasrec", "two_tower_retrieval"))
def test_recsys_terms_equal_the_reference(arch):
    ref_cfg = getattr(ref_configs, arch)().cfg
    cfg = _port_config(ref_cfg)
    for shape in RECSYS_SHAPES.values():
        for chips in (1, 4, 16, 64):
            kw = dict(batch=shape["batch"], chips=chips, kind=shape["kind"],
                      n_candidates=shape.get("n_candidates", 0))
            assert model.recsys_terms(cfg, **kw) == ref_model.recsys_terms(ref_cfg, **kw)
    assert model._mlp_params((4, 3, 2)) == ref_model._mlp_params((4, 3, 2)) == 18.0


@pytest.mark.parametrize("batch", (512, 262144))
def test_two_tower_serve_terms_are_the_reference_less_what_serving_skips(batch):
    """The serve call's own work: the reference's serve terms without the
    in-batch logits and the collective, plus the ids read and the scores
    written; fewer valid history rows read fewer bytes."""
    ref_cfg = ref_configs.two_tower_retrieval().cfg
    cfg = _port_config(ref_cfg)
    width, d = cfg.tower_mlp[-1], cfg.embed_dim
    r_flops, r_hbm, r_coll, _ = ref_model.recsys_terms(ref_cfg, batch, 1, "serve")
    flops, hbm, coll, model_flops = model.two_tower_serve_terms(cfg, batch)
    assert r_coll > 0 and coll == 0.0 and model_flops == flops
    assert flops == r_flops - 2.0 * batch * batch * width + 2.0 * batch * width
    assert hbm == r_hbm + batch * (2 + cfg.hist_len) * 4.0 + batch * 4.0
    fewer = model.two_tower_serve_terms(cfg, batch, hist_rows=batch)[1]
    assert hbm - fewer == batch * (cfg.hist_len - 1) * d * 4.0


LM_NAMES = ("granite-3-2b", "command-r-35b", "command-r-plus-104b", "deepseek-v2-236b",
            "deepseek-v3-671b")


@pytest.mark.parametrize("name", LM_NAMES)
def test_lm_train_terms_equal_the_reference_and_bound_the_card(name):
    from repro.archs.base import get_arch as ref_get_arch
    from repro_torch.archs import get_arch

    ref_arch, arch = ref_get_arch(name), get_arch(name)
    sh = arch.shapes["train_4k"]
    b, s = sh["global_batch"], sh["seq_len"]
    for chips in (1, 256):
        assert model.lm_train_terms(arch.cfg, b, s, chips, arch.grad_accum) == pytest.approx(
            ref_model.lm_train_terms(ref_arch.cfg, b, s, chips, ref_arch.grad_accum), rel=1e-12)
    flops, hbm, _, _ = model.lm_train_terms(arch.cfg, b, s, 1, arch.grad_accum)
    bd = model.lm_train_bound(arch.cfg, b, s, arch.grad_accum)
    assert bd["flops_attn"] + bd["flops_proj"] == pytest.approx(flops)
    # bf16 activations and weights: every product at the tensor cores' rate
    assert bd["t_compute"] == pytest.approx(flops / model.BF16_FLOPS)
    assert bd["t_memory"] == pytest.approx(hbm / model.HBM_BW)
    assert bd["bound_s"] == max(bd["t_compute"], bd["t_memory"])


def test_mace_terms_equal_the_reference_and_bound_the_card():
    from repro.archs.base import get_arch as ref_get_arch
    from repro_torch.archs import get_arch
    from repro_torch.archs.gnn import graph_size

    arch, ref_arch = get_arch("mace"), ref_get_arch("mace")
    for shape, sh in arch.shapes.items():
        n, e = graph_size(sh)
        for chips in (1, 4):
            got = model.mace_terms(arch.cfg_for(shape), n, e, chips, sh["mode"])
            want = ref_model.mace_terms(ref_arch._cfg_for(sh), n, e, chips, sh["mode"])
            assert got == pytest.approx(want, rel=1e-12), shape
        bd = model.mace_bound(arch.cfg_for(shape), n, e, sh["mode"])
        bf16 = sh["mode"] == "dst_partitioned"  # the one cell that computes in bf16
        assert arch.cfg_for(shape).compute_dtype == (torch.bfloat16 if bf16 else torch.float32)
        rate, width = (model.BF16_FLOPS, 2.0) if bf16 else (model.FP32_FLOPS, 4.0)
        assert bd["t_compute"] == pytest.approx(got[0] / rate)
        assert bd["t_memory"] == pytest.approx(got[1] * width / 4.0 / model.HBM_BW)
        assert bd["bound_by"] == ("operations" if bd["t_compute"] > bd["t_memory"] else "bytes")
