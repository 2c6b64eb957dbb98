"""Analytic roofline model for one NVIDIA H100 (port of the kernel, AIRSHIP,
recsys, LM and MACE parts of ``repro.roofline.model``).

Every bound is the larger of two times: the bytes the work must move over
the card's memory rate, and its operations over the card's peak rate for
their operands' type, whatever precision the port's code computes in:
bf16 operands at ``BF16_FLOPS`` (the tensor cores' rate), float32 ones at
``FP32_FLOPS`` (outside the tensor cores, TF32 off). The kernels' search
arithmetic is float32, so ``PEAK_FLOPS`` is that rate; the LM and MACE
bounds take the rate of their config's dtype.

Hardware constants: one NVIDIA H100 SXM5 80GB (NVIDIA H100 Tensor Core GPU
data sheet, SXM column; dense rates at the full 700 W power limit; the
Hopper architecture white paper for shared memory). A card set below 700 W
runs slower under load: state its ``power.limit`` beside any fraction of
these bounds.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.tune.config import effective_m_blk, register_path

HBM_BW = 3.35e12  # B/s, HBM3
FP32_FLOPS = 67e12  # FLOP/s, float32 outside the tensor cores
BF16_FLOPS = 989e12  # FLOP/s, bf16 on the tensor cores, dense
NVLINK_BW = 450e9  # B/s each way, NVLink 4 to the host's other cards
SMEM_BYTES = 232_448  # shared memory one block may use (227 KB of the SM's 256 KB)

PEAK_FLOPS = FP32_FLOPS  # the port's arithmetic
LINK_BW = NVLINK_BW

# The host, for CPU runs: deliberately round figures (the reference's),
# because fractions of the bound are compared across runs on one platform,
# where the constant cancels.
HOST_BW = 20e9  # B/s sustained single-socket DRAM stream
HOST_FLOPS = 100e9  # f32 FLOP/s, one core + modest SIMD


@dataclasses.dataclass
class RooflineTerms:
    cell: str
    mesh: str
    chips: int
    flops: float  # total FLOPs per step, summed over chips
    hbm_bytes: float  # total device-memory bytes per step, summed over chips
    coll_bytes: float  # per-chip wire bytes per step
    model_flops: float  # "useful" flops

    @property
    def t_compute(self) -> float:
        return self.flops / (self.chips * PEAK_FLOPS)

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / (self.chips * HBM_BW)

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        ts = {"compute": self.t_compute, "memory": self.t_memory,
              "collective": self.t_collective}
        return max(ts, key=ts.get)

    @property
    def step_time(self) -> float:
        """The largest of the three terms (they may overlap)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_fraction(self) -> float:
        return self.model_flops / max(self.flops, 1.0)

    @property
    def roofline_fraction(self) -> float:
        """Achievable MFU bound: useful flops / (step_time * peak)."""
        return self.model_flops / (self.step_time * self.chips * PEAK_FLOPS)


# ---------------------------------------------------------------------------
# LM transformers
# ---------------------------------------------------------------------------
def _lm_matmul_params(cfg) -> tuple[float, float]:
    """(total matmul params, active matmul params per token), the
    reference's count; ``cfg`` is a ``TransformerConfig``."""
    d = cfg.d_model
    if cfg.attn_type == "mla":
        per = cfg.kv_lora_rank * cfg.n_heads * (cfg.d_nope + cfg.d_v)  # wkv_b
        per += d * (cfg.kv_lora_rank + cfg.d_rope)  # wkv_a
        per += cfg.n_heads * cfg.d_v * d  # wo
        if cfg.q_lora_rank:
            per += d * cfg.q_lora_rank + cfg.q_lora_rank * cfg.n_heads * (cfg.d_nope + cfg.d_rope)
        else:
            per += d * cfg.n_heads * (cfg.d_nope + cfg.d_rope)
    else:
        per = d * cfg.n_heads * cfg.head_dim * 2 + d * cfg.n_kv_heads * cfg.head_dim * 2
    dense_ffn = 3 * d * cfg.d_ff
    moe_total = 3 * d * cfg.d_ff_expert * cfg.n_experts if cfg.is_moe else 0
    moe_active = 3 * d * cfg.d_ff_expert * cfg.top_k if cfg.is_moe else 0
    shared = 3 * d * cfg.d_ff_expert * cfg.n_shared_experts if cfg.is_moe else 0
    head = 2 * d * cfg.vocab_padded  # embed + lm_head
    total = cfg.n_dense * (per + dense_ffn) + cfg.n_moe * (per + moe_total + shared) + head
    active = cfg.n_dense * (per + dense_ffn) + cfg.n_moe * (per + moe_active + shared) + head
    if cfg.mtp:
        total += per + dense_ffn + 2 * d * d
        active += per + dense_ffn + 2 * d * d
    return float(total), float(active)


def _lm_attn_flops_fwd(cfg, batch: int, s_q: int, s_kv: int) -> float:
    """Score + PV products; the flash loop computes the full rectangle (the
    causal mask is applied, not skipped), so no / 2."""
    dh_qk = cfg.d_nope + cfg.d_rope if cfg.attn_type == "mla" else cfg.head_dim
    dh_v = cfg.d_v if cfg.attn_type == "mla" else cfg.head_dim
    return 2.0 * batch * cfg.n_heads * s_q * s_kv * (dh_qk + dh_v) * cfg.n_layers


def lm_train_terms(cfg, batch: int, seq: int, chips: int, grad_accum: int = 1):
    """(flops, hbm_bytes, coll_bytes, model_flops) of one train step of
    ``batch`` x ``seq`` tokens, the reference's terms: the products 6
    flops a parameter a token (8 under full remat, the forward again),
    attention's forward, its recompute and the FA2 backward (2.5 x);
    the parameters read and written 5 times in bf16, about 24 (T, D)
    activation passes a layer; the collective assumes a 16-way model
    axis."""
    tokens = batch * seq
    total_p, active_p = _lm_matmul_params(cfg)
    remat_mult = 8.0 if cfg.remat == "full" else 6.0
    mm_flops = remat_mult / 2.0 * 2.0 * active_p * tokens
    attn_flops = _lm_attn_flops_fwd(cfg, batch, seq, seq) * (1.0 + 1.0 + 2.5)
    flops = mm_flops + attn_flops
    model_flops = 6.0 * active_p * tokens
    p_bytes = total_p * 2.0
    hbm = p_bytes * 5.0 + 12.0 * 2.0 * cfg.n_layers * tokens * cfg.d_model * 2.0
    t_local = tokens / max(chips / 16, 1)
    layer_ar = 4.0 * t_local * cfg.d_model * 2.0 * cfg.n_layers * grad_accum
    coll = layer_ar + 3.0 * p_bytes / 16
    return flops, hbm, coll, model_flops


def lm_prefill_terms(cfg, batch: int, seq: int, chips: int):
    """(flops, hbm_bytes, coll_bytes, model_flops) of a prefill of
    ``batch`` x ``seq`` tokens, the reference's terms (its collective
    assumes a 16-way model axis)."""
    tokens = batch * seq
    total_p, active_p = _lm_matmul_params(cfg)
    flops = 2.0 * active_p * tokens + _lm_attn_flops_fwd(cfg, batch, seq, seq)
    model_flops = 2.0 * active_p * tokens
    hbm = total_p * 2.0 + 8.0 * cfg.n_layers * tokens * cfg.d_model * 2.0
    t_local = tokens / max(chips / 16, 1)
    coll = 4.0 * t_local * cfg.d_model * 2.0 * cfg.n_layers
    return flops, hbm, coll, model_flops


def lm_decode_terms(cfg, batch: int, s_cache: int, chips: int):
    """(flops, hbm_bytes, coll_bytes, model_flops) of one decode step over an
    ``s_cache``-token cache, the reference's terms: the weights and the
    whole cache read once."""
    total_p, active_p = _lm_matmul_params(cfg)
    flops = 2.0 * active_p * batch
    if cfg.attn_type == "mla":
        kv_row = cfg.kv_lora_rank + cfg.d_rope  # latent cache, no head dim
        attn = 2.0 * batch * cfg.n_heads * s_cache * (kv_row + cfg.kv_lora_rank)
        cache_bytes = batch * s_cache * kv_row * 2.0 * cfg.n_layers
    else:
        attn = 2.0 * batch * cfg.n_heads * s_cache * 2 * cfg.head_dim
        cache_bytes = 2.0 * batch * s_cache * cfg.n_kv_heads * cfg.head_dim * 2.0 * cfg.n_layers
    attn *= cfg.n_layers
    flops += attn
    model_flops = 2.0 * active_p * batch + attn
    hbm = total_p * 2.0 + cache_bytes
    coll = 4.0 * batch * cfg.d_model * 2.0 * cfg.n_layers / max(chips / 16, 1)
    return flops, hbm, coll, model_flops


def _rate(dtype) -> float:
    """The card's peak rate for operands of ``dtype``."""
    return BF16_FLOPS if dtype in (torch.bfloat16, torch.float16) else FP32_FLOPS


def _lm_bound(cfg, flops_attn: float, flops_proj: float, hbm: float) -> dict:
    """The attention products over the rate of the activations' dtype
    (``cfg.compute_dtype``), the projections over that of the weights'
    (``cfg.param_dtype``), the bytes over ``HBM_BW``."""
    t_compute = flops_attn / _rate(cfg.compute_dtype) + flops_proj / _rate(cfg.param_dtype)
    t_memory = hbm / HBM_BW
    return dict(flops_attn=flops_attn, flops_proj=flops_proj, hbm_bytes=hbm, t_compute=t_compute,
                t_memory=t_memory, bound_s=max(t_compute, t_memory),
                bound_by="operations" if t_compute > t_memory else "bytes")


def lm_serve_bound(cfg, kind: str, batch: int, seq: int) -> dict:
    """The least time one card could take for a prefill (``kind``
    "prefill": ``batch`` x ``seq`` tokens) or one decode step ("decode":
    ``batch`` tokens over a ``seq``-token cache), from the reference's
    terms on one chip, counted as ``_lm_bound`` does. -> {"flops_attn",
    "flops_proj", "hbm_bytes", "t_compute", "t_memory", "bound_s",
    "bound_by"}."""
    _, active_p = _lm_matmul_params(cfg)
    if kind == "prefill":
        flops, hbm, _, _ = lm_prefill_terms(cfg, batch, seq, 1)
        flops_proj = 2.0 * active_p * batch * seq
    elif kind == "decode":
        flops, hbm, _, _ = lm_decode_terms(cfg, batch, seq, 1)
        flops_proj = 2.0 * active_p * batch
    else:
        raise ValueError(f"unknown kind {kind!r}")
    return _lm_bound(cfg, flops - flops_proj, flops_proj, hbm)


def lm_train_bound(cfg, batch: int, seq: int, grad_accum: int = 1) -> dict:
    """The least time one card could take for one train step of ``batch`` x
    ``seq`` tokens, from ``lm_train_terms`` on one chip, counted as
    ``_lm_bound`` does (the projections ``remat`` x 2 flops a parameter a
    token). -> the keys of ``lm_serve_bound``."""
    flops, hbm, _, _ = lm_train_terms(cfg, batch, seq, 1, grad_accum)
    flops_attn = _lm_attn_flops_fwd(cfg, batch, seq, seq) * (1.0 + 1.0 + 2.5)
    return _lm_bound(cfg, flops_attn, flops - flops_attn, hbm)


# ---------------------------------------------------------------------------
# MACE GNN
# ---------------------------------------------------------------------------
def mace_terms(cfg, n_nodes: int, n_edges: int, chips: int, mode: str):
    """(flops, hbm_bytes, coll_bytes, model_flops) of one MACE train step,
    the reference's terms: per edge the radial MLP and 13 message
    components, per node the 8K -> K update and ~40 K flops of invariants,
    6 x the forward (its backward and the force's double backward); 16
    float32 (E, K) and 13 + d_feat (N, K) passes a layer, 3 times; one
    all-gather of h a layer in the dst-partitioned layout."""
    k = cfg.d_hidden
    edge_flops = n_edges * (
        2 * (cfg.n_rbf * cfg.d_radial_mlp + cfg.d_radial_mlp * 3 * k) + 2 * 13 * k)
    node_flops = n_nodes * (2 * 8 * k * k + 40 * k)
    fwd = (edge_flops + node_flops) * cfg.n_layers
    flops = fwd * 6.0
    feat = cfg.d_feat if cfg.d_feat else cfg.n_species
    hbm = (n_edges * (13 + 3) * k * 4.0 * cfg.n_layers * 3.0
           + n_nodes * (13 * k + feat) * 4.0 * 3.0)
    if mode == "dst_partitioned":
        coll = cfg.n_layers * 3.0 * n_nodes * k * 2.0
    elif mode == "simple":
        coll = 0.0
    else:
        coll = n_nodes * k * 4.0
    return flops, hbm, coll, flops


def mace_bound(cfg, n_nodes: int, n_edges: int, mode: str) -> dict:
    """The least time one card could take for one MACE train step, from
    ``mace_terms`` on one chip (no collective: every shard is on the card):
    the flops over the rate of ``cfg.compute_dtype``, the bytes (the
    reference's terms count 4 B an element) at that dtype's width over
    ``HBM_BW``. -> {"flops", "hbm_bytes", "t_compute", "t_memory",
    "bound_s", "bound_by"}."""
    flops, hbm, _, _ = mace_terms(cfg, n_nodes, n_edges, 1, mode)
    hbm *= torch.empty((), dtype=cfg.compute_dtype).element_size() / 4.0
    t_compute, t_memory = flops / _rate(cfg.compute_dtype), hbm / HBM_BW
    return dict(flops=flops, hbm_bytes=hbm, t_compute=t_compute, t_memory=t_memory,
                bound_s=max(t_compute, t_memory),
                bound_by="operations" if t_compute > t_memory else "bytes")


# ---------------------------------------------------------------------------
# RecSys
# ---------------------------------------------------------------------------
def _mlp_params(dims) -> float:
    return float(sum(a * b for a, b in zip(dims[:-1], dims[1:])))


def recsys_terms(cfg, batch: int, chips: int, kind: str, n_candidates: int = 0):
    """(flops, hbm_bytes, coll_bytes, model_flops) of one recsys step, the
    reference's terms; ``cfg`` is a ``RecsysConfig``."""
    d = cfg.embed_dim
    if cfg.model == "dlrm":
        n_f = len(cfg.vocab_sizes) + 1
        mlp_p = _mlp_params((cfg.n_dense,) + cfg.bot_mlp) + _mlp_params(
            (n_f * (n_f - 1) // 2 + cfg.bot_mlp[-1],) + cfg.top_mlp)
        inter_flops = 2.0 * batch * n_f * n_f * d
        lookup_rows = batch * len(cfg.vocab_sizes)
    elif cfg.model == "deepfm":
        n_f = len(cfg.vocab_sizes)
        mlp_p = _mlp_params((n_f * d,) + cfg.mlp + (1,))
        inter_flops = 2.0 * batch * n_f * d
        lookup_rows = batch * n_f * 2
    elif cfg.model == "sasrec":
        mlp_p = 8.0 * d * d * cfg.n_blocks
        inter_flops = (4.0 * batch * cfg.seq_len**2 * d * cfg.n_blocks
                       + 2.0 * batch * cfg.seq_len * d)  # scoring
        lookup_rows = batch * cfg.seq_len * 3
    else:  # two_tower
        mlp_p = _mlp_params((2 * d,) + cfg.tower_mlp) + _mlp_params((d,) + cfg.tower_mlp)
        inter_flops = 2.0 * batch * batch * cfg.tower_mlp[-1]  # in-batch logits
        lookup_rows = batch * (2 + cfg.hist_len)

    mm = 2.0 * mlp_p * batch
    mult = 6.0 if kind == "train" else 2.0
    flops = mm / 2.0 * mult + inter_flops * (3.0 if kind == "train" else 1.0)
    cand_w = cfg.tower_mlp[-1] if cfg.model == "two_tower" else d
    if n_candidates:
        flops += 2.0 * batch * n_candidates * cand_w
    model_flops = flops
    emb_traffic = lookup_rows * d * 4.0 * (2.0 if kind == "train" else 1.0)
    hbm = emb_traffic + mlp_p * 4.0 * (3.0 if kind == "train" else 1.0)
    if n_candidates:
        hbm += n_candidates * cand_w * 4.0
    # sharded-table lookups: psum of gathered rows across the model axis
    coll = lookup_rows / max(chips / 16, 1) * d * 4.0
    return flops, hbm, coll, model_flops


def two_tower_serve_terms(cfg, batch: int, hist_rows: Optional[int] = None):
    """(flops, hbm_bytes, coll_bytes, model_flops) of one two-tower serve
    call on one card (serve_p99 / serve_bulk: ``archs/recsys.py``'s
    ``serve_scores``), the work it does. ``recsys_terms`` (the reference's)
    also counts the in-batch logits of training (2 B^2 x width) and a
    collective of a sharded table, neither of which this call makes.
    Flops: both towers' products (2 a weight a user) and the B row dots.
    Bytes, each input read once and the output written once: the user and
    item rows and ``hist_rows`` history rows (default B x hist_len, every
    slot valid), their int32 ids, the towers' weights, the (B,) scores."""
    d, width = cfg.embed_dim, cfg.tower_mlp[-1]
    mlp_p = _mlp_params((2 * d,) + cfg.tower_mlp) + _mlp_params((d,) + cfg.tower_mlp)
    hist = batch * cfg.hist_len if hist_rows is None else hist_rows
    flops = 2.0 * mlp_p * batch + 2.0 * batch * width
    rows = 2.0 * batch + hist  # user row, item row, the history bag's valid rows
    ids = batch * (2.0 + cfg.hist_len)  # every id slot, padding included
    hbm = rows * d * 4.0 + ids * 4.0 + mlp_p * 4.0 + batch * 4.0
    return flops, hbm, 0.0, flops


# ---------------------------------------------------------------------------
# Per-config kernel roofline (the tuner's)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class KernelRoofline:
    """Predicted cost of ONE kernel launch at a fixed config: the
    reference's flop count, the device-memory bytes it moves, the shared
    memory a block stages, and ``ops``, the float32 operations the CUDA
    kernel does (None: ``flops``), which the card's compute term counts."""

    flops: float
    hbm_bytes: float
    smem_bytes: float
    ops: Optional[float] = None

    def t_compute(self, platform: str = "cuda") -> float:
        if platform == "cuda":
            return (self.flops if self.ops is None else self.ops) / PEAK_FLOPS
        return self.flops / HOST_FLOPS

    def t_memory(self, platform: str = "cuda") -> float:
        return self.hbm_bytes / (HBM_BW if platform == "cuda" else HOST_BW)

    def time_bound(self, platform: str = "cuda") -> float:
        return max(self.t_compute(platform), self.t_memory(platform))

    def memory_bound(self, platform: str = "cuda") -> bool:
        return self.t_memory(platform) >= self.t_compute(platform)

    def bound_by(self, platform: str = "cuda") -> str:
        return "bytes" if self.memory_bound(platform) else "operations"


def work_bound(n_bytes: float, n_ops: float, platform: str = "cuda") -> tuple[float, str]:
    """(least seconds, "bytes" or "operations") of work that moves
    ``n_bytes`` and does ``n_ops`` float32 operations."""
    r = KernelRoofline(flops=float(n_ops), hbm_bytes=float(n_bytes), smem_bytes=0.0)
    return r.time_bound(platform), r.bound_by(platform)


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def _adc_blocks_per_query(config, m: int) -> int:
    """Blocks of fused_expand_adc a query's M candidates take."""
    return -(-m // effective_m_blk(config, m, kernel="fused_adc"))


def _pq_group(d: int, n_cent: int) -> int:
    """Queries pq_adc.cu stages a block: the largest power of two up to 32
    whose tables fit a block's shared memory."""
    fit = SMEM_BYTES // (d * n_cent * 4)
    q = 32
    while q > 1 and q > fit:
        q //= 2
    return q


def kernel_bytes(kernel: str, config, *, b: int, m: int, d: int, n_cent: int = 16,
                 family: str = "label", tomb: bool = False) -> dict:
    """The device-memory bytes of one launch, by named term. The CUDA
    kernels pad no tile, so every term is the kernel's own traffic at this
    shape, each candidate's words counted at each occurrence."""
    cand = b * m
    if kernel == "pq_adc":
        return {
            "codes": m * d * 4.0,  # (N, m_sub) int32 code rows, read once
            "lut": b * d * n_cent * 4.0,  # each query's table, once
            "out": cand * 4.0,  # (B, N) float32 distances
        }
    terms = {
        "rows": cand * d * 4.0,  # f32 corpus row / int32 code row a candidate
        "ids": cand * 4.0,  # (B, M) int32 candidate ids
    }
    if kernel == "gather_distance":
        terms["query"] = b * d * 4.0  # (B, d) query rows
        terms["out"] = cand * 4.0  # (B, M) float32 distances
        return terms
    if kernel not in ("fused_exact", "fused_adc"):
        raise ValueError(f"unknown kernel {kernel!r}")
    if kernel == "fused_exact":
        terms["query"] = b * d * 4.0
    else:
        # Each block stages its query's whole (m_sub, n_cent) table: in the
        # walk the tables are mostly out of L2, so every block's copy is
        # device-memory traffic (the term the config moves).
        terms["lut"] = b * _adc_blocks_per_query(config, m) * d * n_cent * 4.0
    terms["meta"] = cand * 4.0  # meta[id]: label, value or verdict
    terms["visited"] = cand * 4.0  # the visited word (b, id >> 5)
    terms["cons"] = {"label": cand * 4.0, "range": b * 8.0, "udf": 0.0}[family]
    terms["tomb"] = cand * 4.0 if tomb else 0.0  # the tombstone word id >> 5
    terms["out"] = cand * 6.0  # float32 distance + two bool masks
    return terms


def kernel_roofline(kernel: str, config, *, b: int, m: int, d: int, n_cent: int = 16,
                    family: str = "label", tomb: bool = False) -> KernelRoofline:
    """Roofline terms for one tuned kernel at (batch b, candidates m).

    ``d`` is the payload width: the vector dim for fused_exact /
    gather_distance, m_sub for fused_adc / pq_adc (for pq_adc ``m`` is the
    corpus rows the scan covers). ``flops`` are the reference's: 3 a row
    element (subtract, square, add) and, for the ADC kernels, its one-hot
    scan's 3 per table entry. The CUDA ADC kernels look one entry up a
    subspace and add it, so their ``ops`` (the card's compute term) are one
    add a subspace; the row kernels' are the reference's. ``smem_bytes``:
    what a block stages in shared memory at ``config``.
    """
    hbm = sum(kernel_bytes(kernel, config, b=b, m=m, d=d, n_cent=n_cent, family=family,
                           tomb=tomb).values())
    if kernel in ("fused_exact", "gather_distance"):
        flops = ops = 3.0 * b * m * d
        # The register path (d % 4 == 0, d <= 256) keeps the query in
        # registers; the shared-memory path stages its row as float4s.
        smem = 0.0 if register_path(d) else _round_up(d, 4) * 4.0
    else:
        flops, ops = 3.0 * b * m * d * n_cent, float(b * m * d)
        table = d * n_cent * 4.0
        if kernel == "pq_adc":
            smem = _pq_group(d, n_cent) * table
        else:
            cons = {"label": 4.0, "range": 8.0, "udf": 0.0}[family]
            staged = _round_up(d * n_cent, 4) * 4.0 + cons
            smem = staged if staged <= SMEM_BYTES else 0.0  # else read in device memory
    return KernelRoofline(flops=float(flops), hbm_bytes=float(hbm), smem_bytes=float(smem),
                          ops=float(ops))


def prune_configs(kernel: str, configs, *, b: int, m: int, d: int, n_cent: int = 16,
                  platform: str = "cuda"):
    """Split a config lattice into (survivors, pruned) before timing.

    A config is pruned when (a) a block's staged shared memory exceeds
    ``SMEM_BYTES``, or (b) the model says the kernel is memory-bound at
    this shape AND the config moves strictly more bytes than the best
    config. Compute-bound shapes keep every feasible config.
    """
    terms = {cfg: kernel_roofline(kernel, cfg, b=b, m=m, d=d, n_cent=n_cent)
             for cfg in configs}
    feasible = {c: t for c, t in terms.items() if t.smem_bytes <= SMEM_BYTES}
    best_bytes = min((t.hbm_bytes for t in feasible.values()), default=0.0)
    survivors, pruned = [], []
    for cfg in configs:
        t = terms[cfg]
        if cfg not in feasible or (t.memory_bound(platform) and t.hbm_bytes > best_bytes):
            pruned.append(cfg)
        else:
            survivors.append(cfg)
    return survivors, pruned


# ---------------------------------------------------------------------------
# AIRSHIP constrained search (serve)
# ---------------------------------------------------------------------------
def airship_terms(cfg, batch: int, chips: int, est_iters: float = 200.0, tp: int = 16):
    """(flops, hbm_bytes, coll_bytes, model_flops) of one batch of walks;
    ``cfg`` is an ``AirshipServeConfig``. ``tp``: the corpus shards a query
    is searched on (scatter-search-merge runs tp walks a query); the
    reference hard-codes 16, the default here."""
    d = cfg.dim
    # Per query per iteration: gather degree rows + distances; each of the
    # tp shards runs the full walk on its shard.
    per_iter_flops = 3.0 * cfg.degree * d  # sub + square + add
    flops = batch * tp * est_iters * per_iter_flops + batch * tp * (
        cfg.sample_per_shard * 3.0 * d)
    model_flops = flops
    hbm = batch * tp * est_iters * cfg.degree * d * 4.0  # the gathers
    k = cfg.params.k
    coll = batch / max(chips / tp, 1) * tp * k * 8.0  # final all-gather merge
    return flops, hbm, coll, model_flops
