"""Drive the PyTorch / CUDA port of AIRSHIP on one NVIDIA GPU.

    python3 chip_smoke.py [--n 1000000] [--seed 0]

Phases, any failure exits non-zero:

  1. environment: the card's name and power limit (nvidia-smi), versions,
     TF32 off for every float32 matrix product;
  2. build: the seven CUDA kernels from src/repro_torch/csrc (one nvcc
     each, started together);
  3. kernels: each kernel against its plain PyTorch version on the card at
     the search's shapes (n = 1M, d = 128, B = 256, M = 32 and 128; PQ
     m_sub = 16, n_cent = 256) and on edge cases (padding ids, M = 1, M not
     a multiple of 32, the three constraint families with and without
     tombstones, words with bit 31 set, codes at 0 and n_cent - 1, B = 1,
     N = 1000, n_cent = 16; fused_expand also at d = 256, d = 13 and an
     unaligned query row, with label rows of 1 and 63 words, its distances
     gather_distance's bits; fused_expand_adc also with tables of 64 KB,
     227 KB and 256 KB): the exact-row kernels exact on integer-valued
     inputs and within 1e-5 relative on float inputs, the PQ kernels exact
     on integer and float LUTs alike (every path adds the m_sub entries in
     one pinned order), masks exact; l2_matmul at the index build's
     (1024, n, 128) and on edge cases (M = 1, ragged M / N / d, d = 1,
     identical rows), exact on integer inputs and within
     1e-5 * (|q|^2 + |x|^2) on float inputs; device time of each against
     its bound (gather_distance also at airship_tt_256's d = 256, pq_adc
     also against its shared-memory lookup floor; the small launches of
     gather_distance, fused_expand and fused_expand_adc beside a launch
     floor, one out.zero_() over the same (B, M) output), pq_adc's against one
     torch.nn.functional.embedding_bag call and l2_matmul's against one
     torch.cdist call; embedding_bag over the
     two-tower item table ((50,000,128, 256), 51.2 GB) at serve_bulk's
     (262,144 x 50) and serve_p99's (512 x 50) bags and on edge cases (a bag
     of padding only, L = 1, B = 1, D = 10 and 50 on the scalar path, rows
     V - 1 and around the 2**31-element mark, mode="mean"), exact on integer
     and float tables, timed against its bound, its plain version and one
     torch.nn.functional.embedding_bag call. gather_distance runs at the
     tuning table's configs for the walk's keys
     (src/repro_torch/tune/table.json; the other tuner kernels have one
     shape), and every bound comes from the
     roofline model (src/repro_torch/roofline/model.py), each distinct row
     counted once, with kernel_roofline's per-occurrence bound beside it;
  3b. tune: for gather_distance, fused_expand, fused_expand_adc and pq_adc
     at the main path's shapes, every point of the tuner's lattice (one
     point, the default, for all but gather_distance) against the default
     config bit for bit (distances and verdict masks), and the table's
     choice timed against the default (a `tune {...}` line each);
  4. small world: the same searches on the card and on the CPU (plain
     versions) over an integer-valued world, exact and PQ, plus the PQ
     linear scan, must agree bit for bit; so must nn_descent with the same
     draws, and a 4-shard build_partitioned_index must give the same
     padded corpus and entries and the same kNN adjacency up to distance
     ties; the two-tower model at the published widths with a 4,096-row
     vocab and 64 users, the same weights on the card and the CPU: bags bit
     for bit, towers within 1e-5 abs, retrieval top-100 ids equal above
     every score gap > 1e-4;
  5. world: the airship-sift1m configuration (n = 1,000,000, d = 128, 10
     k-means labels, degree 32, sample 128) generated and indexed on the
     card: the exact kNN graph through l2_matmul (its time split into
     products, top-k and reverse edges, and its launch count checked), an
     NN-descent index of the same world through gather_distance
     (NND_ITERS rounds, one launch a round; its time split into distances,
     sorts and the rest, its graph invariants and its kNN recall@32 against
     the exact graph; gather_distance timed at a round's shape and at
     NND_CHUNK-row chunks with a real round's ids), and the PQ codebooks
     (m_sub = 16, n_cent = 256);
  6. search: 256 queries, equal-label constraint, prefer mode, through
     serve_256 (gather_distance), serve_256_beam4, serve_256_fused
     (fused_expand), serve_256_pq (ADC walk + exact re-rank),
     serve_256_pq_fused (fused_expand_adc), serve_256_nnd (serve_256 over
     the NN-descent index) and pq_scan_256 (the PQ linear scan, pq_adc),
     with launch counts, fused == unfused for both backends, recall@10 >=
     0.5 on every graph walk, and the scan equal to its plain version on
     the card;
  7. two-tower-retrieval (RecSys'19 YouTube two-tower: dim 256, towers
     1024-512-256, history 50; item_vocab 50M as published, user_vocab cut
     to 10M to fit the card), after the airship-sift1m world is freed,
     random weights from --seed: serve_p99 (512 users), serve_bulk
     (262,144) and retrieval_cand (1 user against the item tower's
     embeddings of items 0..n-1, top-100), each one embedding_bag launch;
     then AIRSHIP constrained retrieval over those n embeddings (10 random
     categories, exact index, degree 32, sample 128; 256 user-tower
     queries, one wanted category each; prefer, use_kernel, ef_result and
     max_iters TT_EF_RESULT / TT_MAX_ITERS) with recall@10 >= 0.5 against
     the exact oracle and every returned item in its category; the device
     busy share of one serve_bulk batch; peak device memory.
  8. recsys training, after phase 7's tables are freed. The embedding
     bag's backward kernel (no TPU counterpart: the gradient of
     embedding_bag_sum) against its plain version, bit for bit, on integer
     and float gradients, sum and mean, repeated ids, all-padding bags, ids
     >= V, D = 256, 10, 128 and 13; its device time at the two-tower train
     batch's bag (B = 65,536, L = 50, D = 256, V = 4M, 30% padding) beside
     its bound (the dense (V, D) output written once, g and the ids read),
     its plain version and one index_add_ of the masked rows into a zeroed
     (V, D). Then AdamW (lr 1e-3) steps through
     get_arch(name).make_cell("train_batch") and shape_batch at B = 65,536,
     TF32 off, random weights from --seed: train_deepfm (the published
     DeepFM, 39 fields, dim 10, MLP 400-400-400, 7,127,808 padded rows;
     nothing cut; 5 steps), train_dlrm_mlperf (MLPerf widths: dim 128,
     bottom 512-256-128, top 1024-1024-512-256-1; cut: each of the 26
     tables capped at 4,000,000 rows, 187,771,136 -> 24,067,072 padded
     rows; 3 steps) and train_two_tower (published widths: dim 256, towers
     1024-512-256, history 50; cut: user_vocab and item_vocab 50M -> 4M;
     the streamed logsumexp runs 16 chunks of 4,096; 3 steps, each one
     embedding_bag and one embedding_bag_backward launch). One `train
     {...}` line each (init, first and warm step wall ending in a sync,
     examples/s, every step's loss, peak device memory, launches) and
     `profile train_two_tower`; any loss not finite, any parameter leaf
     unchanged or any bag launch count off fails the run.
  9. attention, SASRec and dense-GQA LM serving, after phase 8 (no ported
     kernel lies on this path: the reference's attention is plain JAX).
     9a: flash_attention (models/common/flash.py) forward and backward
     against F.scaled_dot_product_attention (the yardstick, never the
     path; causal, enable_gqa, gradients by torch.autograd.grad) in
     float32 at granite's heads (B 1, S 4,096, H 32 / 8, dh 64, chunk 512)
     and at SASRec's train batch (B 65,536, S 50, H 1, dh 50, chunk 50):
     outputs within ATTN_OUT_TOL, gradients within ATTN_GRAD_RTOL of their
     largest, card == CPU on a small case; one `attn {...}` line a shape
     (CUDA events). 9b: SASRec at its published config (arXiv 1808.09781:
     dim 50, 2 blocks, 1 head, seq 50, item_vocab 1M; nothing cut): 3
     AdamW steps of train_batch at B 65,536 (finite losses, every leaf
     moves), serve_p99 (512 x 100 candidates), serve_bulk (262,144 x 100)
     and retrieval_cand (1 x 1,000,000); one `sasrec {...}` line each (wall
     ending in a sync, users/s or examples/s, peak memory). 9c:
     granite-3-2b at full width and depth (40 layers, bf16 weights from
     --seed, 2.64e9 parameters): decode == teacher forcing at 2 layers of
     its width in float32 (2e-3) and bf16 (0.1); prefill_32k at batch 1
     (cut from 32), decode_32k at batch 16 (cut from 128; a 42.9 GB cache)
     and long_500k as published (a 524,288-token cache, 42.9 GB), 8 decode
     steps from random bf16 caches at the last 8 positions, one cache alive
     at a time; every logit finite, the cache's data_ptr unchanged across
     each step; one `lm {...}` line each (wall, tokens/s, peak memory,
     kernel launches a step, the bound from lm_serve_bound) and `profile
     decode_32k` / `profile long_500k`. 9d, after 9c's model and caches are
     freed: deepseek-v2-236b (MLA with q_lora 1536 and kv_lora 512, 160
     experts top-6 + 2 shared, expert d_ff 1536, vocab 102,400) at full
     width, bf16 weights from --seed, depth cut from 1 dense + 59 MoE
     layers to 1 + 4 (17.28e9 parameters); decode == teacher forcing at 2
     MLA layers of its width with no experts, float32 (2e-3) and bf16 (0.1);
     prefill_32k at batch 1 (cut from 32), decode_32k at batch 128 (a 24.2
     GB latent cache) and long_500k (3.0 GB), 8 decode steps each from a
     random bf16 cache at its last 8 positions, long_500k again on a (1, 4)
     mesh of the card (four sequence shards, the MoE expert-parallel over
     4) with every step's logits within DS_MESH_TOL of the one-device
     run's; one `lm {...}` line a cell (as 9c's, plus the share of routed
     (token, expert) pairs each MoE layer's capacity drops) and `profile
     decode_32k_v2` / `profile long_500k_v2`; deepseek-v3-671b's
     param_count on the meta device.
 10. LM training (no ported kernel on this path), train_4k through
     LMArch.make_cell (lm_loss: chunked CE, MTP, the router's aux loss;
     Adafactor or AdamW, clip 1.0, the arch's grad_accum, remat "full"):
     card == CPU (train.parity) for two steps of smoke-gqa (AdamW) and
     smoke-mla-moe with router_aux_coef 0.01 (Adafactor, grad_accum 2),
     each limit against its control, then granite-3-2b at
     full width and depth, deepseek-v2-236b at full width (160 experts)
     cut to 1 dense + 1 MoE layer, and deepseek-v3-671b's 3 dense layers
     and MTP block at full width, batches cut (LM_TRAIN_CELLS); one
     `lm_train {...}` line each (init, first and warm step wall ending in
     a sync, tokens/s, peak memory, lm_train_bound and the share the wall
     reaches, every metric, every leaf moved).
 11. MACE (no ported kernel on this path) through GNNArch.make_cell,
     AdamW: card == CPU (train.parity) for two steps of each smoke-mace
     cell; the dst-partitioned loss over 4 shards of the card == the simple loss
     (float32, 1e-5); full_graph_sm and molecule as published,
     minibatch_lg on subgraphs sampled on the card from a synthetic graph
     of reddit's size (a fresh one a step), ogb_products in bf16 over a
     (1, 16) mesh of the card at the largest cut of its published size
     that a calibration run predicts to fit; one `mace {...}` line each
     (as phase 10's, with nodes / edges / examples a second and the bound
     from mace_bound). The launch counts read after phases 10-11 must be
     0.

Between 6 and 7, phase 6b, streaming and hybrid, over phase 6's corpus,
exact index, queries and search parameters (attrs (n, 2) uniform from a
generator of its own): StreamingIndex.from_static (capacity 1.5M,
ef_insert 32, seed --seed); 10,000 deletes, every query's true top-1
among them; serve_256 and serve_256_fused over the published snapshot
(no tombstoned id returned, fused == unfused in ids, dists and every
stat, recall@10 >= 0.5 against the exact oracle on the tombstoned
corpus); 64 inserts of live rows plus 0.01 noise (per-insert wall p50 /
p99, the publish time, one gather_distance launch an insert, each new
row's invariants, the share a walk finds at distance 0 held to
REACH_FLOOR); consolidate() of every pending slot (its wall and
gather_distance launches, slot accounting, histograms and postings
exact, the invariants of every rewritten row, no edge into a freed
slot, a live entry vertex); 64 more inserts, which must take the
reclaimed slots in LIFO order; serve_256 again (recall floor, no dead
id); the strategy router over the index's histograms, postings and
range postings (10 labels, three range windows of ~0.05%, ~2% and ~30%
-> posting, posting, graph); posting_search with gather_distance on the
two posting windows, against the exact oracle up to distance ties (1e-5
relative) and equal to the plain scan on integer rows; one label's
overlay (~100k rows, degree 32, l2_matmul) searched by 256 queries near
that label's rows (every id a live posting, recall@10 >= 0.5). It
prints `inserts`, `streaming` and `hybrid` lines; its launches join the
totals of the kernels line.

Phase 6c, serving, follows 6b over the same world (attrs (n, 2) uniform
from a generator of its own): repro_torch.serving's runtime, with the
tier ladder make_tier_ladder(k_cap=16, base_ef=128, base_iters=512,
base_n_start=32, n_tiers=2) (airship-sift1m's SearchParams as tier 0, a
4x escalation tier), bucket ladder (8, 32, 128), families label and range,
max_wait 0.005, on a VirtualClock, the stream mixed_workload(7, corpus,
1024, 10, k_choices=(4, 8, 16)) replayed with Poisson arrivals at 20,000
a second (seed 11). The runtime sets use_kernel on every tier of a card
executor, so each distance goes through gather_distance. serve_mixed_1m
(over phase 6's index, with a JSON log; warmup must build exactly the
12-closure trace budget and no request may miss the closure cache after
it; one 128-row flush profiled), serve_mixed_1m_fused (the same stream,
fuse_expand="on"), deterministic drains of the stream's first 64
requests under both tier sets (every response equal: ids, dists, filled,
tier, escalations), serve_hybrid_1m (the stream's first 256 requests with
the strategy router; an overlay route must build through l2_matmul),
serve_churn_1m (a fresh StreamingIndex.from_static, capacity 1.5M,
ef_insert 32, under StreamingLocalExecutor(consolidate_after=64);
churn_workload(7, corpus, 512, 10, mutation_frac=0.3) through
replay_churn; at least one consolidation under serving, no served id
tombstoned at its response's epoch, slot accounting and stats exact after
it) and serve_mixed_1m_pq (the first 128 requests, approx="pq",
fuse_expand="on" over phase 5's codebooks); hybrid and pq are cut to
bound the phase's time. Every replay accounts for every request
(served + shed + mutations + rejected == submitted), every served id
satisfies its request's constraint, every stage breakdown tiles its
latency, and the closures stay within the trace budget; recall@k of the
three exact replays against the exact oracle on the same constraints is
>= 0.5 per family. Then the launcher runs end to end at its own default
shape (n = 20,000, d = 32: corpus, exact index through l2_matmul, warmup,
64 requests, --log-json into build/). It prints one `serving {...}` line
per replay and `profile serve_mixed_1m`; its launches join the kernels
line's totals. In phase 4, one 64-request mixed stream drained through
the runtime on the card and on the CPU (default tiers, unfused and
fused) must agree bit for bit, and the card's drains must launch
gather_distance / fused_expand.

Phase 6d, scale-out, follows 6c over the same world (attrs (n, 2) uniform
from a generator of its own). Distributed: build_partitioned_index with 4
shards of 250,000 rows (exact through l2_matmul, degree 32, sample 128 a
shard), placed on a (1, 4) mesh whose four positions are all cuda:0;
make_distributed_search (archs/airship.py's serve_search) over
AIRSHIP_SHAPES serve_256, serve_256_fused, serve_256_pq_fused (phase 5's
codebooks, codes split by rows) and serve_bulk_8k (8,192 queries of their
own), equal-label constraints, plus one range batch (windows of 0.3 on
column 0); recall@10 >= 0.5 against the exact oracle on the partitioned
corpus, every id inside its constraint, fused == unfused, the (1, 4)
result equal bit for bit to the per-shard composition by hand (4
constrained_search calls and a stable merge), and a (1, 1) mesh over phase
6's own index equal to constrained_search; one `distributed {...}` line a
shape (batch wall, QPS, iters = the max over shards, recall, each shard's
walk wall) and `profile dist_256_p4 shard 0` (one shard's walk). Replicas
over HTTP: ServingFrontend on 127.0.0.1:0 over a 2-replica ReplicaSet
sharing phase 6's static index
(wall clock, phase 6c's tiers and ladder), 64 mixed label and range
requests from 8 client threads, /metrics parsed with parse_exposition and
held to each replica's telemetry, /healthz, /varz, close() losing no
request (`http {...}` line: req/s on the wall clock, client p50 / p99,
each replica's share, the scrape's size); then two streaming replicas,
each its own 1.5M-slot pool: one upsert and one delete broadcast over
HTTP, equal epochs, equal answers on both replicas, the dead slot never
served. The launcher: `python -m repro_torch.launch.serve --n 20000
--serve-http 0 --replicas 2` in a subprocess (its address read from its
output, 4 requests, SIGTERM, its shutdown report checked), and main()
with --distributed (a 1x1 mesh on the card). Phase 7 adds retrieval_cand
with two_phase_topk on a (1, 4) mesh, equal to the single-device top-100
up to ties. Request counts are cut for time (PERF.md §4), never widths.

Phases 6, 6d and 7 print a `roofline {...}` line for serve_256,
dist_256_p4 (airship_terms, the measured iters as est_iters, tp 1 and 4,
one chip) and serve_bulk_tt (two_tower_serve_terms, the work the serve
call does; the reference's recsys_terms beside it as reference_terms,
which count in-batch logits serving never computes) beside the measured
wall.

It prints a {"kernels": [...]} line (each kernel's tuned config, null for
l2_matmul, embedding_bag and embedding_bag_backward) and, last, {"ok": true, "device": ...}.
It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

# Phase 7's 51.2 GB item table needs one 47.7 GiB range after phases that
# cycle tens of GB of temporaries through the caching allocator (phase 6d's
# 8,192-query oracle and walks): expandable segments let it hand partly
# used cache back to the card instead of pinning whole segments.
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import torch  # noqa: E402 (after the allocator's setting)

L2_BYTES = 50 * 2**20
B, D_MAIN = 256, 128
TT_DIM = 256  # the two-tower item tower's output width (airship_tt_256's d)
NND_CHUNK = 65535  # rows of the chunks NN-descent once launched a round in (timed to compare)
BUILD_BLOCK = 1024  # rows of one pairwise block of the exact kNN build
# NN-descent rounds of the serve_256_nnd index. The reference's default of
# 8 leaves the walk below its recall floor at n = 1M (its kNN recall@32 is
# 0.03 there); 128 rounds reach 0.32 and hold the floor (PERF.md).
NND_ITERS = 128
# two-tower-retrieval (phase 7): the published item table (50M rows,
# 51.2 GB) is kept; two 50M-row tables (102.4 GB) exceed the card, so the
# user table, of which each user reads one row, is cut to 10M rows.
TT_USER_VOCAB = 10_000_000
TT_P99, TT_BULK = 512, 262_144  # serve_p99 and serve_bulk batches (RECSYS_SHAPES)
TT_QUERIES = 256  # users of the constrained walk over the item tower
# The walk's result capacity and iteration cap. examples/constrained_serving.py
# uses 128 and 800; over 1M item-tower rows with random weights, whose user
# queries lie far from the items, that reaches recall@10 0.19, and 2048 and
# 8000 hold the 0.5 floor (PERF.md records the settings measured). Every
# query runs to the cap: the floor holds by the iteration budget, not
# because the graph steers the walk to its neighbours.
TT_EF_RESULT, TT_MAX_ITERS = 2048, 8000


def log(msg: str) -> None:
    print(msg, flush=True)


def log_memory(where: str) -> None:
    """Device memory held at a phase boundary, after a collection."""
    gc.collect()
    torch.cuda.empty_cache()
    log(f"memory {where}: allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB, reserved "
        f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB ({os.environ.get('PYTORCH_CUDA_ALLOC_CONF')})")


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def ptxas_summary(out: str) -> str:
    """One line for a library's `-Xptxas -v` report: its kernel entries (one
    per instantiated lattice point and family), their register range, and
    the entries that spill."""
    import re

    regs = [int(r) for r in re.findall(r"Used (\d+) registers", out)]
    spills, fn = [], None
    for line in out.splitlines():
        if "Function properties for" in line:
            fn = line.split("for", 1)[1].strip()
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and (m.group(1) != "0" or m.group(2) != "0"):
            spills.append(f"{fn} ({m.group(1)} / {m.group(2)} bytes)")
    rng = f"{min(regs)}-{max(regs)}" if regs else "none"
    return (f"{out.count('Compiling entry function')} entries, {rng} registers, "
            f"{len(spills)} spilling{': ' + '; '.join(spills) if spills else ''}")


# --------------------------------------------------------------------------- timing

_first_reading = True


def device_ms(fn, arg_sets, reps: int = 100, replays: int = 5) -> float:
    """Mean device time of one call: ``reps`` calls cycling through
    ``arg_sets`` are captured in one CUDA graph and replayed back to back, so
    host launch overhead stays out. The sets together exceed the L2 cache,
    so each call finds its rows cold, as the search loop does. The first
    reading of a process is taken twice and the first dropped: a small
    launch reads up to 9% faster there than in the readings that follow it
    back to back, so the smoke reads every kernel in the latter state
    (PERF.md; a pause can bring the faster one back)."""
    global _first_reading
    if _first_reading:
        _first_reading = False
        device_ms(fn, arg_sets, reps, replays)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for args in arg_sets[:3]:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * reps)


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """The least time, in ms, of work that moves ``n_bytes`` and does
    ``n_ops`` float32 operations on one H100 (the roofline model's
    constants, repro_torch/roofline/model.py), and which of the two bounds it."""
    from repro_torch.roofline.model import work_bound

    t, by = work_bound(n_bytes, n_ops)
    return t * 1e3, by


def occurrence_bound_ms(kernel: str, config, **shape) -> tuple[float, str]:
    """kernel_roofline's bound, in ms: every candidate's words counted at each
    occurrence (repro_torch/roofline/model.py), beside the smoke's bound,
    which counts each distinct row once."""
    from repro_torch.roofline.model import kernel_roofline

    r = kernel_roofline(kernel, config, **shape)
    return r.time_bound("cuda") * 1e3, r.bound_by("cuda")


def table_config(kernel: str, d: int, deg: int = 32, beam: int = 1):
    """The tuning table's config for a key on the card (what build_context
    resolves for the main path's walks)."""
    from repro_torch.tune import lookup

    return lookup(kernel, d=d, deg=deg, beam=beam, platform="cuda")


def config_dims(kernel: str, config) -> dict:
    """The dimensions of ``config`` that ``kernel`` consumes."""
    from repro_torch.tune import LATTICE

    return {k: getattr(config, k) for k in LATTICE[kernel]}


# --------------------------------------------------------------------------- kernels


def rand_words(gen, shape, dev):
    """int32 words over all 32 bits (bit 31 set in about half)."""
    return torch.randint(-2**31, 2**31, shape, generator=gen, dtype=torch.int64,
                         device=dev).to(torch.int32)


def kernel_inputs(gen, labels, m, pad_frac, family, n_labels, tomb):
    """Candidate ids, visited words and the family's meta / cons (and
    tombstones) over the corpus that ``labels`` (n,) labels."""
    dev = labels.device
    n = labels.shape[0]
    from repro_torch.common.bits import n_words

    ids = torch.randint(0, n, (B, m), generator=gen, dtype=torch.int32, device=dev)
    pad = torch.rand((B, m), generator=gen, device=dev) < pad_frac
    ids = torch.where(pad, -1, ids)
    ids[:, 0] = 31  # bit 31 of visited / tombstone word 0
    visited = rand_words(gen, (B, n_words(n)), dev)
    if family == "label":
        meta = labels
        cons = rand_words(gen, (B, n_words(n_labels)), dev)
    elif family == "range":
        meta = torch.randint(0, 100, (n,), generator=gen, device=dev).float()
        lo = torch.randint(0, 60, (B,), generator=gen, device=dev).float()
        cons = torch.stack([lo, lo + 40], -1)
    else:
        meta = torch.randint(-1, 2, (n,), generator=gen, dtype=torch.int32, device=dev)
        cons = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    tombs = rand_words(gen, (n_words(n),), dev) if tomb else None
    return ids, visited, meta, cons, tombs


def compare_dists(name, got, want, exact):
    check(torch.equal(torch.isinf(got), torch.isinf(want)), f"{name}: +inf pattern differs")
    fin = torch.isfinite(want)
    err = (got[fin] - want[fin]).abs()
    max_err = float(err.max()) if err.numel() else 0.0
    if exact:
        check(max_err == 0.0, f"{name}: integer inputs differ (max abs {max_err})")
    else:
        rel = float((err / want[fin].abs().clamp_min(1e-30)).max()) if err.numel() else 0.0
        check(rel <= 1e-5, f"{name}: relative error {rel} > 1e-5")
    return max_err


def gathered_bytes(queries, corpus, ids):
    """Bytes a gather-distance call must read: each distinct row once, the
    queries and the ids; and the number of valid candidates."""
    valid = ids[ids >= 0]
    rows = int(torch.unique(valid).numel())
    return (rows * corpus.shape[1] * 4 + queries.numel() * 4 + ids.numel() * 4,
            int(valid.numel()))


def kernel_phase(args, dev):
    from repro_torch.kernels.fused_expand import fused_expand_cuda, fused_expand_plain
    from repro_torch.kernels.gather_distance import gather_distance_cuda, gather_distance_plain
    from repro_torch.tune import DEFAULT_CONFIGS

    gen = torch.Generator(device=dev).manual_seed(args.seed + 11)
    n, n_labels = args.n, 40
    corpora = {
        "int": torch.randint(-8, 9, (n, D_MAIN), generator=gen, device=dev).float(),
        "float": torch.randn((n, D_MAIN), generator=gen, device=dev),
    }
    labels = torch.randint(0, n_labels, (n,), generator=gen, dtype=torch.int32, device=dev)
    labels[31] = 31  # bit 31 of label word 0
    max_err = {"gather_distance": 0.0, "fused_expand": 0.0}
    n_checks = 0
    for kind, corpus in corpora.items():
        exact = kind == "int"
        queries = (torch.randint(-8, 9, (B, D_MAIN), generator=gen, device=dev).float() if exact
                   else torch.randn((B, D_MAIN), generator=gen, device=dev))
        for m in (32, 128, 1, 45):
            ids = kernel_inputs(gen, labels, m, 0.1, "label", n_labels, False)[0]
            got = gather_distance_cuda(queries, corpus, ids)
            torch.cuda.synchronize()
            err = compare_dists(f"gather_distance {kind} M={m}", got,
                                gather_distance_plain(queries, corpus, ids), exact)
            max_err["gather_distance"] = max(max_err["gather_distance"], err)
            n_checks += 1
            for family in ("label", "range", "udf"):
                for tomb in (False, True):
                    ids, visited, meta, cons, tombs = kernel_inputs(
                        gen, labels, m, 0.1, family, n_labels, tomb)
                    d, s, f = fused_expand_cuda(queries, corpus, ids, visited, meta, cons, tombs,
                                                family=family)
                    torch.cuda.synchronize()
                    pd, ps, pf = fused_expand_plain(queries, corpus, ids, visited, meta, cons,
                                                    tombs, family=family)
                    tag = f"fused_expand {kind} M={m} {family} tomb={tomb}"
                    err = compare_dists(tag, d, pd, exact)
                    max_err["fused_expand"] = max(max_err["fused_expand"], err)
                    check(torch.equal(s, ps), f"{tag}: satisfied mask differs")
                    check(torch.equal(f, pf), f"{tag}: fresh mask differs")
                    check(torch.equal(d, gather_distance_cuda(queries, corpus, ids)),
                          f"{tag}: fused and gather_distance distances differ")
                    n_checks += 1
    log(f"kernels: {n_checks} kernel/plain comparisons passed; max abs err "
        f"gather_distance {max_err['gather_distance']:.3e}, "
        f"fused_expand {max_err['fused_expand']:.3e}")

    # Device time at the search's shapes, float corpus, label family (the
    # smoke's constraint), no tombstones.
    corpus = corpora["float"]
    queries = torch.randn((B, D_MAIN), generator=gen, device=dev)
    label_words = rand_words(gen, (B, 1), dev)
    labels10 = torch.randint(0, 10, (n,), generator=gen, dtype=torch.int32, device=dev)
    timings = {}
    for m in (32, 128):
        per_call = B * m * D_MAIN * 4
        n_sets = max(2, math.ceil(2 * L2_BYTES / per_call))
        gd_sets, fx_sets, gd_bytes, fx_bytes, cands = [], [], 0.0, 0.0, 0
        for _ in range(n_sets):
            ids, visited, _, _, _ = kernel_inputs(gen, labels10, m, 0.0, "label", 10,
                                                  False)
            gd_sets.append((queries, corpus, ids))
            fx_sets.append((queries, corpus, ids, visited, labels10, label_words))
            nb, c = gathered_bytes(queries, corpus, ids)
            cands += c
            gd_bytes += nb + ids.numel() * 4  # + the (B, M) float32 output
            safe = ids.clamp_min(0).long()
            vis_words = torch.unique(torch.arange(B, device=dev)[:, None] * visited.shape[1]
                                     + (safe >> 5)).numel()
            fx_bytes += (nb + torch.unique(safe).numel() * 4  # meta words
                         + vis_words * 4 + label_words.numel() * 4 + ids.numel() * 6)
        ops = 3.0 * D_MAIN * cands / n_sets

        # gather_distance's config for this key from the tuning table, as
        # the walks take it; fused_expand has one shape.
        gd_cfg = table_config("gather_distance", D_MAIN, beam=m // 32)
        fx_cfg = DEFAULT_CONFIGS["fused_exact"]

        def gd_kernel(q, x, i):
            return gather_distance_cuda(q, x, i, config=gd_cfg)

        def fx_kernel(q, x, i, v, meta, cons):
            return fused_expand_cuda(q, x, i, v, meta, cons, family="label")

        def fx_plain(q, x, i, v, meta, cons):
            return fused_expand_plain(q, x, i, v, meta, cons, family="label")

        gd_bound = bound_ms(gd_bytes / n_sets, ops)
        fx_bound = bound_ms(fx_bytes / n_sets, ops)
        shape = dict(b=B, m=m, d=D_MAIN)
        timings[m] = {
            "gather_distance": dict(ms=device_ms(gd_kernel, gd_sets),
                                    plain_ms=device_ms(gather_distance_plain, gd_sets),
                                    bound_ms=gd_bound[0], bound_by=gd_bound[1],
                                    occurrence=occurrence_bound_ms("gather_distance", gd_cfg,
                                                                   **shape),
                                    config=config_dims("gather_distance", gd_cfg)),
            "fused_expand": dict(ms=device_ms(fx_kernel, fx_sets),
                                 plain_ms=device_ms(fx_plain, fx_sets),
                                 bound_ms=fx_bound[0], bound_by=fx_bound[1],
                                 occurrence=occurrence_bound_ms("fused_exact", fx_cfg, **shape),
                                 config=config_dims("fused_exact", fx_cfg)),
        }
        floor = launch_floor_ms(B, m, dev)
        for name, t in timings[m].items():
            log(f"time {name} B={B} M={m} d={D_MAIN} n={n}: kernel {t['ms'] * 1e3:.2f} us at "
                f"{json.dumps(t['config'])}, plain {t['plain_ms'] * 1e3:.2f} us, "
                f"bound {t['bound_ms'] * 1e3:.2f} us ({t['bound_by']}, each distinct row once; "
                f"per occurrence {t['occurrence'][0] * 1e3:.2f} us, {t['occurrence'][1]}), "
                f"launch floor {floor * 1e3:.2f} us ({B} x {m} out.zero_()), "
                f"{n_sets} id sets cycled")
    del corpora, corpus
    torch.cuda.empty_cache()
    gather_d256_timing(gen, n, dev)
    # After the timings, so their allocations leave the timed memory as the
    # parent's smoke left it.
    n_edge = fused_edge_cases(gen, dev, max_err)
    log(f"kernels: {n_edge} fused_expand edge-case comparisons passed; max abs err "
        f"fused_expand {max_err['fused_expand']:.3e}")
    return max_err, timings


def fused_edge_cases(gen, dev, max_err, n=100_000):
    """fused_expand's paths beyond the main shape, over an n-row corpus:
    d = 256 (the register path with two float4s a lane), d = 13 and an
    unaligned query row (the shared-memory path), and label rows of 1 and
    63 words (2,016 labels: the word by shuffle, or loaded once the meta
    word arrives), with bit 31 set in the first and the last word. The
    distances must be gather_distance_cuda's bits, the masks the plain
    version's. Returns the number of comparisons."""
    from repro_torch.kernels.fused_expand import fused_expand_cuda, fused_expand_plain
    from repro_torch.kernels.gather_distance import gather_distance_cuda, gather_distance_plain

    n_checks = 0
    for d in (256, 13, D_MAIN):
        corpus = torch.randn((n, d), generator=gen, device=dev)
        queries = torch.randn((B, d), generator=gen, device=dev)
        skewed = torch.empty(B * d + 1, device=dev)[1:].view(B, d)  # 4 bytes past 16
        skewed.copy_(queries)
        for n_labels in (32, 2016):
            labels = torch.randint(0, n_labels, (n,), generator=gen, dtype=torch.int32,
                                   device=dev)
            labels[31], labels[32] = n_labels - 1, 31  # bit 31 of the last and the first word
            for m in (32, 128, 1, 45):
                ids, visited, _, cons, tombs = kernel_inputs(gen, labels, m, 0.1, "label",
                                                             n_labels, m == 45)
                if m > 1:
                    ids[:, 1] = 32
                cons[:, 0] |= -2**31
                cons[:, -1] |= -2**31
                for q in (queries, skewed):
                    tag = f"fused_expand d={d} Lw={cons.shape[1]} M={m} aligned={q is queries}"
                    d_, s, f = fused_expand_cuda(q, corpus, ids, visited, labels, cons, tombs,
                                                 family="label")
                    gd = gather_distance_cuda(q, corpus, ids)
                    torch.cuda.synchronize()
                    _, ps, pf = fused_expand_plain(q, corpus, ids, visited, labels, cons, tombs,
                                                   family="label")
                    check(torch.equal(d_, gd), f"{tag}: fused and gather_distance distances differ")
                    check(torch.equal(s, ps), f"{tag}: satisfied mask differs")
                    check(torch.equal(f, pf), f"{tag}: fresh mask differs")
                    err = compare_dists(tag, d_, gather_distance_plain(q, corpus, ids), False)
                    max_err["fused_expand"] = max(max_err["fused_expand"], err)
                    n_checks += 1
        del corpus, queries, skewed
    return n_checks


def launch_floor_ms(b, m, dev):
    """The card's fixed cost of one small launch: out.zero_() over a (b, m)
    float32 output, timed by device_ms like the kernels beside it."""
    out = torch.empty((b, m), device=dev)
    return device_ms(lambda o: o.zero_(), [(out,)])


def gather_d256_timing(gen, n, dev):
    """gather_distance at airship_tt_256's shape: 256 queries x 32
    candidates over n rows of d = TT_DIM (the item tower's width)."""
    from repro_torch.kernels.gather_distance import gather_distance_cuda, gather_distance_plain

    m = 32
    corpus = torch.randn((n, TT_DIM), generator=gen, device=dev)
    queries = torch.randn((B, TT_DIM), generator=gen, device=dev)
    n_sets = max(2, math.ceil(2 * L2_BYTES / (B * m * TT_DIM * 4)))
    sets, n_bytes, cands = [], 0.0, 0
    for _ in range(n_sets):
        ids = torch.randint(0, n, (B, m), generator=gen, dtype=torch.int32, device=dev)
        sets.append((queries, corpus, ids))
        nb, c = gathered_bytes(queries, corpus, ids)
        n_bytes += nb + ids.numel() * 4
        cands += c
    bd = bound_ms(n_bytes / n_sets, 3.0 * TT_DIM * cands / n_sets)
    cfg = table_config("gather_distance", TT_DIM)
    occ = occurrence_bound_ms("gather_distance", cfg, b=B, m=m, d=TT_DIM)
    got = gather_distance_cuda(*sets[0], config=cfg)
    torch.cuda.synchronize()
    compare_dists(f"gather_distance d={TT_DIM}", got, gather_distance_plain(*sets[0]), False)
    t = dict(ms=device_ms(lambda q, x, i: gather_distance_cuda(q, x, i, config=cfg), sets),
             plain_ms=device_ms(gather_distance_plain, sets), bound_ms=bd[0], bound_by=bd[1])
    floor = launch_floor_ms(B, m, dev)
    log(f"time gather_distance B={B} M={m} d={TT_DIM} n={n} (airship_tt_256): kernel "
        f"{t['ms'] * 1e3:.2f} us at {json.dumps(config_dims('gather_distance', cfg))} (the "
        f"table's), plain {t['plain_ms'] * 1e3:.2f} us, bound {t['bound_ms'] * 1e3:.2f} us "
        f"({t['bound_by']}, {n_bytes / n_sets / 1e6:.2f} MB; per occurrence "
        f"{occ[0] * 1e3:.2f} us, {occ[1]}), launch floor {floor * 1e3:.2f} us, {n_sets} id sets "
        f"cycled")
    del corpus
    torch.cuda.empty_cache()


def nnd_chunk_timing(vectors, nbrs, gen):
    """gather_distance at build_nnd's shapes, with the ids of a real
    NN-descent round (one more round's candidates over the built graph, with
    fresh draws), which repeat and cluster: the round's one launch (n rows x
    the round's candidates at d = 128) and, to compare with the earlier
    kernel's launches, chunks of NND_CHUNK rows. Each bound is printed both
    ways: each distinct row of the launch once, and each candidate's row
    once per occurrence (the bound in the kernels line)."""
    from repro_torch.graph.build import round_candidates
    from repro_torch.kernels.gather_distance import gather_distance_cuda, gather_distance_plain

    n, degree = nbrs.shape
    dev = vectors.device
    cols = torch.randint(0, degree, (n, degree, 2), generator=gen, device=dev, dtype=torch.int32)
    rand = torch.randint(0, n, (n, degree), generator=gen, device=dev, dtype=torch.int32)
    cand = round_candidates(nbrs, cols, rand)
    del cols, rand
    c = cand.shape[1]

    def bounds(sets):
        distinct, occ = 0.0, 0.0
        for q, _, ids in sets:
            extra = q.numel() * 4 + ids.numel() * 8  # queries, ids, (rows, C) output
            valid = ids[ids >= 0]
            distinct += torch.unique(valid).numel() * D_MAIN * 4 + extra
            occ += valid.numel() * D_MAIN * 4 + extra
        ops = 3.0 * D_MAIN * sets[0][2].numel()
        return (bound_ms(occ / len(sets), ops), bound_ms(distinct / len(sets), ops),
                occ / len(sets), distinct / len(sets))

    chunks = [(vectors[s : s + NND_CHUNK], vectors, cand[s : s + NND_CHUNK].contiguous())
              for s in range(0, n - NND_CHUNK + 1, NND_CHUNK)]  # whole chunks only
    got = gather_distance_cuda(*chunks[0])
    torch.cuda.synchronize()
    err = compare_dists("gather_distance build_nnd chunk", got, gather_distance_plain(*chunks[0]),
                        False)
    del got
    for shape, sets, reps in (("round", [(vectors, vectors, cand)], 2),
                              ("chunk", chunks, len(chunks))):
        b_occ, b_distinct, occ, distinct = bounds(sets)
        ms = device_ms(gather_distance_cuda, sets, reps=reps, replays=3)
        plain = (f"plain {events_ms(gather_distance_plain, chunks[0], reps=2):.4f} ms, "
                 if shape == "chunk" else "")
        log(f"time gather_distance build_nnd {shape} {sets[0][2].shape[0]} x {c} d={D_MAIN} "
            f"n={n} (ids of a real NN-descent round): kernel {ms:.4f} ms, {plain}bound "
            f"{b_occ[0]:.4f} ms per occurrence ({occ / 1e9:.3f} GB, {b_occ[1]}) / "
            f"{b_distinct[0]:.4f} ms each distinct row once ({distinct / 1e9:.3f} GB); "
            f"{occ / ms / 1e6:.1f} GB/s per occurrence; {len(sets)} id sets cycled; max abs err "
            f"against the plain version {err:.3e}")
    del chunks, cand
    torch.cuda.empty_cache()


def pq_inputs(gen, b, n, m_sub, n_cent, integer, dev):
    """(lut (b, m_sub, n_cent), codes (n, m_sub)); rows 0 and 1 hold the
    codes 0 and n_cent - 1."""
    if integer:
        lut = torch.randint(0, 300, (b, m_sub, n_cent), generator=gen, device=dev).float()
    else:
        lut = torch.randn((b, m_sub, n_cent), generator=gen, device=dev) ** 2 * 50
    codes = torch.randint(0, n_cent, (n, m_sub), generator=gen, dtype=torch.int32, device=dev)
    codes[0], codes[1] = 0, n_cent - 1
    return lut, codes


def pq_kernel_phase(args, dev):
    """fused_expand_adc and pq_adc against their plain versions (exact on
    integer and float LUTs), then their device times against bounds."""
    import torch.nn.functional as F

    from repro_torch.core.engine.context import PQBackend
    from repro_torch.kernels.fused_expand import fused_expand_adc_cuda, fused_expand_adc_plain
    from repro_torch.kernels.pq_adc import pq_adc_cuda, pq_adc_plain
    from repro_torch.tune import DEFAULT_CONFIGS

    gen = torch.Generator(device=dev).manual_seed(args.seed + 13)
    n, n_labels, m_sub, n_cent = args.n, 40, 16, 256
    labels = torch.randint(0, n_labels, (n,), generator=gen, dtype=torch.int32, device=dev)
    labels[31] = 31
    max_err = {"fused_expand_adc": 0.0, "pq_adc": 0.0}
    n_checks = 0
    for integer in (True, False):
        kind = "int" if integer else "float"
        lut, codes = pq_inputs(gen, B, n, m_sub, n_cent, integer, dev)
        for m in (32, 128, 1, 45):
            for family in ("label", "range", "udf"):
                for tomb in (False, True):
                    ids, visited, meta, cons, tombs = kernel_inputs(
                        gen, labels, m, 0.1, family, n_labels, tomb)
                    if m > 2:  # rows 0 and 1 hold the extreme codes
                        ids[:, 1], ids[:, 2] = 0, 1
                    d, s, f = fused_expand_adc_cuda(lut, codes, ids, visited, meta, cons, tombs,
                                                    family=family)
                    torch.cuda.synchronize()
                    pd, ps, pf = fused_expand_adc_plain(lut, codes, ids, visited, meta, cons,
                                                        tombs, family=family)
                    tag = f"fused_expand_adc {kind} M={m} {family} tomb={tomb}"
                    max_err["fused_expand_adc"] = max(max_err["fused_expand_adc"],
                                                      compare_dists(tag, d, pd, True))
                    check(torch.equal(s, ps), f"{tag}: satisfied mask differs")
                    check(torch.equal(f, pf), f"{tag}: fresh mask differs")
                    unfused = PQBackend(codes=codes, lut=lut).distances(None, ids)
                    check(torch.equal(d, torch.where(ids >= 0, unfused, float("inf"))),
                          f"{tag}: fused and unfused PQ distances differ")
                    n_checks += 1
        for b, nn, nc in ((B, n, n_cent), (1, n, n_cent), (B, 1000, n_cent), (B, n, 16),
                          (1, 1000, 16)):
            lut_s, codes_s = pq_inputs(gen, b, nn, m_sub, nc, integer, dev)
            got = pq_adc_cuda(lut_s, codes_s)
            torch.cuda.synchronize()
            tag = f"pq_adc {kind} B={b} N={nn} n_cent={nc}"
            max_err["pq_adc"] = max(max_err["pq_adc"],
                                    compare_dists(tag, got, pq_adc_plain(lut_s, codes_s), True))
            n_checks += 1
            del lut_s, codes_s, got
    # Tables beyond the search's 16 KB: 64 KB (staged after the opt-in past
    # 48 KB), 227 KB with its label row (just past a block's shared memory)
    # and 256 KB (both looked up in device memory); pq_adc takes the first two.
    for sub, nc in ((64, 256), (227, 256), (64, 1024)):
        for integer in (True, False):
            lut_s, codes_s = pq_inputs(gen, B, 100_000, sub, nc, integer, dev)
            ids, visited, meta, cons, tombs = kernel_inputs(gen, labels[:100_000], 45, 0.1,
                                                            "label", n_labels, True)
            ids[:, 1], ids[:, 2] = 0, 1
            args = (lut_s, codes_s, ids, visited, meta, cons, tombs)
            d, s, f = fused_expand_adc_cuda(*args, family="label")
            torch.cuda.synchronize()
            pd, ps, pf = fused_expand_adc_plain(*args, family="label")
            tag = f"fused_expand_adc m_sub={sub} n_cent={nc} integer={integer}"
            max_err["fused_expand_adc"] = max(max_err["fused_expand_adc"],
                                              compare_dists(tag, d, pd, True))
            check(torch.equal(s, ps) and torch.equal(f, pf), f"{tag}: a mask differs")
            if sub * nc * 4 <= 232_448:
                scan = pq_adc_cuda(lut_s, codes_s).gather(1, ids.clamp_min(0).long())
                check(torch.equal(d, torch.where(ids >= 0, scan, float("inf"))),
                      f"{tag}: fused and pq_adc distances differ")
                del scan
            n_checks += 1
            del lut_s, codes_s
    log(f"kernels: {n_checks} PQ kernel/plain comparisons passed, all exact; max abs err "
        f"fused_expand_adc {max_err['fused_expand_adc']:.3e}, pq_adc {max_err['pq_adc']:.3e}")

    # Device time at the search's shapes: float LUT, label family, no
    # tombstones, no padding. The code matrix (64 MB) exceeds the L2 cache;
    # the one LUT of the 256 queries (4 MB) stays in it across the timed
    # calls. In the walk it mostly does not, and whole rows are padding
    # (PERF.md): serve_256_pq_fused's traced time measures that case.
    lut, codes = pq_inputs(gen, B, n, m_sub, n_cent, False, dev)
    label_words = rand_words(gen, (B, 1), dev)
    labels10 = torch.randint(0, 10, (n,), generator=gen, dtype=torch.int32, device=dev)
    visited = rand_words(gen, (B, (n + 31) // 32), dev)
    timings = {}
    for m in (32, 128):
        n_sets = min(100, max(2, math.ceil(2 * L2_BYTES / (B * m * m_sub * 4))))
        sets, n_bytes, adds = [], 0.0, 0.0
        rows = torch.arange(B, device=dev)[:, None]
        for _ in range(n_sets):
            ids = torch.randint(0, n, (B, m), generator=gen, dtype=torch.int32, device=dev)
            sets.append((lut, codes, ids, visited, labels10, label_words))
            safe = ids.long()
            distinct = torch.unique(safe).numel()
            vis_words = torch.unique(rows * visited.shape[1] + (safe >> 5)).numel()
            entries = codes[safe].long() + torch.arange(m_sub, device=dev) * n_cent
            lut_entries = torch.unique(rows[:, :, None] * (m_sub * n_cent) + entries).numel()
            # code rows, meta words, visited words, label words, LUT entries
            # read (each distinct one once); ids read; dists + 2 masks written.
            n_bytes += (distinct * m_sub * 4 + distinct * 4 + vis_words * 4
                        + label_words.numel() * 4 + lut_entries * 4 + ids.numel() * (4 + 6))
            adds += ids.numel() * (m_sub - 1)

        cfg = DEFAULT_CONFIGS["fused_adc"]  # its one shape

        def fx_kernel(*a):
            return fused_expand_adc_cuda(*a, family="label")

        def fx_plain(*a):
            return fused_expand_adc_plain(*a, family="label")

        bd = bound_ms(n_bytes / n_sets, adds / n_sets)
        timings[m] = dict(ms=device_ms(fx_kernel, sets), plain_ms=device_ms(fx_plain, sets),
                          bound_ms=bd[0], bound_by=bd[1], library_ms=None,
                          occurrence=occurrence_bound_ms("fused_adc", cfg, b=B, m=m, d=m_sub,
                                                         n_cent=n_cent),
                          config=config_dims("fused_adc", cfg))
        t = timings[m]
        floor = launch_floor_ms(B, m, dev)
        log(f"time fused_expand_adc B={B} M={m} m_sub={m_sub} n_cent={n_cent} n={n}: kernel "
            f"{t['ms'] * 1e3:.2f} us at {json.dumps(t['config'])}, plain "
            f"{t['plain_ms'] * 1e3:.2f} us, bound {t['bound_ms'] * 1e3:.2f} us "
            f"({t['bound_by']}, each distinct word once; per occurrence "
            f"{t['occurrence'][0] * 1e3:.2f} us, {t['occurrence'][1]}), launch floor "
            f"{floor * 1e3:.2f} us ({B} x {m} out.zero_()), {n_sets} id sets cycled; no single "
            f"PyTorch call computes it (library: none)")

    # pq_adc: the (B, N) output written once, the codes and the LUT read
    # once; m_sub - 1 adds a distance.
    scan_bytes = B * n * 4 + codes.numel() * 4 + lut.numel() * 4
    bd = bound_ms(scan_bytes, B * n * (m_sub - 1))
    # The library yardstick: one embedding_bag call, sum mode, gives the
    # transposed scan (N, B); its offset codes and (m_sub * n_cent, B)
    # table are made once, outside the timing.
    offsets = codes.long() + torch.arange(m_sub, device=dev) * n_cent
    table = lut.permute(1, 2, 0).reshape(m_sub * n_cent, B).contiguous()
    lib = F.embedding_bag(offsets, table, mode="sum")
    got = pq_adc_cuda(lut, codes)
    lib_err = float((lib.T - got).abs().max())
    check(lib_err <= 1e-3 * float(got.abs().max()), f"embedding_bag disagrees with pq_adc by {lib_err}")
    del lib, got
    # The scan has one shape, its lattice's only point.
    scan_cfg = DEFAULT_CONFIGS["pq_adc"]
    scan = dict(ms=device_ms(pq_adc_cuda, [(lut, codes)], reps=20, replays=3),
                plain_ms=device_ms(pq_adc_plain, [(lut, codes)], reps=3, replays=2),
                bound_ms=bd[0], bound_by=bd[1],
                library_ms=device_ms(lambda o, t: F.embedding_bag(o, t, mode="sum"),
                                     [(offsets, table)], reps=5, replays=3),
                occurrence=occurrence_bound_ms("pq_adc", scan_cfg, b=B, m=n, d=m_sub,
                                               n_cent=n_cent),
                config=config_dims("pq_adc", scan_cfg))
    # The design's lookup floor: B * N * m_sub 4-byte shared-memory lookups
    # at 128 bytes a clock on every SM, without a bank conflict.
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clk = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60).stdout.split()
    clk_hz = float(clk[0]) * 1e6 if clk else float("nan")
    floor_ms = B * n * m_sub * 4 / (128 * sms * clk_hz) * 1e3
    log(f"time pq_adc B={B} N={n} m_sub={m_sub} n_cent={n_cent}: kernel {scan['ms']:.4f} ms "
        f"(its one shape), plain {scan['plain_ms']:.4f} ms, bound "
        f"{scan['bound_ms']:.4f} ms ({scan['bound_by']}, {scan_bytes / 1e9:.3f} GB; "
        f"kernel_roofline {scan['occurrence'][0]:.4f} ms, {scan['occurrence'][1]}), library embedding_bag {scan['library_ms']:.4f} ms "
        f"(max abs diff {lib_err:.3e}); lookup floor {floor_ms:.4f} ms ({B * n * m_sub:.3e} "
        f"lookups, 128 B a clock on {sms} SMs at {clk_hz / 1e9:.3f} GHz)")
    del offsets, table, lut, codes, visited
    torch.cuda.empty_cache()
    return max_err, {"fused_expand_adc": timings, "pq_adc": scan}


def events_ms(fn, args, reps: int) -> float:
    """Mean device time of one eager call, by CUDA events around ``reps``
    calls after one warm-up (for ms-scale calls, whose launch cost is
    negligible beside them)."""
    fn(*args)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def l2_kernel_phase(args, dev):
    """l2_matmul against its plain version (exact on integer inputs, within
    1e-5 * (|q|^2 + |x|^2) on float inputs), then its device time at the
    build's shape against its bound, the plain version and torch.cdist."""
    from repro_torch.kernels.l2_matmul import l2_matmul_cuda, l2_matmul_plain

    gen = torch.Generator(device=dev).manual_seed(args.seed + 17)
    n = args.n
    shapes = ((BUILD_BLOCK, n, D_MAIN), (1, n, D_MAIN), (130, 257, 13), (129, 131, 1),
              (200, 301, 37))
    max_err, n_checks = 0.0, 0
    for integer in (True, False):
        kind = "int" if integer else "float"
        for m, nn, d in shapes:
            if integer:
                q = torch.randint(-8, 9, (m, d), generator=gen, device=dev).float()
                x = torch.randint(-8, 9, (nn, d), generator=gen, device=dev).float()
            else:
                q = torch.randn((m, d), generator=gen, device=dev)
                x = torch.randn((nn, d), generator=gen, device=dev)
            for qq, tag in ((q, f"l2_matmul {kind} M={m} N={nn} d={d}"),
                            (x[: min(m, nn)].contiguous(), f"l2_matmul {kind} identical rows "
                                                           f"M={min(m, nn)} N={nn} d={d}")):
                got = l2_matmul_cuda(qq, x)
                torch.cuda.synchronize()
                want = l2_matmul_plain(qq, x)
                check(bool((got >= 0).all()), f"{tag}: a negative distance")
                err = (got - want).abs()
                if integer:
                    check(torch.equal(got, want), f"{tag}: integer inputs differ "
                                                  f"(max abs {float(err.max())})")
                else:
                    tol = ((qq * qq).sum(-1)[:, None] + (x * x).sum(-1)[None, :]).mul_(1e-5)
                    check(bool((err <= tol).all()), f"{tag}: error above 1e-5 * (|q|^2 + |x|^2)")
                    del tol
                max_err = max(max_err, float(err.max()))
                if qq is not q:
                    diag = torch.diagonal(got)
                    check(torch.equal(diag, torch.zeros_like(diag)) if integer
                          else float(diag.max()) <= 1e-3 * float((qq * qq).sum(-1).max()),
                          f"{tag}: the diagonal is not 0")
                n_checks += 1
                del got, want, err
            del q, x
    log(f"kernels: {n_checks} l2_matmul kernel/plain comparisons passed (integer inputs exact); "
        f"max abs err {max_err:.3e}")

    # Device time at the build's shape: one (1024, n) row block of the exact
    # kNN graph, float inputs. The output (4 GB at n = 1M) is far beyond
    # L2; x (512 MB) too, q stays in it.
    q = torch.randn((BUILD_BLOCK, D_MAIN), generator=gen, device=dev)
    x = torch.randn((n, D_MAIN), generator=gen, device=dev)
    ops = 2.0 * BUILD_BLOCK * n * D_MAIN
    n_bytes = (q.numel() + x.numel() + BUILD_BLOCK * n) * 4
    bd = bound_ms(n_bytes, ops)
    lib = lambda a, b: torch.cdist(a, b, compute_mode="use_mm_for_euclid_dist")
    got = l2_matmul_cuda(q, x)
    lib_err = float((lib(q, x) ** 2 - got).abs().max())
    del got
    t = dict(ms=events_ms(l2_matmul_cuda, (q, x), reps=10),
             plain_ms=events_ms(l2_matmul_plain, (q, x), reps=5),
             library_ms=events_ms(lib, (q, x), reps=5), bound_ms=bd[0], bound_by=bd[1])
    t["ms_again"] = events_ms(l2_matmul_cuda, (q, x), reps=10)
    log(f"time l2_matmul M={BUILD_BLOCK} N={n} d={D_MAIN}: kernel {t['ms']:.4f} ms "
        f"(again {t['ms_again']:.4f} ms), plain {t['plain_ms']:.4f} ms, bound "
        f"{t['bound_ms']:.4f} ms ({t['bound_by']}, {ops / 1e12:.3f} TFLOP, "
        f"{n_bytes / 1e9:.3f} GB), {ops / t['ms'] / 1e9:.2f} TFLOP/s; library "
        f"torch.cdist(compute_mode='use_mm_for_euclid_dist') {t['library_ms']:.4f} ms (it "
        f"returns the root; max abs diff of its square {lib_err:.3e})")
    del q, x
    torch.cuda.empty_cache()
    return max_err, t


def tt_config():
    """two-tower-retrieval at its published widths, with the one cut the
    card forces: user_vocab 50M -> TT_USER_VOCAB (see the module note)."""
    import dataclasses

    from repro_torch.configs import two_tower_retrieval

    return dataclasses.replace(two_tower_retrieval(), user_vocab=TT_USER_VOCAB)


def bag_bytes_ops(ids, d):
    """Bytes an embedding_bag call must move (each distinct valid row read
    once, the ids read, the (B, D) output written) and its adds."""
    valid = ids[ids >= 0]
    rows = int(torch.unique(valid).numel())
    return rows * d * 4 + ids.numel() * 4 + ids.shape[0] * d * 4, float(valid.numel()) * d


def bag_kernel_phase(args, dev):
    """embedding_bag against its plain version on the two-tower item table
    ((50,000,128, 256) float32, 51.2 GB), exact on integer and float tables,
    at serve_bulk's and serve_p99's bags and on edge cases; then its device
    time at both shapes against its bound, the plain version and one
    torch.nn.functional.embedding_bag call."""
    import torch.nn.functional as F

    from repro_torch.data import two_tower_batch
    from repro_torch.kernels.embedding_bag import embedding_bag_cuda, embedding_bag_plain
    from repro_torch.models.recsys.models import VOCAB_PAD, fill_normal_

    cfg = tt_config()
    d, hist = cfg.embed_dim, cfg.hist_len
    v = cfg.padded_vocab(cfg.item_vocab, VOCAB_PAD)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 19)

    def bags(step, b):
        return two_tower_batch(args.seed, step, b, cfg.user_vocab, cfg.item_vocab, hist,
                               device=dev)["hist"]

    bulk, p99 = bags(0, TT_BULK), bags(1, TT_P99)
    # Edge bags: all padding, the last row, rows around the 2**31-element
    # mark (row 2**31 / D), row 0; L = 1; B = 1.
    mark = min(2**31 // d, v - hist)  # 2**31 // d on the published table
    edge = torch.full((6, hist), -1, dtype=torch.int32, device=dev)
    edge[1, :6] = torch.tensor([v - 1, -1, mark, mark - 1, 0, v - 1])
    edge[2] = torch.arange(v - hist, v, dtype=torch.int32, device=dev)
    edge[3] = torch.arange(mark - hist // 2, mark + hist - hist // 2, dtype=torch.int32,
                           device=dev)
    edge[3, 1::7] = -1
    edge[4:] = bulk[:2]
    table = torch.empty((v, d), device=dev)
    max_err, n_checks = 0.0, 0
    for kind in ("int", "float"):
        if kind == "int":
            rows = (1 << 28) // d
            for s in range(0, v, rows):
                table[s : s + rows].random_(-8, 9, generator=gen)
        else:
            fill_normal_(table, gen, 0.02)  # the model's law
        cases = [("serve_bulk", table, bulk, "sum"), ("serve_p99", table, p99, "sum"),
                 ("serve_bulk mean", table, bulk, "mean"), ("edge", table, edge, "sum"),
                 ("edge mean", table, edge, "mean"),
                 ("L=1", table, bulk[:, :1].contiguous(), "sum"), ("B=1", table, p99[:1], "sum")]
        for dd in (10, 50):  # the scalar path over the same memory, (V * 256 / D, D)
            narrow = table.view(-1)[: table.numel() // dd * dd].view(-1, dd)
            vv = narrow.shape[0]
            ids = torch.randint(0, vv, (TT_P99, hist), generator=gen, dtype=torch.int32,
                                device=dev)
            ids[torch.rand(ids.shape, generator=gen, device=dev) < 0.3] = -1
            ids[0] = -1
            ids[1, :3] = torch.tensor([vv - 1, 0, min(2**31 // dd + 1, vv - 1)])
            cases += [(f"D={dd}", narrow, ids, "sum"), (f"D={dd} mean", narrow, ids, "mean"),
                      (f"D={dd} L=1", narrow, ids[:, 1:2].contiguous(), "sum")]
        for name, tab, ids, mode in cases:
            got = embedding_bag_cuda(tab, ids, mode)
            torch.cuda.synchronize()
            want = embedding_bag_plain(tab, ids, mode)
            err = float((got - want).abs().max())
            check(torch.equal(got, want), f"embedding_bag {kind} {name} B={ids.shape[0]} "
                  f"L={ids.shape[1]} D={tab.shape[1]}: differs from its plain version "
                  f"(max abs {err})")
            max_err = max(max_err, err)
            n_checks += 1
        check(bool((embedding_bag_cuda(table, edge)[0] == 0).all()),
              "embedding_bag: a bag of padding only is not 0")
    log(f"kernels: {n_checks} embedding_bag kernel/plain comparisons passed, all exact (integer "
        f"and float tables; sum and mean; serve_bulk {TT_BULK} x {hist}, serve_p99 {TT_P99} x "
        f"{hist} over ({v}, {d}); all-padding bag, rows V - 1 and around 2**31 elements, L = 1, "
        f"B = 1, D = 10 and 50); max abs err {max_err:.3e}")

    # Device time on the float table (the model's law, normal * 0.02): the
    # rows are scattered over 51 GB, so they come from device memory.
    timings = {}
    for shape, ids_sets in (("serve_bulk", [bulk]),
                            ("serve_p99", [p99] + [bags(2 + i, TT_P99) for i in range(7)])):
        nb, ops = zip(*(bag_bytes_ops(ids, d) for ids in ids_sets))
        bd = bound_ms(sum(nb) / len(nb), sum(ops) / len(ops))
        lib_sets = [(ids.clamp(min=0), (ids >= 0).float()) for ids in ids_sets]

        def lib(i, w):
            return F.embedding_bag(i, table, per_sample_weights=w, mode="sum")

        got = embedding_bag_cuda(table, ids_sets[0])
        lib_err = float((lib(*lib_sets[0]) - got).abs().max())
        check(lib_err <= 1e-5, f"F.embedding_bag disagrees with embedding_bag by {lib_err}")
        del got
        if shape == "serve_bulk":
            t = dict(ms=events_ms(embedding_bag_cuda, (table, bulk), reps=10),
                     plain_ms=events_ms(embedding_bag_plain, (table, bulk), reps=3),
                     library_ms=events_ms(lib, lib_sets[0], reps=5))
            t["ms_again"] = events_ms(embedding_bag_cuda, (table, bulk), reps=10)
        else:
            t = dict(ms=device_ms(embedding_bag_cuda, [(table, ids) for ids in ids_sets]),
                     plain_ms=device_ms(embedding_bag_plain, [(table, ids) for ids in ids_sets],
                                        reps=20, replays=3),
                     library_ms=device_ms(lib, lib_sets))
        t.update(bound_ms=bd[0], bound_by=bd[1], bytes=sum(nb) / len(nb))
        timings[shape] = t
        log(f"time embedding_bag {shape} B={ids_sets[0].shape[0]} L={hist} D={d} V={v}: kernel "
            f"{t['ms']:.4f} ms{' (again %.4f ms)' % t['ms_again'] if 'ms_again' in t else ''}, "
            f"plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}, "
            f"{t['bytes'] / 1e9:.4f} GB: each distinct valid row once + ids + output), "
            f"{t['bytes'] / t['ms'] / 1e6:.1f} GB/s; library F.embedding_bag(ids.clamp(min=0), "
            f"table, per_sample_weights=(ids >= 0).float(), mode='sum') {t['library_ms']:.4f} ms "
            f"(max abs diff {lib_err:.3e}); {len(ids_sets)} id sets cycled")
    del table
    torch.cuda.empty_cache()
    return max_err, timings


# --------------------------------------------------------------------------- tune


def tune_phase(args, dev) -> dict:
    """Phase 3b: the tuner's lattice (repro_torch.tune) at the main path's
    shapes: B = 256 queries, M = 32 candidates of n rows (d = 128; PQ
    m_sub = 16, n_cent = 256), and the PQ scan over all n rows. For each
    kernel of the tuner (only gather_distance has more than one point)
    every lattice point is launched and its outputs (distances
    and both verdict masks) held to the default config's bit for bit, and
    the table's choice for the walk's key is timed against the default by
    device_ms in turns (default, table, table, default; the faster reading
    of each kept), beside kernel_roofline's bound. One `tune {...}` line a
    kernel."""
    from repro_torch.common.bits import n_words
    from repro_torch.kernels.fused_expand import fused_expand_adc_cuda, fused_expand_cuda
    from repro_torch.kernels.gather_distance import gather_distance_cuda
    from repro_torch.kernels.pq_adc import pq_adc_cuda
    from repro_torch.tune import DEFAULT_CONFIGS, lattice_configs

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(args.seed + 97)
    n, m, m_sub, n_cent = args.n, 32, 16, 256
    corpus = torch.randn((n, D_MAIN), generator=gen, device=dev)
    queries = torch.randn((B, D_MAIN), generator=gen, device=dev)
    labels = torch.randint(0, 10, (n,), generator=gen, dtype=torch.int32, device=dev)
    codes = torch.randint(0, n_cent, (n, m_sub), generator=gen, dtype=torch.int32, device=dev)
    lut = torch.rand((B, m_sub, n_cent), generator=gen, device=dev)
    words = rand_words(gen, (B, 1), dev)
    visited = rand_words(gen, (B, n_words(n)), dev)
    n_sets = max(2, math.ceil(2 * L2_BYTES / (B * m * D_MAIN * 4)))
    id_sets = [(torch.randint(-1, n, (B, m), generator=gen, dtype=torch.int32, device=dev),)
               for _ in range(n_sets)]
    # wrapper, (key d, deg, beam), a launcher at a config, its argument sets,
    # the shape kernel_roofline takes
    kernels = {
        "gather_distance": ("gather_distance", (D_MAIN, 32, 1),
                            lambda cfg: lambda i: gather_distance_cuda(queries, corpus, i,
                                                                       config=cfg),
                            id_sets, dict(b=B, m=m, d=D_MAIN)),
        "fused_exact": ("fused_expand", (D_MAIN, 32, 1),  # one shape: cfg is the default
                        lambda cfg: lambda i: fused_expand_cuda(queries, corpus, i, visited, labels,
                                                                words, family="label"),
                        id_sets, dict(b=B, m=m, d=D_MAIN)),
        "fused_adc": ("fused_expand_adc", (m_sub, 32, 1),  # one shape
                      lambda cfg: lambda i: fused_expand_adc_cuda(lut, codes, i, visited, labels,
                                                                  words, family="label"),
                      id_sets, dict(b=B, m=m, d=m_sub, n_cent=n_cent)),
        "pq_adc": ("pq_adc", (m_sub, 1, 1),  # its lattice is its one shape
                   lambda cfg: lambda: pq_adc_cuda(lut, codes),
                   [()], dict(b=B, m=n, d=m_sub, n_cent=n_cent)),
    }
    out = {}
    for kernel, (wrapper, (d, deg, beam), at, sets, shape) in kernels.items():
        default = DEFAULT_CONFIGS[kernel]

        def outputs(cfg):
            got = at(cfg)(*sets[0])
            torch.cuda.synchronize()
            return got if isinstance(got, tuple) else (got,)

        want = outputs(default)
        points = lattice_configs(kernel)
        for cfg in points:
            got = outputs(cfg)
            check(all(torch.equal(g, w) for g, w in zip(got, want)),
                  f"tune {kernel}: {config_dims(kernel, cfg)} differs from the default's bits")
        chosen = table_config(kernel, d, deg=deg, beam=beam)
        reps = dict(reps=10, replays=3) if kernel == "pq_adc" else {}
        order = (default, chosen, chosen, default)
        t = [device_ms(at(cfg), sets, **reps) for cfg in order]
        table_ms, default_ms = min(t[1], t[2]), min(t[0], t[3])
        bound = occurrence_bound_ms(kernel, chosen, **shape)
        row = dict(kernel=kernel, wrapper=wrapper, key=dict(d=d, deg=deg, beam=beam),
                   config=config_dims(kernel, chosen), default=config_dims(kernel, default),
                   table_ms=table_ms, default_ms=default_ms, speedup=default_ms / table_ms,
                   readings_ms=t, bound_ms=bound[0], bound_by=bound[1],
                   lattice_points=len(points), bit_equal=True,
                   outputs=["dists", "satisfied", "fresh"][:len(want)])
        out[wrapper] = row
        log(f"tune {json.dumps(row)}")
    del corpus, codes, visited, id_sets
    torch.cuda.empty_cache()
    log(f"tune: phase wall {time.perf_counter() - t_phase:.1f} s (host clock)")
    return out


def roofline_line(cell: str, terms, wall_s: float, **extra) -> None:
    """One `roofline {...}` line: the analytic bound of a cell's batch
    (repro_torch/roofline/model.py, one H100) beside its measured wall."""
    from repro_torch.roofline.model import RooflineTerms

    flops, hbm, coll, model_flops = terms
    r = RooflineTerms(cell=cell, mesh="1x1", chips=1, flops=flops, hbm_bytes=hbm,
                      coll_bytes=coll, model_flops=model_flops)
    log("roofline " + json.dumps(dict(
        cell=cell, chips=1, **extra, flops=flops, hbm_bytes=hbm, coll_bytes=coll,
        t_compute_ms=r.t_compute * 1e3, t_memory_ms=r.t_memory * 1e3,
        t_collective_ms=r.t_collective * 1e3, bound_ms=r.step_time * 1e3,
        bottleneck=r.bottleneck, wall_ms=wall_s * 1e3, bound_over_wall=r.step_time / wall_s)))


# --------------------------------------------------------------------------- search


def small_world_phase(args, dev):
    """The search on the card (kernels) and on the CPU (plain versions)
    agree bit for bit on an integer-valued world, through both paths."""
    from repro_torch import (
        SearchParams,
        build_index,
        constrained_search,
        equal_constraint,
    )
    from repro_torch.core.types import Corpus

    gen = torch.Generator(device=dev).manual_seed(args.seed + 5)
    n, d = 8192, 16
    vec = torch.randint(-6, 7, (n, d), generator=gen, device=dev).float()
    lab = torch.randint(0, 10, (n,), generator=gen, dtype=torch.int32, device=dev)
    corpus = Corpus(vectors=vec, labels=lab)
    index = build_index(gen, corpus, degree=16, sample_size=64, device=dev)
    queries = torch.randint(-6, 7, (64, d), generator=gen, device=dev).float()
    qlab = torch.randint(0, 10, (64,), generator=gen, dtype=torch.int32, device=dev)
    cpu = torch.device("cpu")
    corpus_cpu = Corpus(vectors=vec.to(cpu), labels=lab.to(cpu))
    index_cpu = type(index)(*(t.to(cpu) for t in (index.neighbors, index.sample_ids,
                                                   index.entry_point)))
    for beam, fuse in ((1, "off"), (4, "off"), (1, "on"), (4, "on")):
        p = SearchParams(mode="prefer", k=10, ef_result=64, ef_sat=64, ef_other=64, n_start=16,
                         max_iters=256, beam_width=beam, use_kernel=True, fuse_expand=fuse)
        card = constrained_search(corpus, index, queries, equal_constraint(qlab, 10), p)
        host = constrained_search(corpus_cpu, index_cpu, queries.to(cpu),
                                  equal_constraint(qlab.to(cpu), 10), p)
        for field in ("ids", "dists"):
            check(torch.equal(getattr(card, field).cpu(), getattr(host, field)),
                  f"small world beam={beam} fuse={fuse}: {field} differ card vs CPU")
        for field in ("dist_evals", "hops", "visited", "iters", "beam_expansions"):
            check(torch.equal(getattr(card.stats, field).cpu(), getattr(host.stats, field)),
                  f"small world beam={beam} fuse={fuse}: {field} differ card vs CPU")
    log("small world: card == CPU plain versions, bit for bit, beam {1,4} x fuse {off,on}")

    # PQ over the same world: integer codebooks (m_sub = 16, d_sub = 1,
    # n_cent = 16) and codes at the argmin, so every LUT entry, ADC sum and
    # re-rank distance is an exact integer.
    from repro_torch import PQIndex, pq_constrained_search

    m_sub, n_cent = 16, 16
    cb = torch.randint(-6, 7, (m_sub, n_cent, d // m_sub), generator=gen, device=dev).float()
    codes = ((vec.reshape(n, m_sub, 1, -1) - cb[None]) ** 2).sum(-1).argmin(-1)
    pq = PQIndex(codebooks=cb, codes=codes.to(torch.int32).contiguous())
    pq_cpu = PQIndex(codebooks=cb.cpu(), codes=pq.codes.cpu())
    runs = {}
    for beam, fuse in ((1, "off"), (4, "off"), (1, "on"), (4, "on")):
        p = SearchParams(mode="prefer", k=10, ef_result=64, ef_sat=64, ef_other=64, n_start=16,
                         max_iters=256, beam_width=beam, fuse_expand=fuse, approx="pq")
        card = constrained_search(corpus, index, queries, equal_constraint(qlab, 10), p,
                                  pq_index=pq)
        host = constrained_search(corpus_cpu, index_cpu, queries.to(cpu),
                                  equal_constraint(qlab.to(cpu), 10), p, pq_index=pq_cpu)
        runs[beam, fuse] = card
        for field in ("ids", "dists"):
            check(torch.equal(getattr(card, field).cpu(), getattr(host, field)),
                  f"small PQ world beam={beam} fuse={fuse}: {field} differ card vs CPU")
        for field in ("dist_evals", "hops", "visited", "iters", "beam_expansions"):
            check(torch.equal(getattr(card.stats, field).cpu(), getattr(host.stats, field)),
                  f"small PQ world beam={beam} fuse={fuse}: {field} differ card vs CPU")
    for beam in (1, 4):
        a, b = runs[beam, "off"], runs[beam, "on"]
        check(torch.equal(a.ids, b.ids) and torch.equal(a.dists, b.dists)
              and torch.equal(a.stats.dist_evals, b.stats.dist_evals),
              f"small PQ world beam={beam}: fused differs from unfused on the card")
    card = pq_constrained_search(corpus, pq, queries, equal_constraint(qlab, 10), k=32,
                                 use_kernel=True)
    host = pq_constrained_search(corpus_cpu, pq_cpu, queries.to(cpu),
                                 equal_constraint(qlab.to(cpu), 10), k=32, use_kernel=True)
    for got, want, name in zip(card, host, ("dists", "ids")):
        check(torch.equal(got.cpu(), want), f"small PQ world scan: {name} differ card vs CPU")
    log("small world: PQ walk card == CPU plain versions, bit for bit, beam {1,4} x fuse "
        "{off,on}, fused == unfused; PQ scan (pq_adc) card == CPU")

    # The build over the same world: nn_descent with one set of draws
    # (gather_distance on the card, its plain version on the CPU) bit for
    # bit, and a 4-shard partitioned layout over n - 2 rows (so the last
    # shard is padded) through l2_matmul. Its kNN graphs (no reverse edges)
    # are compared up to distance ties: topk orders ties freely.
    from repro_torch import build_partitioned_index
    from repro_torch.graph import nn_descent

    dgen = torch.Generator().manual_seed(args.seed + 7)
    degree, iters = 16, 8
    draws = dict(k0=torch.randint(0, n, (n, degree), generator=dgen, dtype=torch.int32),
                 cols=[torch.randint(0, degree, (n, degree, 2), generator=dgen, dtype=torch.int32)
                       for _ in range(iters)],
                 rand=[torch.randint(0, n, (n, degree), generator=dgen, dtype=torch.int32)
                       for _ in range(iters)])
    card = nn_descent(None, vec, degree, iters=iters, draws=draws, device=dev)
    host = nn_descent(None, vec.to(cpu), degree, iters=iters, draws=draws, device=cpu)
    check(torch.equal(card.cpu(), host), "small world: nn_descent differs card vs CPU")
    graph_invariants("small world nn_descent", vec, card, strict=True)
    m = n - 2
    parts = {}
    for where in (dev, cpu):
        sub = Corpus(vectors=vec[:m].to(where), labels=lab[:m].to(where))
        parts[where.type] = build_partitioned_index(
            torch.Generator(device=where).manual_seed(args.seed + 9), sub, 4, degree=degree,
            sample_size_per_shard=64, reverse_edges=False, device=where)
    (cc, cg), (hc, hg) = parts["cuda"], parts["cpu"]
    check(torch.equal(cc.vectors.cpu(), hc.vectors) and torch.equal(cc.labels.cpu(), hc.labels)
          and hc.n == n and torch.equal(hc.vectors[m:], hc.vectors[:2]),
          "small world: partitioned corpus (padding) differs card vs CPU")
    check(cg.entry_point.shape == (4,) and torch.equal(cg.entry_point.cpu(), hg.entry_point),
          "small world: partitioned entries differ card vs CPU")
    n_local = n // 4
    for s in range(4):
        rows = slice(s * n_local, (s + 1) * n_local)
        check(equal_up_to_ties(hc.vectors[rows], hg.neighbors[rows], cg.neighbors[rows].cpu()),
              f"small world: partitioned shard {s} kNN graph differs card vs CPU beyond ties")
        samp = cg.sample_ids[s * 64 : (s + 1) * 64]
        check(int(samp.min()) >= 0 and int(samp.max()) < n_local
              and torch.unique(samp).numel() == 64, f"small world: shard {s} sample not local")
    log(f"small world: nn_descent ({iters} rounds, same draws) card == CPU bit for bit; "
        f"build_partitioned_index (4 shards over {m} rows, 2 padded) card == CPU in corpus, "
        f"entries and kNN graphs up to distance ties")
    small_world_serving(args, dev, corpus, index, corpus_cpu, index_cpu)


def small_world_serving(args, dev, corpus, index, corpus_cpu, index_cpu):
    """One 64-request mixed stream (no jitter: integer queries) drained
    through the serving runtime on the card and on the CPU: the responses
    agree bit for bit, unfused and fused."""
    import dataclasses

    import numpy as np

    from repro_torch.core.types import Corpus
    from repro_torch.serving import (
        LocalExecutor,
        ServingRuntime,
        VirtualClock,
        make_tier_ladder,
        mixed_workload,
    )

    agen = torch.Generator().manual_seed(args.seed + 11)
    attrs = torch.rand((corpus.n, 2), generator=agen)
    worlds = {"card": (Corpus(vectors=corpus.vectors, labels=corpus.labels,
                              attrs=attrs.to(dev)), index),
              "cpu": (Corpus(vectors=corpus_cpu.vectors, labels=corpus_cpu.labels, attrs=attrs),
                      index_cpu)}
    items = mixed_workload(3, worlds["cpu"][0], 64, 10, k_choices=(4, 8, 16), jitter=0.0)
    # Default tiers (use_kernel off): on the card the runtime scores through
    # gather_distance all the same, on the CPU through the exact backend.
    counters = kernel_counters()
    for extra, kernel in ((dict(), "gather_distance"), (dict(fuse_expand="on"), "fused_expand")):
        tiers = tuple(dataclasses.replace(t, **extra) for t in make_tier_ladder(
            k_cap=16, base_ef=32, base_iters=64, base_n_start=16, n_tiers=2))
        out = {}
        for where, (c, g) in worlds.items():
            rt = ServingRuntime(LocalExecutor(c, g), n_labels=10, tiers=tiers, ladder=(8, 32),
                                clock=VirtualClock())
            rids = [rt.submit(it.query, it.k, it.family, it.operand) for it in items]
            before = counters[kernel].launches
            rt.drain()
            out[where] = ([rt.poll(r) for r in rids], dict(rt.telemetry.counters))
            if where == "card":
                check(counters[kernel].launches > before,
                      f"small world serving {extra}: the card runtime never launched {kernel}")
        for a, b in zip(out["cpu"][0], out["card"][0]):
            check(np.array_equal(a.ids, b.ids) and np.array_equal(a.dists, b.dists)
                  and (a.filled, a.tier, a.escalations, a.strategy)
                  == (b.filled, b.tier, b.escalations, b.strategy),
                  f"small world serving {extra}: request {a.req_id} differs card vs CPU")
        check(out["cpu"][1] == out["card"][1],
              f"small world serving {extra}: telemetry counters differ card vs CPU")
        log(f"small world: serving runtime drain of 64 requests card == CPU bit for bit "
            f"{json.dumps(extra)} (escalations {out['card'][1].get('escalations', 0)})")


def two_tower_small_phase(args, dev):
    """The two-tower model at the published widths with a small vocab, the
    same weights on the card (kernels) and on the CPU (plain versions): bags
    bit for bit, towers within 1e-5 abs (cuBLAS and CPU BLAS add in other
    orders), retrieval top-100 ids equal above every score gap > 1e-4."""
    import copy
    import dataclasses

    from repro_torch.data import two_tower_batch
    from repro_torch.kernels.embedding_bag import embedding_bag
    from repro_torch.models.recsys import two_tower_init

    cpu = torch.device("cpu")
    cfg = dataclasses.replace(tt_config(), item_vocab=4096, user_vocab=4096)
    # serving only: no autograd graph (the model is trainable)
    host = two_tower_init(torch.Generator().manual_seed(args.seed + 29), cfg,
                          device=cpu).requires_grad_(False)
    card = copy.deepcopy(host).to(dev)
    hb = two_tower_batch(args.seed, 0, 64, cfg.user_vocab, cfg.item_vocab, cfg.hist_len,
                         device=cpu)
    cb = {k: t.to(dev) for k, t in hb.items()}
    check(torch.equal(embedding_bag(card.item_emb, cb["hist"]).cpu(),
                      embedding_bag(host.item_emb, hb["hist"])),
          "two-tower small: history bags differ card vs CPU")
    items = torch.arange(cfg.item_vocab, dtype=torch.int32)
    pairs = ((card.user(cb), host.user(hb), "user"),
             (card.item(cb["item_id"]), host.item(hb["item_id"]), "item"),
             (card.item(items.to(dev)), host.item(items), "item corpus"))
    errs = {}
    for got, want, name in pairs:
        errs[name] = float((got.cpu() - want).abs().max())
        check(errs[name] <= 1e-5, f"two-tower small: {name} tower differs card vs CPU by "
                                  f"{errs[name]} > 1e-5")
    cand_c, cand_h = pairs[2][0], pairs[2][1]
    (gv, gi), (wv, wi) = (card.score_candidates(dict(cb, candidates=cand_c)),
                          host.score_candidates(dict(hb, candidates=cand_h)))
    gi = gi.cpu()
    n_gaps = 0
    for b in range(wv.shape[0]):
        for j in torch.nonzero(wv[b, :-1] - wv[b, 1:] > 1e-4).flatten().tolist():
            check(torch.equal(gi[b, : j + 1].sort().values, wi[b, : j + 1].sort().values),
                  f"two-tower small: user {b}'s top-{j + 1} ids differ card vs CPU across a "
                  f"score gap > 1e-4")
            n_gaps += 1
    log(f"small two-tower (published widths, vocab {cfg.item_vocab}, B = 64): bags card == CPU "
        f"bit for bit; max abs diff user {errs['user']:.3e}, item {errs['item']:.3e}, item "
        f"corpus {errs['item corpus']:.3e} (<= 1e-5); retrieval top-100 ids equal above all "
        f"{n_gaps} score gaps > 1e-4")


def equal_up_to_ties(vec, want, got) -> bool:
    """The same distance profile per row, and the same ids strictly below
    each row's last distance (integer-valued vectors: exact distances)."""
    def dists(nbrs):
        d = ((vec[nbrs.clamp_min(0).long()] - vec[:, None, :]) ** 2).sum(-1)
        return torch.where(nbrs >= 0, d, float("inf"))

    want_d, got_d = dists(want), dists(got)
    strict = want_d < want_d[:, -1:]
    return torch.equal(want_d, got_d) and torch.equal(
        torch.where(strict, want, -1).sort(-1).values, torch.where(strict, got, -1).sort(-1).values)


def graph_invariants(name, vectors, nbrs, strict, rows=None) -> None:
    """Self-free, duplicate-free, padded with -1 only at a row's end, no
    empty row, rows distance-ascending. ``strict``: by gather_distance's
    distances, which ordered an NN-descent graph and a consolidation's
    rewritten rows; otherwise within 1e-6 relative (add_reverse_edges
    ordered by another reduction). ``rows``: the vertices whose rows
    ``nbrs`` holds, where they are not all of them in order."""
    from repro_torch.kernels.gather_distance import gather_distance_cuda

    if rows is None:
        rows = torch.arange(nbrs.shape[0], device=nbrs.device)
    valid = nbrs >= 0
    check(not bool((nbrs == rows[:, None]).any()), f"{name}: a self edge")
    check(bool(valid[:, 0].all()), f"{name}: an empty row")
    check(bool((valid[:, :-1] | ~valid[:, 1:]).all()), f"{name}: padding before an edge")
    srt = torch.where(valid, nbrs, 2**31 - 1).sort(-1).values
    check(not bool(((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] < 2**31 - 1)).any()),
          f"{name}: a duplicate edge")
    d = gather_distance_cuda(vectors[rows.long()].contiguous(), vectors, nbrs.contiguous())
    ok = d[:, 1:] >= d[:, :-1] if strict else d[:, 1:] >= d[:, :-1] * (1 - 1e-6)
    check(bool((ok | torch.isinf(d[:, 1:])).all()), f"{name}: a row not distance-ascending")


KERNEL_NAMES = ("gather_distance", "fused_expand", "fused_expand_adc", "pq_adc", "l2_matmul",
                "embedding_bag", "embedding_bag_backward")


def kernel_counters():
    from repro_torch.kernels.embedding_bag import embedding_bag, embedding_bag_backward
    from repro_torch.kernels.fused_expand import fused_expand, fused_expand_adc
    from repro_torch.kernels.gather_distance import gather_distance
    from repro_torch.kernels.l2_matmul import pairwise_sqdist
    from repro_torch.kernels.pq_adc import pq_adc

    return dict(zip(KERNEL_NAMES, (gather_distance, fused_expand, fused_expand_adc, pq_adc,
                                   pairwise_sqdist, embedding_bag, embedding_bag_backward)))


class LaunchCounts:
    """The ported kernels' launch counters: ``reset`` sets them to 0 just
    before a main-path run, ``read`` reads them just after and adds them to
    ``total`` (launches outside the main path, such as the comparisons with
    the plain versions and the profiled batches, are never read)."""

    def __init__(self):
        self.counters = kernel_counters()
        self.total = dict.fromkeys(KERNEL_NAMES, 0)

    def reset(self):
        torch.cuda.synchronize()
        for c in self.counters.values():
            c.launches = 0

    def read(self):
        torch.cuda.synchronize()
        got = {k: c.launches for k, c in self.counters.items()}
        for k, v in got.items():
            self.total[k] += v
        return got


def search_phase(args, dev, launch: LaunchCounts):
    from repro_torch import (
        SearchParams,
        build_index,
        constrained_search,
        equal_constraint,
        exact_constrained_search,
        make_labeled_corpus,
        make_queries,
        pq_constrained_search,
        pq_train,
        recall,
    )

    from repro_torch import GraphIndex
    from repro_torch.graph import add_reverse_edges
    from repro_torch.graph.build import span_seconds

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    corpus = make_labeled_corpus(gen, args.n, D_MAIN, 10, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    # The exact index, as build_index(reverse_edges=True) builds it, in two
    # calls so the kNN graph before reverse edges is kept for the
    # NN-descent recall below. The products (l2_matmul) and the masks and
    # top-k are timed by CUDA events inside the build.
    launch.reset()
    spans = {}
    knn = build_index(gen, corpus, degree=32, sample_size=128, method="exact",
                      reverse_edges=False, device=dev, spans=spans)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    nbrs = add_reverse_edges(knn.neighbors, corpus.vectors, 32)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    exact_launches = launch.read()
    index = GraphIndex(neighbors=nbrs, sample_ids=knn.sample_ids, entry_point=knn.entry_point)
    sec = span_seconds(spans)
    blocks = math.ceil(args.n / BUILD_BLOCK)
    log(f"world: airship-sift1m n={args.n} d={D_MAIN} labels=10 degree=32 sample=128; "
        f"corpus {t1 - t0:.2f} s, exact kNN index + reverse edges {t3 - t1:.2f} s")
    log(f"build exact: kNN graph + sample + medoid {t2 - t1:.3f} s (host clock) = products "
        f"{sec['products']:.3f} s ({blocks} l2_matmul launches of ({BUILD_BLOCK}, {args.n}, "
        f"{D_MAIN})) + masks and top-k {sec['topk']:.3f} s + the rest "
        f"{t2 - t1 - sec['products'] - sec['topk']:.3f} s; reverse edges {t3 - t2:.3f} s; "
        f"launches {json.dumps(exact_launches)}")
    check(exact_launches["l2_matmul"] == blocks + 1,
          f"exact build: {exact_launches['l2_matmul']} l2_matmul launches, expected {blocks} "
          f"row blocks + 1 medoid")
    check(int((index.neighbors >= 0).sum(-1).min()) > 0, "index has an empty adjacency row")

    queries, qlab = make_queries(gen, corpus, B)
    cons = equal_constraint(qlab, 10)
    _, true_ids = exact_constrained_search(corpus, queries, cons, 10)
    # The codebooks draw after the queries, so the exact shapes see the
    # same world and queries as before the PQ path existed.
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    pq = pq_train(gen, corpus.vectors, m_sub=16, n_cent=256, iters=20)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    recon = torch.cat([pq.codebooks[s][pq.codes[:, s].long()] for s in range(16)], -1)
    rel_err = float(((corpus.vectors - recon) ** 2).sum() / (corpus.vectors ** 2).sum())
    del recon
    log(f"world: pq_train m_sub=16 n_cent=256 iters=20 on the card {t4 - t3:.2f} s (set-up); "
        f"relative quantisation error {rel_err:.4f}")
    check(pq.codes.shape == (args.n, 16) and int(pq.codes.max()) < 256, "bad PQ codes")

    # The NN-descent index of the same world, from a generator of its own
    # (the exact shapes keep their world, queries and codebooks).
    ngen = torch.Generator(device=dev).manual_seed(args.seed + 23)
    launch.reset()
    spans = {}
    t5 = time.perf_counter()
    nnd = build_index(ngen, corpus, degree=32, sample_size=128, method="nn_descent",
                      reverse_edges=False, nn_descent_iters=NND_ITERS, device=dev,
                      spans=spans)
    torch.cuda.synchronize()
    t6 = time.perf_counter()
    nnd_nbrs = add_reverse_edges(nnd.neighbors, corpus.vectors, 32)
    torch.cuda.synchronize()
    t7 = time.perf_counter()
    nnd_launches = launch.read()
    nnd_index = GraphIndex(neighbors=nnd_nbrs, sample_ids=nnd.sample_ids,
                           entry_point=nnd.entry_point)
    check(nnd_launches["gather_distance"] == NND_ITERS + 1,
          f"nn_descent build: {nnd_launches['gather_distance']} gather_distance launches, "
          f"expected one a round, {NND_ITERS + 1}")
    graph_invariants("nn_descent kNN graph", corpus.vectors, nnd.neighbors, strict=True)
    graph_invariants("nn_descent index", corpus.vectors, nnd_nbrs, strict=False)
    knn_recall = knn_graph_recall(nnd.neighbors, knn.neighbors)
    sec = span_seconds(spans)
    log(f"build nn_descent: {NND_ITERS} rounds, kNN graph + sample + medoid "
        f"{t6 - t5:.3f} s (host clock; nn_descent {sec['nn_descent']:.3f} s by events = "
        f"distances {sec['distances']:.3f} s + sorts {sec['sorts']:.3f} s + the rest "
        f"{sec['nn_descent'] - sec['distances'] - sec['sorts']:.3f} s), "
        f"reverse edges {t7 - t6:.3f} s; invariants hold (self-free, duplicate-free, "
        f"-1 padded, no empty row, rows distance-ascending); kNN recall@32 against the exact "
        f"graph {knn_recall:.4f} over all {args.n} rows (both before reverse edges); launches "
        f"{json.dumps(nnd_launches)}")
    del knn
    nnd_chunk_timing(corpus.vectors, nnd.neighbors, ngen)

    base = dict(mode="prefer", k=10, ef_result=128, ef_sat=128, ef_other=128, n_start=32,
                max_iters=512)
    walks = {
        "serve_256": (index, dict(use_kernel=True)),
        "serve_256_beam4": (index, dict(use_kernel=True, beam_width=4)),
        # use_kernel also routes the entry vertex's distance through
        # gather_distance, so the fused run scores every candidate with the
        # same device function as serve_256 and must match it exactly.
        "serve_256_fused": (index, dict(use_kernel=True, fuse_expand="on")),
        "serve_256_pq": (index, dict(approx="pq")),
        "serve_256_pq_fused": (index, dict(approx="pq", fuse_expand="on")),
        "serve_256_nnd": (nnd_index, dict(use_kernel=True)),
    }

    def walk(graph, extra):
        res = constrained_search(corpus, graph, queries, cons, SearchParams(**base, **extra),
                                 pq_index=pq)
        return res.ids, res.dists, res

    runs = {name: (lambda g=graph, e=extra: walk(g, e)) for name, (graph, extra) in walks.items()}
    runs["pq_scan_256"] = lambda: (*pq_constrained_search(corpus, pq, queries, cons, k=10,
                                                          use_kernel=True)[::-1], None)
    results, rows = {}, []
    for name, run in runs.items():
        run()  # warm-up batch
        launch.reset()
        t0 = time.perf_counter()
        ids, dists, res = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        shape_counts = launch.read()
        results[name] = (ids, dists, res)
        check(ids.shape == (B, 10) and bool(torch.isfinite(dists[ids >= 0]).all()),
              f"{name}: bad result shape or non-finite distances")
        rec = float(recall(ids, true_ids))
        row = dict(shape=name, wall_s=wall, qps=B / wall, recall_at_10=rec,
                   filled_mean=float((ids >= 0).float().sum(-1).mean()), launches=shape_counts)
        if res is not None:
            row.update(iters=int(res.stats.iters),
                       dist_evals_mean=float(res.stats.dist_evals.float().mean()),
                       hops_mean=float(res.stats.hops.float().mean()))
        rows.append(row)
        log(f"search {json.dumps(row)}")
        # The floor catches a broken graph walk. The linear scan ranks by
        # ADC alone (the paper's PQ baseline, no exact re-rank), so its
        # recall measures the quantiser; it is held to its plain version
        # below instead.
        if res is not None:
            check(rec >= 0.5, f"{name}: recall@10 {rec} < 0.5")

    launches = {r["shape"]: r["launches"] for r in rows}
    check(results["serve_256"][2].stats.iters.item() > 0, "serve_256 ran no iteration")
    from repro_torch.archs.airship import AirshipServeConfig
    from repro_torch.roofline.model import airship_terms

    row = next(r for r in rows if r["shape"] == "serve_256")
    roofline_line("serve_256", airship_terms(AirshipServeConfig(n=args.n), B, 1,
                                             est_iters=row["iters"], tp=1),
                  row["wall_s"], tp=1, est_iters=row["iters"], batch=B)
    for name in ("serve_256", "serve_256_beam4", "serve_256_nnd"):
        check(launches[name]["gather_distance"] > 0, f"{name}: gather_distance was never launched")
    check(launches["serve_256_fused"]["fused_expand"] > 0,
          "serve_256_fused: fused_expand was never launched")
    check(launches["serve_256_pq_fused"]["fused_expand_adc"]
          == int(results["serve_256_pq_fused"][2].stats.iters),
          "serve_256_pq_fused: fused_expand_adc not launched once per iteration")
    check(launches["pq_scan_256"]["pq_adc"] == 1, "pq_scan_256: pq_adc not launched exactly once")
    for unfused, fused in (("serve_256", "serve_256_fused"), ("serve_256_pq", "serve_256_pq_fused")):
        a, b = results[unfused][2], results[fused][2]
        check(torch.equal(a.ids, b.ids) and torch.equal(a.dists, b.dists),
              f"{fused} differs from {unfused} (ids or dists)")
        for field in ("dist_evals", "hops", "visited", "iters", "beam_expansions"):
            check(torch.equal(getattr(a.stats, field), getattr(b.stats, field)),
                  f"{fused} differs from {unfused} in {field}")
        log(f"search: {fused} == {unfused} (ids, dists, every stat)")
    # The scan is held to its plain version at full size: the same ids and
    # ADC distances from PQBackend.scan_all (plain PyTorch on the card).
    plain_d, plain_i = pq_constrained_search(corpus, pq, queries, cons, k=10, use_kernel=False)
    check(torch.equal(plain_i, results["pq_scan_256"][0])
          and torch.equal(plain_d, results["pq_scan_256"][1]),
          "pq_scan_256 differs from the plain scan")
    log("search: pq_scan_256 == its plain version (ids, ADC dists)")
    for name in ("pq_scan_256", "serve_256", "serve_256_fused", "serve_256_pq_fused"):
        profile_batch(name, runs[name])
    return dict(corpus=corpus, index=index, queries=queries, cons=cons, base=base, pq=pq,
                true_ids=true_ids)


# --------------------------------------------------------------------------- streaming and hybrid

STREAM_DELETES = 10_000  # 1% of airship-sift1m's rows
STREAM_INSERTS = 64  # before and again after the consolidation
# Share of inserted vectors a walk for them must find: 0.34 and 0.42 at
# ef_insert 32 on the card (PERF.md), ~0 with a broken insert path.
REACH_FLOOR = 0.15
# Range windows on attrs column 0 (uniform on [0, 1)): selectivity ~0.05%
# and ~2% (posting scans, under the 1M / 32 = 31,250 cap) and ~30% (graph).
RANGE_WINDOWS = ((0.1, 0.1005, "posting"), (0.4, 0.42, "posting"), (0.5, 0.8, "graph"))


def no_dead_ids(name, snap, ids) -> None:
    from repro_torch.core.constraints import tombstone_test

    dead = tombstone_test(snap.corpus.tombstones, ids) & (ids >= 0)
    check(not bool(dead.any()), f"{name}: a tombstoned id was returned")


def ids_equal_up_to_ties(got_i, got_d, want_i, want_d, rtol=1e-5) -> bool:
    """Distances within ``rtol`` relative, and every id the oracle ranks
    strictly (beyond ``rtol``) below its k-th distance in the result."""
    if not torch.allclose(got_d, want_d, rtol=rtol, atol=0.0):
        return False
    strict = (want_d < want_d[:, -1:] * (1 - rtol)) & (want_i >= 0)
    found = (want_i[:, :, None] == got_i[:, None, :]).any(-1)
    return bool((found | ~strict).all())


def streaming_phase(args, dev, launch: LaunchCounts, world) -> None:
    """The streaming mutable index and hybrid execution over the
    airship-sift1m world of phase 6 (its corpus, exact index, queries and
    search parameters): deletes, walks over the churned snapshot, inserts,
    one consolidation, more inserts into the reclaimed slots, the strategy
    router, posting scans and one label overlay."""
    import numpy as np

    from repro_torch import (
        Corpus,
        RangeConstraint,
        SearchParams,
        SelectivityEstimator,
        StrategyRouter,
        StreamingIndex,
        build_overlay,
        constrained_search,
        equal_constraint,
        exact_constrained_search,
        overlay_search,
        posting_search,
        recall,
    )
    from repro_torch.core.posting import pad_posting, posting_bucket

    t_phase = time.perf_counter()
    corpus, index, queries, cons, base = (world[k] for k in
                                          ("corpus", "index", "queries", "cons", "base"))
    n = corpus.n
    agen = torch.Generator(device=dev).manual_seed(args.seed + 41)
    attrs = torch.rand((n, 2), generator=agen, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sidx = StreamingIndex.from_static(Corpus(vectors=corpus.vectors, labels=corpus.labels,
                                             attrs=attrs), index, ef_insert=32, seed=args.seed,
                                      device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    cap = sidx.capacity
    rs = np.random.RandomState(args.seed)

    # Deletes: every query's true top-1 (the walk will visit them) and
    # random live rows, 1% of n in all.
    _, true_ids = exact_constrained_search(corpus, queries, cons, 10)
    top1 = [int(i) for i in dict.fromkeys(true_ids[:, 0].tolist()) if i >= 0]
    chosen = set(top1)
    victims = list(top1)
    for i in rs.permutation(n).tolist():
        if len(victims) >= STREAM_DELETES:
            break
        if i not in chosen:
            victims.append(i)
            chosen.add(i)
    t0 = time.perf_counter()
    check(all(sidx.delete(v) for v in victims), "streaming: a delete of a live slot failed")
    delete_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    snap = sidx.snapshot()
    torch.cuda.synchronize()
    publish_ms = (time.perf_counter() - t0) * 1e3

    def walk(name, snapshot, extra):
        params = SearchParams(**base, **extra)
        constrained_search(snapshot.corpus, snapshot.graph, queries, cons, params)  # warm-up
        launch.reset()
        t0 = time.perf_counter()
        res = constrained_search(snapshot.corpus, snapshot.graph, queries, cons, params)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch.read()
        _, truth = exact_constrained_search(snapshot.corpus, queries, cons, 10)
        rec = float(recall(res.ids, truth))
        row = dict(shape=name, wall_s=wall, qps=B / wall, recall_at_10=rec,
                   iters=int(res.stats.iters),
                   dist_evals_mean=float(res.stats.dist_evals.float().mean()),
                   launches={k: v for k, v in counts.items() if v})
        log(f"search {json.dumps(row)}")
        no_dead_ids(name, snapshot, res.ids)
        check(rec >= 0.5, f"{name}: recall@10 {rec} < 0.5")
        return res, row, counts

    res_u, row_u, cnt_u = walk("stream_churn_serve_256", snap, dict(use_kernel=True))
    res_f, row_f, cnt_f = walk("stream_churn_serve_256_fused", snap,
                               dict(use_kernel=True, fuse_expand="on"))
    check(cnt_u["gather_distance"] > 0, "stream_churn_serve_256: gather_distance never launched")
    check(cnt_f["fused_expand"] > 0, "stream_churn_serve_256_fused: fused_expand never launched")
    check(torch.equal(res_u.ids, res_f.ids) and torch.equal(res_u.dists, res_f.dists),
          "stream_churn: fused differs from unfused (ids or dists)")
    for field in ("dist_evals", "hops", "visited", "iters", "beam_expansions"):
        check(torch.equal(getattr(res_u.stats, field), getattr(res_f.stats, field)),
              f"stream_churn: fused differs from unfused in {field}")

    def insert_batch(count):
        src = rs.choice(sidx.pool.live_ids(), size=count, replace=False)
        noise = rs.randn(count, D_MAIN).astype(np.float32) * 0.01
        vecs = corpus.vectors[torch.from_numpy(src).to(dev).long()].cpu().numpy() + noise
        labs = sidx.pool.labels[src]
        slots, walls = [], []
        launch.reset()
        for v, lab in zip(vecs, labs):
            t0 = time.perf_counter()
            slots.append(sidx.insert(v, label=int(lab), attrs=rs.rand(2).astype(np.float32)))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        counts = launch.read()
        check(counts["gather_distance"] == count,
              f"inserts: {counts['gather_distance']} gather_distance launches, expected one "
              f"batched patch an insert ({count})")
        # Reachability: a walk for each new vector (one batch of them; each
        # query walks on its own) should find its slot at distance 0. The
        # insert's own walk (ef_insert 32, at most 128 iterations: the
        # reference's parameters) often misses the source row's
        # neighbourhood at n = 1M; the slot is then wired to far vertices
        # whose rows all hold closer edges, no patch takes, and nothing
        # points at it, as in the reference on the same inputs. So the
        # share found is reported beside the share whose row holds its
        # source and the slots' in-degrees, and held to REACH_FLOOR, which
        # a broken insert path (no patch or no row written) cannot reach.
        snap = sidx.snapshot()
        q = torch.from_numpy(vecs).to(dev)
        lab_t = torch.from_numpy(labs.astype(np.int32)).to(dev)
        res = constrained_search(snap.corpus, snap.graph, q, equal_constraint(lab_t, 10),
                                 SearchParams(**base, use_kernel=True))
        slots_t = torch.tensor(slots, dtype=torch.int32, device=dev)
        hit = res.ids == slots_t[:, None]
        reach = float(hit.any(-1).float().mean())
        rows = sidx.neighbors[slots_t.long()]
        src_t = torch.from_numpy(src.astype(np.int32)).to(dev)
        in_deg = torch.stack([(sidx.neighbors == s).sum() for s in slots_t]).float()
        ms = np.sort(np.asarray(walls)) * 1e3
        stats = dict(count=count, p50_ms=float(np.percentile(ms, 50)),
                     p99_ms=float(np.percentile(ms, 99)), max_ms=float(ms[-1]),
                     reachable=reach,
                     source_in_row=float((rows == src_t[:, None]).any(-1).float().mean()),
                     in_degree_mean=float(in_deg.mean()),
                     in_degree_zero=float((in_deg == 0).float().mean()),
                     launches={k: v for k, v in counts.items() if v})
        log(f"inserts {json.dumps(stats)}")
        check(reach >= REACH_FLOOR, f"inserts: {reach} of them found by a walk < {REACH_FLOOR}")
        check(bool((res.dists[hit] == 0).all()), "inserts: an inserted vector not at distance 0")
        graph_invariants("inserted rows", sidx.pool.vectors, rows, strict=False,
                         rows=slots_t.long())
        return slots, stats

    slots1, ins1 = insert_batch(STREAM_INSERTS)

    # Consolidation of every pending slot.
    pending = list(sidx.pool.pending)
    dead = torch.zeros(cap, dtype=torch.bool, device=dev)
    dead[torch.tensor(pending, device=dev)] = True
    nbrs = sidx.neighbors
    hit_rows = torch.nonzero(((nbrs >= 0) & dead[nbrs.clamp_min(0).long()]).any(1)
                             & ~dead).flatten()
    torch.cuda.synchronize()
    launch.reset()
    t0 = time.perf_counter()
    done = sidx.consolidate()
    torch.cuda.synchronize()
    consolidate_s = time.perf_counter() - t0
    cons_counts = launch.read()
    check(done == len(pending), f"consolidate: {done} slots, expected {len(pending)}")
    check(cons_counts["gather_distance"] >= 1, "consolidate: gather_distance never launched")
    sidx.pool.check_accounting()
    sidx.check_stats_exact()
    graph_invariants("consolidated rows", sidx.pool.vectors, sidx.neighbors[hit_rows],
                     strict=True, rows=hit_rows)
    check(not bool(((sidx.neighbors >= 0) & dead[sidx.neighbors.clamp_min(0).long()]).any()),
          "consolidate: an edge still points at a reclaimed slot")
    check(sidx.pool.is_live(sidx.entry_point), "consolidate: the entry vertex is not live")
    slots2, ins2 = insert_batch(STREAM_INSERTS)
    check(slots2 == pending[::-1][:STREAM_INSERTS],
          "inserts after consolidation did not take the reclaimed slots in LIFO order")
    snap = sidx.snapshot()
    res_c, row_c, cnt_c = walk("stream_consolidated_serve_256", snap, dict(use_kernel=True))
    stream = dict(capacity=cap, deletes=len(victims), top1_deleted=len(top1),
                  setup_s=setup_s, delete_s=delete_s, publish_ms=publish_ms,
                  inserts_before=ins1, inserts_after=ins2, consolidated=done,
                  rewritten_rows=int(hit_rows.numel()), consolidate_s=consolidate_s,
                  consolidate_launches={k: v for k, v in cons_counts.items() if v},
                  recall_churned=row_u["recall_at_10"], recall_consolidated=row_c["recall_at_10"],
                  fused_equals_unfused=True, lifo_reuse=True)
    log(f"streaming {json.dumps(stream)}")

    # Hybrid: the router over the index's histograms, postings and range
    # postings (the cap is the world's n / 32).
    sidx.range_postings(0.0, 1.0, 0)  # sort the range index for this epoch
    router = StrategyRouter(SelectivityEstimator(histograms=sidx.histograms), n=n,
                            postings=sidx.postings, range_index=sidx.range_index)
    router.on_epoch(snap.epoch)
    label_routes = {}
    for lab in range(10):
        words = np.asarray([1 << lab], np.uint32)
        d = router.route("label", words)
        est = sidx.histograms.estimate("label", words)
        check(est == sidx.postings.count_label(lab) / sidx.pool.n_live,
              f"router: label {lab} estimate is not the live fraction")
        if est >= 0.05:
            check(d.strategy == "graph", f"router: label {lab} at {est:.4f} routed {d.strategy}")
        label_routes[lab] = (d.strategy, round(est, 5))
    hybrid = dict(label_routes=label_routes, posting=[])
    for lo, hi, want in RANGE_WINDOWS:
        d = router.route("range", (lo, hi, 0))
        check(d.strategy == want, f"router: range [{lo}, {hi}] routed {d.strategy}, not {want}")
        if want != "posting":
            hybrid["posting"].append(dict(window=[lo, hi], route=d.strategy,
                                          est=d.est_selectivity))
            continue
        ids = sidx.range_postings(lo, hi, 0)
        padded = torch.from_numpy(pad_posting(ids, posting_bucket(ids.shape[0]))).to(dev)
        rcons = RangeConstraint(lo=torch.full((B,), lo, device=dev),
                                hi=torch.full((B,), hi, device=dev), col=0)
        params = SearchParams(**base, use_kernel=True)
        posting_search(snap.corpus, queries, rcons, padded, params)  # warm-up
        launch.reset()
        t0 = time.perf_counter()
        res = posting_search(snap.corpus, queries, rcons, padded, params)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch.read()
        check(counts["gather_distance"] == 1, "posting scan: not one gather_distance launch")
        od, oi = exact_constrained_search(snap.corpus, queries, rcons, 10)
        no_dead_ids("posting scan", snap, res.ids)
        check(ids_equal_up_to_ties(res.ids, res.dists, oi, od),
              f"posting scan [{lo}, {hi}] differs from the exact oracle beyond ties")
        # With and without the kernel on integer-valued rows (every
        # distance exact): the same ids and distances.
        icorp = Corpus(vectors=(snap.corpus.vectors * 8).round(), labels=snap.corpus.labels,
                       attrs=snap.corpus.attrs, tombstones=snap.corpus.tombstones)
        iq = (queries * 8).round()
        a = posting_search(icorp, iq, rcons, padded, params)
        b = posting_search(icorp, iq, rcons, padded, SearchParams(**base))
        check(torch.equal(a.ids, b.ids) and torch.equal(a.dists, b.dists),
              "posting scan: the kernel differs from the plain scan on integer rows")
        del icorp
        hybrid["posting"].append(dict(window=[lo, hi], route=d.strategy, est=d.est_selectivity,
                                      postings=int(ids.shape[0]), bucket=int(padded.shape[0]),
                                      wall_ms=wall * 1e3,
                                      launches={k: v for k, v in counts.items() if v}))

    # One label's overlay from its live postings, searched by 256 queries
    # of that label (make_queries' law: a random member plus 0.05 jitter).
    counts_by_label = [sidx.postings.count_label(lab) for lab in range(10)]
    lab = int(np.argsort(counts_by_label)[5])
    post = sidx.postings.ids_for_label(lab)
    qsrc = torch.from_numpy(rs.choice(post, size=B, replace=False)).to(dev).long()
    qgen = torch.Generator(device=dev).manual_seed(args.seed + 43)
    oq = (sidx.pool.vectors[qsrc]
          + torch.randn((B, D_MAIN), generator=qgen, device=dev) * 0.05).contiguous()
    ogen = torch.Generator(device=dev).manual_seed(args.seed + 47)
    torch.cuda.synchronize()
    launch.reset()
    t0 = time.perf_counter()
    ov = build_overlay(lab, post, sidx.pool.vectors, snap.epoch, generator=ogen, degree=32,
                       sample_size=128, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_counts = launch.read()
    want_l2 = math.ceil(post.shape[0] / BUILD_BLOCK) + 1
    check(build_counts["l2_matmul"] == want_l2,
          f"overlay build: {build_counts['l2_matmul']} l2_matmul launches, expected {want_l2}")
    oparams = SearchParams(**base, use_kernel=True)
    overlay_search(ov, oq, oparams)  # warm-up
    launch.reset()
    t0 = time.perf_counter()
    res = overlay_search(ov, oq, oparams)
    torch.cuda.synchronize()
    search_s = time.perf_counter() - t0
    search_counts = launch.read()
    ocons = equal_constraint(torch.full((B,), lab, dtype=torch.int32, device=dev), 10)
    _, truth = exact_constrained_search(snap.corpus, oq, ocons, 10)
    rec = float(recall(res.ids, truth))
    got = res.ids[res.ids >= 0]
    check(bool(torch.isin(got, torch.from_numpy(post).to(dev)).all()),
          "overlay: an id outside the label's live postings")
    check(rec >= 0.5, f"overlay: recall@10 {rec} < 0.5")
    check(search_counts["gather_distance"] > 0, "overlay search: gather_distance never launched")
    hybrid["overlay"] = dict(label=lab, postings=int(post.shape[0]), degree=32, sample=128,
                             build_s=build_s, build_launches={k: v for k, v in
                                                              build_counts.items() if v},
                             search_wall_s=search_s, qps=B / search_s, recall_at_10=rec,
                             iters=int(res.stats.iters),
                             search_launches={k: v for k, v in search_counts.items() if v})
    log(f"hybrid {json.dumps(hybrid)}")
    log(f"streaming and hybrid: phase wall {time.perf_counter() - t_phase:.1f} s (host clock, "
        f"checks included)")


# --------------------------------------------------------------------------- serving

SERVE_REQUESTS = 1024  # serve_mixed_1m and serve_mixed_1m_fused
# Cut to bound the phase's time (PERF.md §4): every flush, 8 rows or 128,
# runs its slowest query's walk, ~1-2 s of host-bound iterations.
SERVE_DRAIN = 64  # the deterministic drains that hold fused == unfused
SERVE_HYBRID = 256  # serve_hybrid_1m, cut from 1024
SERVE_CHURN = 512  # serve_churn_1m's items (0.3 of them mutations)
SERVE_PQ = 128  # serve_mixed_1m_pq, cut from 256
SERVE_RATE = 20_000.0  # Poisson arrivals a second of virtual time
SERVE_K_CAP = 16


def serving_tiers(**extra):
    """airship-sift1m's SearchParams as tier 0 with a 4x escalation tier."""
    import dataclasses

    from repro_torch.serving import make_tier_ladder

    tiers = make_tier_ladder(k_cap=SERVE_K_CAP, base_ef=128, base_iters=512, base_n_start=32,
                             n_tiers=2)
    return tuple(dataclasses.replace(t, **extra) for t in tiers)


def response_satisfies(resp, item, labels_host, attrs_host) -> bool:
    """Every returned id satisfies the request's constraint (host check)."""
    import numpy as np

    ids = resp.ids[resp.ids >= 0]
    if item.family == "label":
        words = np.asarray(item.operand, np.uint32)
        lab = labels_host[ids]
        return bool(((words[lab // 32] >> (lab % 32).astype(np.uint32)) & 1).all())
    lo, hi, col = item.operand
    vals = attrs_host[ids, int(col)]
    return bool(((vals >= np.float32(lo)) & (vals <= np.float32(hi))).all())


def exact_recall_by_family(corpus, items, responses, dev) -> dict:
    """Mean recall@k of served responses against the exact oracle on each
    request's own constraint, per family."""
    import numpy as np

    from repro_torch import LabelSetConstraint, RangeConstraint, exact_constrained_search

    out = {}
    for family in ("label", "range"):
        pairs = [(it, r) for it, r in zip(items, responses)
                 if it.family == family and r is not None and r.ok]
        if not pairs:
            continue
        rec = []
        for s in range(0, len(pairs), 256):
            chunk = pairs[s : s + 256]
            q = torch.from_numpy(np.stack([it.query for it, _ in chunk])).to(dev)
            if family == "label":
                words = np.stack([np.asarray(it.operand, np.uint32) for it, _ in chunk])
                cons = LabelSetConstraint(words=torch.from_numpy(words.view(np.int32)).to(dev))
            else:
                cons = RangeConstraint(
                    lo=torch.tensor([it.operand[0] for it, _ in chunk], dtype=torch.float32,
                                    device=dev),
                    hi=torch.tensor([it.operand[1] for it, _ in chunk], dtype=torch.float32,
                                    device=dev),
                    col=int(chunk[0][0].operand[2]))
            _, truth = exact_constrained_search(corpus, q, cons, SERVE_K_CAP)
            truth = truth.cpu().numpy()
            for (it, r), t in zip(chunk, truth):
                want = t[: it.k][t[: it.k] >= 0]
                got = r.ids[r.ids >= 0]
                rec.append(len(np.intersect1d(want, got)) / max(len(want), 1))
        out[family] = float(np.mean(rec))
    return out


def serving_phase(args, dev, launch: LaunchCounts, world) -> None:
    """Phase 6c: the serving runtime (repro_torch.serving, .obs and
    .launch.serve) over phase 6's airship-sift1m world."""
    import contextlib
    import io

    import numpy as np

    from repro_torch import Corpus, StreamingIndex
    from repro_torch.core.constraints import tombstone_test
    from repro_torch.launch import serve
    from repro_torch.obs import JsonLogger, trace_consistent
    from repro_torch.serving import (
        LocalExecutor,
        ServingRuntime,
        StreamingLocalExecutor,
        VirtualClock,
        churn_workload,
        make_serving_router,
        mixed_workload,
        replay_churn,
        replay_poisson,
    )
    from repro_torch.serving.batcher import MicroBatch
    from repro_torch.serving.runtime import assemble_constraint, assemble_queries, read_back

    t_phase = time.perf_counter()
    corpus0, index, pq = world["corpus"], world["index"], world["pq"]
    n = corpus0.n
    agen = torch.Generator(device=dev).manual_seed(args.seed + 61)
    corpus = Corpus(vectors=corpus0.vectors, labels=corpus0.labels,
                    attrs=torch.rand((n, 2), generator=agen, device=dev))
    labels_host = corpus.labels.cpu().numpy()
    attrs_host = corpus.attrs.cpu().numpy()
    t0 = time.perf_counter()
    items = mixed_workload(7, corpus, SERVE_REQUESTS, 10, k_choices=(4, 8, 16))
    workload_s = time.perf_counter() - t0
    rows = {}

    def runtime_for(executor, tiers, **kw):
        return ServingRuntime(executor, n_labels=10, tiers=tiers, ladder=(8, 32, 128),
                              families=("label", "range"), max_wait=0.005,
                              max_pending=SERVE_REQUESTS + 1, clock=VirtualClock(), **kw)

    def account(name, runtime, items_, responses, rejected, extra_done=0, columns=None):
        """The accounting and constraint checks of one replay; ``columns``
        maps a response's epoch to the host labels and attributes its
        search read (default: the static corpus's)."""
        c = runtime.telemetry.counters
        served = [r for r in responses if r is not None]
        shed = sum(1 for r in served if r.shed_reason is not None)
        failed = sum(1 for r in served if r.error is not None)
        check(c["submitted"] + rejected == len(items_),
              f"{name}: {c['submitted']} submitted + {rejected} rejected != {len(items_)} items")
        check(c["completed"] + c["shed_total"] + extra_done == c["submitted"],
              f"{name}: completed {c['completed']} + shed {c['shed_total']} + mutations "
              f"{extra_done} != submitted {c['submitted']}")
        check(runtime.in_flight == 0, f"{name}: {runtime.in_flight} requests still in flight")
        check(runtime.cache.trace_count <= runtime.trace_budget,
              f"{name}: {runtime.cache.trace_count} closures > budget {runtime.trace_budget}")
        queries = [(it, r) for it, r in zip(items_, responses)
                   if r is not None and r.ok and it.family in ("label", "range")]
        for it, r in queries:
            labs, atts = (labels_host, attrs_host) if columns is None else columns(r.epoch)
            check(response_satisfies(r, it, labs, atts),
                  f"{name}: request {r.req_id} returned an id outside its constraint")
            check(r.trace is not None and trace_consistent(r.trace),
                  f"{name}: request {r.req_id}'s stage breakdown does not tile its latency")
        return served, shed, failed, queries

    def replay(name, runtime, items_, warm=False, churn=False, columns=None):
        launch.reset()
        t0 = time.perf_counter()
        built = runtime.warmup() if warm else None
        t1 = time.perf_counter()
        if churn:
            responses, rejected = replay_churn(runtime, items_, rate=SERVE_RATE, seed=11)
        else:
            responses, rejected = replay_poisson(runtime, items_, rate=SERVE_RATE, seed=11)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        counts = launch.read()
        c = runtime.telemetry.counters
        mutations = c["upserts_applied"] + c["deletes_applied"]
        served, shed, failed, queries = account(name, runtime, items_, responses, rejected,
                                                mutations, columns)
        summary = runtime.telemetry.summary()
        row = dict(shape=name, requests=len(items_), served=len(served) - shed - failed,
                   rejected=rejected, shed=shed, failed=failed,
                   qps_virtual=summary.get("qps"), latency_p50_s=summary.get("latency_p50"),
                   latency_p99_s=summary.get("latency_p99"),
                   mean_fill=summary.get("mean_fill_frac"),
                   cache_hit_rate=runtime.cache.stats()["hit_rate"],
                   closures=runtime.cache.trace_count, trace_budget=runtime.trace_budget,
                   escalations=c["escalations"], batches=c["batches"],
                   strategies={k[7:]: v for k, v in c.items() if k.startswith("routed_")}
                   or {"graph": c["completed"]},
                   busy_s=runtime.busy_seconds, replay_wall_s=t2 - t1,
                   warmup_wall_s=(t1 - t0) if warm else None, warmup_closures=built,
                   launches={k: v for k, v in counts.items() if v})
        if churn:
            row.update(upserts=c["upserts_applied"], deletes=c["deletes_applied"],
                       epoch_swaps=c["epoch_swaps"])
        return row, responses, counts

    # 1. serve_mixed_1m, warmed, with a JSON log
    rt1 = runtime_for(LocalExecutor(corpus, index), serving_tiers(), logger=JsonLogger())
    row, resp1, counts = replay("serve_mixed_1m", rt1, items, warm=True)
    check(row["warmup_closures"] == rt1.trace_budget == 12,
          f"serve_mixed_1m: warmup built {row['warmup_closures']} closures, budget 12")
    check(rt1.cache.misses == 0, f"serve_mixed_1m: {rt1.cache.misses} cache misses after warmup")
    check(counts["gather_distance"] > 0, "serve_mixed_1m: gather_distance never launched")
    row["recall"] = exact_recall_by_family(corpus, items, resp1, dev)
    row["log_records"] = rt1.logger.sink.emitted
    rows["serve_mixed_1m"] = row
    log(f"serving {json.dumps(row)}")

    # profile serve_mixed_1m: one 128-row label flush through a built closure
    first = [it for it in items if it.family == "label"][:128]
    from repro_torch.serving.types import Request

    reqs = [Request(req_id=i, query=it.query, k=it.k, family="label", operand=it.operand)
            for i, it in enumerate(first)]
    mb = MicroBatch(group=("label",), tier=0, bucket=128, requests=reqs)
    fn = rt1.cache.get((128, "label", 0))
    profile_batch("serve_mixed_1m", lambda: read_back(
        fn(assemble_queries(mb, D_MAIN, dev), assemble_constraint(mb, dev))))

    # 2. serve_mixed_1m_fused: the same stream with fuse_expand="on"
    fused_tiers = serving_tiers(fuse_expand="on")
    rt2 = runtime_for(LocalExecutor(corpus, index), fused_tiers)
    row, resp2, counts = replay("serve_mixed_1m_fused", rt2, items)
    check(counts["fused_expand"] > 0, "serve_mixed_1m_fused: fused_expand never launched")
    row["recall"] = exact_recall_by_family(corpus, items, resp2, dev)
    rows["serve_mixed_1m_fused"] = row
    log(f"serving {json.dumps(row)}")

    # 3. fused == unfused, request by request, on deterministic drains
    drained = {}
    for name, tiers in (("unfused", serving_tiers()), ("fused", fused_tiers)):
        rt = runtime_for(LocalExecutor(corpus, index), tiers)
        rids = [rt.submit(it.query, it.k, it.family, it.operand) for it in items[:SERVE_DRAIN]]
        t0 = time.perf_counter()
        rt.drain()
        drained[name] = ([rt.poll(r) for r in rids], time.perf_counter() - t0)
    for a, b in zip(drained["unfused"][0], drained["fused"][0]):
        check(np.array_equal(a.ids, b.ids) and np.array_equal(a.dists, b.dists)
              and (a.filled, a.tier, a.escalations) == (b.filled, b.tier, b.escalations),
              f"serving drain: request {a.req_id} differs fused vs unfused")
    log(f"serving: drains of {SERVE_DRAIN} requests fused == unfused (ids, dists, filled, tier, "
        f"escalations); walls {drained['unfused'][1]:.3f} / {drained['fused'][1]:.3f} s")

    # 4. serve_hybrid_1m: the strategy router over the static corpus
    ex4 = LocalExecutor(corpus, index)
    rt4 = runtime_for(ex4, serving_tiers())
    rt4.router = make_serving_router(ex4, n_labels=10, controller=rt4.controller)
    hybrid_items = items[:SERVE_HYBRID]
    row, resp4, counts = replay("serve_hybrid_1m", rt4, hybrid_items)
    overlays = rt4.overlays.stats()
    if overlays["builds"]:
        check(counts["l2_matmul"] > 0, "serve_hybrid_1m: an overlay built without l2_matmul")
    row["overlays"] = overlays
    row["recall"] = exact_recall_by_family(corpus, hybrid_items, resp4, dev)
    rows["serve_hybrid_1m"] = row
    log(f"serving {json.dumps(row)}")

    # 5. serve_churn_1m: a fresh streaming index under churn
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sidx = StreamingIndex.from_static(corpus, index, capacity=n + n // 2, ef_insert=32,
                                      seed=args.seed, device=dev)
    ex5 = StreamingLocalExecutor(sidx, consolidate_after=64)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    # every published epoch's tombstones, labels and attributes (device
    # tensors of the immutable snapshots), to check each response against
    # the epoch it names
    tombs = {}
    refresh = ex5.refresh

    def keep(snap):
        tombs[snap.epoch] = (snap.corpus.tombstones, snap.corpus.labels, snap.corpus.attrs)

    def refresh_and_keep():
        epoch = refresh()
        keep(ex5.snapshot)
        return epoch

    keep(ex5.snapshot)
    host_columns = {}

    def columns(epoch):
        if epoch not in host_columns:
            _, labs, atts = tombs[epoch]
            host_columns[epoch] = (labs.cpu().numpy(), atts.cpu().numpy())
        return host_columns[epoch]

    ex5.refresh = refresh_and_keep
    rt5 = runtime_for(ex5, serving_tiers())
    churn_items = churn_workload(7, corpus, SERVE_CHURN, 10, mutation_frac=0.3,
                                 k_choices=(4, 8, 16))
    row, resp5, counts = replay("serve_churn_1m", rt5, churn_items, churn=True,
                                columns=columns)
    dead = 0
    for it, r in zip(churn_items, resp5):
        if r is not None and r.ok and it.family in ("label", "range"):
            ids = torch.from_numpy(r.ids[r.ids >= 0].astype(np.int32)).to(dev)
            dead += int(tombstone_test(tombs[r.epoch][0], ids[None]).sum())
    check(dead == 0, f"serve_churn_1m: {dead} served ids tombstoned at their response's epoch")
    sidx.pool.check_accounting()
    sidx.check_stats_exact()
    check(counts["gather_distance"] > 0, "serve_churn_1m: gather_distance never launched")
    check(sidx.consolidations > 0, "serve_churn_1m: no consolidation ran under serving")
    row.update(setup_s=setup_s, epochs=len(tombs), consolidations=sidx.consolidations,
               index=rt5.report()["index"], tombstoned_served=dead)
    rows["serve_churn_1m"] = row
    log(f"serving {json.dumps(row)}")
    del ex5, rt5, sidx, tombs, host_columns, resp5

    # 6. serve_mixed_1m_pq: ADC walk with fused_expand_adc, exact re-rank
    rt6 = runtime_for(LocalExecutor(corpus, index, pq),
                      serving_tiers(approx="pq", fuse_expand="on"))
    pq_items = items[:SERVE_PQ]
    row, resp6, counts = replay("serve_mixed_1m_pq", rt6, pq_items)
    check(counts["fused_expand_adc"] > 0, "serve_mixed_1m_pq: fused_expand_adc never launched")
    row["recall"] = exact_recall_by_family(corpus, pq_items, resp6, dev)
    rows["serve_mixed_1m_pq"] = row
    log(f"serving {json.dumps(row)}")

    for name in ("serve_mixed_1m", "serve_mixed_1m_fused", "serve_hybrid_1m"):
        for family, rec in rows[name]["recall"].items():
            check(rec >= 0.5, f"{name}: {family} recall@k {rec} < 0.5")

    # the launcher end to end at its own default shape (n = 20,000, d = 32:
    # corpus, exact index through l2_matmul, warmup, replay, JSON log)
    log_path = Path(__file__).resolve().parent / "build" / "serve_log.jsonl"
    log_path.parent.mkdir(exist_ok=True)
    log_path.unlink(missing_ok=True)
    launch.reset()
    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve.main(["--requests", "64", "--log-json", str(log_path)])
    torch.cuda.synchronize()
    counts = launch.read()
    text = out.getvalue()
    check("served 64/64 requests" in text, "launcher: not every request served")
    check(counts["l2_matmul"] > 0 and counts["gather_distance"] > 0,
          "launcher: its index build or walk ran without the kernels")
    records = log_path.read_text().splitlines()
    log(f"serving launcher {json.dumps(dict(wall_s=time.perf_counter() - t0, log_records=len(records), launches={k: v for k, v in counts.items() if v}, summary=text.strip().splitlines()[-2]))}")
    log(f"serving: phase wall {time.perf_counter() - t_phase:.1f} s (host clock, checks "
        f"included; workload generation {workload_s:.2f} s)")


# --------------------------------------------------------------------------- scale-out

DIST_SHARDS = 4  # the (1, 4) mesh: four shards of 250,000 rows, all on the one card
DIST_SHAPES = ("serve_256", "serve_256_fused", "serve_256_pq_fused", "serve_bulk_8k")
# Cut to bound the phase's time (PERF.md §4): every flush is a whole
# host-bound walk (1-2 s), and the two replicas share one card and one GIL.
HTTP_REQUESTS = 64  # mixed label and range requests through the 2-replica front end
HTTP_CLIENTS = 8  # client threads sending them
LAUNCHER_REQUESTS = 4  # requests to the launcher's own front end
LAUNCHER_N = 20_000  # the launcher's own default corpus size
HTTP_TIMEOUT = 300  # seconds a client waits for one response


def http_json(addr, path, payload=None, timeout=HTTP_TIMEOUT):
    """(status, parsed JSON or text) of one GET (payload None) or POST."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(addr + path, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            body = r.read().decode()
            status = r.status
    except urllib.error.HTTPError as e:
        body, status = e.read().decode(), e.code
    try:
        return status, json.loads(body)
    except json.JSONDecodeError:
        return status, body


def search_body(item, n_labels=10) -> dict:
    """The /v1/search payload of one workload item."""
    import numpy as np

    body = {"query": item.query.tolist(), "k": item.k, "family": item.family}
    if item.family == "label":
        w = np.asarray(item.operand, np.uint32)
        body["labels"] = [x for x in range(n_labels) if w[x // 32] >> (x % 32) & 1]
    else:
        body["range"] = [float(item.operand[0]), float(item.operand[1]), int(item.operand[2])]
    return body


def scaleout_phase(args, dev, launch: LaunchCounts, world) -> None:
    """Phase 6d: the scatter-search-merge path on a (1, 4) mesh of one card,
    two replicas behind the HTTP front end (static, then streaming), and the
    launcher's --serve-http / --replicas and --distributed."""
    from repro_torch import (
        Corpus,
        GraphIndex,
        RangeConstraint,
        build_partitioned_index,
        constrained_search,
        equal_constraint,
        exact_constrained_search,
        make_distributed_search,
        make_queries,
        recall,
        shard_corpus_for_mesh,
    )
    from repro_torch.roofline.model import airship_terms
    from repro_torch.archs.airship import (
        AIRSHIP_SHAPES,
        AirshipServeConfig,
        serve_search,
        shape_params,
    )
    from repro_torch.distributed import MeshInfo
    from repro_torch.launch.mesh import make_test_mesh

    t_phase = time.perf_counter()
    corpus0, index, pq = world["corpus"], world["index"], world["pq"]
    queries, cons = world["queries"], world["cons"]
    n = corpus0.n
    cfg = AirshipServeConfig(n=n)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 71)
    corpus = Corpus(vectors=corpus0.vectors, labels=corpus0.labels,
                    attrs=torch.rand((n, 2), generator=gen, device=dev))

    # The partitioned index: 4 exact shard builds through l2_matmul.
    launch.reset()
    t0 = time.perf_counter()
    corpus_p, graph_p = build_partitioned_index(gen, corpus, DIST_SHARDS, degree=cfg.degree,
                                                sample_size_per_shard=cfg.sample_per_shard,
                                                device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_launches = launch.read()
    n_local = corpus_p.n // DIST_SHARDS
    blocks = math.ceil(n_local / BUILD_BLOCK)
    check(corpus_p.n == n and corpus_p.vectors.data_ptr() == corpus.vectors.data_ptr(),
          "partitioned corpus: 1M rows split into 4 shards need no padding")
    check(build_launches["l2_matmul"] == DIST_SHARDS * (blocks + 1),
          f"partitioned build: {build_launches['l2_matmul']} l2_matmul launches, expected "
          f"{DIST_SHARDS} x ({blocks} row blocks + 1 medoid)")
    check(int((graph_p.neighbors >= 0).sum(-1).min()) > 0, "partitioned index: an empty row")
    log(f"build partitioned: {DIST_SHARDS} shards x {n_local} rows, exact, degree {cfg.degree}, "
        f"sample {cfg.sample_per_shard} a shard: {build_s:.3f} s (host clock); launches "
        f"{json.dumps({k: v for k, v in build_launches.items() if v})}")

    mesh = make_test_mesh(DIST_SHARDS, model=DIST_SHARDS, device=dev)
    check(set(mesh.devices) == {dev} and mesh.shape == {"data": 1, "model": DIST_SHARDS},
          f"mesh: {mesh}")
    mi = MeshInfo(mesh=mesh)
    index_s = shard_corpus_for_mesh(corpus_p, graph_p, mesh)
    qgen = torch.Generator(device=dev).manual_seed(args.seed + 79)
    bulk_b = AIRSHIP_SHAPES["serve_bulk_8k"]["batch"]
    bq, bqlab = make_queries(qgen, corpus, bulk_b)
    bcons = equal_constraint(bqlab, 10)
    t0 = time.perf_counter()
    truth = {B: exact_constrained_search(corpus_p, queries, cons, 10)[1],
             bulk_b: exact_constrained_search(corpus_p, bq, bcons, 10)[1]}
    torch.cuda.synchronize()
    oracle_s = time.perf_counter() - t0

    def satisfied(ids, c) -> bool:
        lab = corpus_p.labels[ids.clamp_min(0).long()]
        word = c.words.gather(1, (lab // 32).long())
        ok = ((word >> (lab % 32)) & 1) == 1
        return bool((ok | (ids < 0)).all())

    def run(name, search, q, c, pqi, truth_ids, warm=False):
        if warm:
            search(index_s, q, c, pqi)  # warm-up batch
        walls = []
        launch.reset()
        t0 = time.perf_counter()
        res = search(index_s, q, c, pqi, shard_walls=walls)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch.read()
        rec = float(recall(res.ids, truth_ids))
        row = dict(shape=name, batch=q.shape[0], wall_s=wall, qps=q.shape[0] / wall,
                   iters=int(res.stats.iters), recall_at_10=rec,
                   shard_walls_s=[w for _, _, w in walls],
                   dist_evals_mean=float(res.stats.dist_evals.float().mean()),
                   filled_mean=float((res.ids >= 0).float().sum(-1).mean()),
                   launches={k: v for k, v in counts.items() if v})
        log(f"distributed {json.dumps(row)}")
        check(res.ids.shape == (q.shape[0], 10) and bool(torch.isfinite(res.dists[res.ids >= 0]).all()),
              f"{name}: bad result shape or non-finite distances")
        check(rec >= 0.5, f"{name}: recall@10 {rec} < 0.5")
        check(len(walls) == DIST_SHARDS, f"{name}: {len(walls)} shard walks, expected {DIST_SHARDS}")
        dist_rows[name] = row
        return res, counts

    dist_rows = {}

    results = {}
    for shape in DIST_SHAPES:
        b = AIRSHIP_SHAPES[shape]["batch"]
        q, c = (queries, cons) if b == B else (bq, bcons)
        params = shape_params(cfg, shape, dev)
        pqi = pq if params.approx == "pq" else None
        # One warm-up batch before the first shape: the kernels loaded in
        # phase 3, and every shape walks the same code.
        res, counts = run(f"dist_{shape[6:]}_p4", serve_search(cfg, shape, mi), q, c, pqi,
                          truth[b], warm=shape == DIST_SHAPES[0])
        results[shape] = res
        check(satisfied(res.ids, c), f"{shape}: a returned id outside its label set")
        kernel = ("fused_expand_adc" if params.approx == "pq" and params.fuse_expand == "on"
                  else "fused_expand" if params.fuse_expand == "on" else "gather_distance")
        check(counts[kernel] >= DIST_SHARDS, f"{shape}: {kernel} launched {counts[kernel]} times")
    row = dist_rows["dist_256_p4"]
    roofline_line("dist_256_p4", airship_terms(cfg, B, 1, est_iters=row["iters"], tp=DIST_SHARDS),
                  row["wall_s"], tp=DIST_SHARDS, est_iters=row["iters"], batch=B)
    a, f = results["serve_256"], results["serve_256_fused"]
    check(torch.equal(a.ids, f.ids) and torch.equal(a.dists, f.dists),
          "dist serve_256_fused differs from serve_256 (ids or dists)")
    for field in ("dist_evals", "hops", "visited", "iters", "beam_expansions"):
        check(torch.equal(getattr(a.stats, field), getattr(f.stats, field)),
              f"dist serve_256_fused differs from serve_256 in {field}")

    # The (1, 4) result against the per-shard composition by hand.
    params = shape_params(cfg, "serve_256", dev)
    s_local = graph_p.sample_ids.shape[0] // DIST_SHARDS

    def shard_walk(m):
        sl = slice(m * n_local, (m + 1) * n_local)
        return constrained_search(
            Corpus(vectors=corpus_p.vectors[sl], labels=corpus_p.labels[sl]),
            GraphIndex(neighbors=graph_p.neighbors[sl],
                       sample_ids=graph_p.sample_ids[m * s_local : (m + 1) * s_local],
                       entry_point=graph_p.entry_point[m]), queries, cons, params)

    parts = [shard_walk(m) for m in range(DIST_SHARDS)]
    flat_d = torch.cat([r.dists for r in parts], 1)
    flat_i = torch.cat([torch.where(r.ids >= 0, r.ids + m * n_local, -1)
                        for m, r in enumerate(parts)], 1)
    hand_d, pos = torch.sort(flat_d, dim=-1, stable=True)
    hand_d = hand_d[:, :10]
    hand_i = torch.where(torch.isfinite(hand_d), flat_i.gather(1, pos[:, :10]), -1)
    check(torch.equal(hand_d, a.dists) and torch.equal(hand_i, a.ids),
          "dist_256_p4 differs from its per-shard composition (ids or dists)")
    check(torch.equal(sum(r.stats.dist_evals for r in parts), a.stats.dist_evals)
          and int(max(int(r.stats.iters) for r in parts)) == int(a.stats.iters),
          "dist_256_p4's stats differ from the per-shard composition")
    # The device busy share of one shard's walk (a quarter of the batch; the
    # trace of all four costs minutes of processing on the host).
    profile_batch("dist_256_p4 shard 0", lambda: shard_walk(0))
    log(f"distributed: dist_256_fused_p4 == dist_256_p4 (ids, dists, every stat); dist_256_p4 "
        f"== the per-shard composition by hand (4 constrained_search calls + a stable merge), "
        f"bit for bit; every id inside its label set; oracle {oracle_s:.2f} s (set-up)")

    # One range batch on the (1, 4) mesh (attrs column 0, windows of 0.3).
    rgen = torch.Generator(device=dev).manual_seed(args.seed + 83)
    lo = torch.rand((B,), generator=rgen, device=dev) * 0.7
    rcons = RangeConstraint(lo=lo, hi=lo + 0.3, col=0)
    rtruth = exact_constrained_search(corpus_p, queries, rcons, 10)[1]
    res, counts = run("dist_256_range_p4",
                      serve_search(cfg, "serve_256", mi, constraint_type=RangeConstraint),
                      queries, rcons, None, rtruth)
    vals = corpus_p.attrs[res.ids.clamp_min(0).long(), 0]
    check(bool((((vals >= rcons.lo[:, None]) & (vals <= rcons.hi[:, None])) | (res.ids < 0)).all()),
          "dist_256_range_p4: a returned id outside its range")

    # The (1, 1) mesh over phase 6's own index equals constrained_search.
    mesh1 = make_test_mesh(1, model=1, device=dev)
    search1 = make_distributed_search(mesh1, params)
    plain_corpus = Corpus(vectors=corpus0.vectors, labels=corpus0.labels)
    index1 = shard_corpus_for_mesh(plain_corpus, index, mesh1)
    launch.reset()
    t0 = time.perf_counter()
    r1 = search1(index1, queries, cons)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch.read()
    want = constrained_search(plain_corpus, index, queries, cons, params)
    check(torch.equal(r1.ids, want.ids) and torch.equal(r1.dists, want.dists)
          and all(torch.equal(getattr(r1.stats, f_), getattr(want.stats, f_))
                  for f_ in ("dist_evals", "hops", "visited", "iters", "beam_expansions")),
          "dist_256_p1 differs from constrained_search")
    check(counts["gather_distance"] > 0, "dist_256_p1: gather_distance never launched")
    log(f"distributed {json.dumps(dict(shape='dist_256_p1', batch=B, wall_s=wall, qps=B / wall, iters=int(r1.stats.iters), recall_at_10=float(recall(r1.ids, world['true_ids'])), launches={k: v for k, v in counts.items() if v}))}")
    log("distributed: dist_256_p1 == constrained_search over phase 6's index (ids, dists, "
        "every stat)")
    del results, parts, index_s, graph_p, corpus_p, truth, bq, bcons
    log(f"distributed: part wall {time.perf_counter() - t_phase:.1f} s (host clock)")

    log_memory("after the distributed part of phase 6d")
    http_part(args, dev, launch, corpus, index)
    log(f"scale-out: phase wall {time.perf_counter() - t_phase:.1f} s (host clock, checks "
        f"included)")


def http_part(args, dev, launch: LaunchCounts, corpus, index) -> None:
    """Phase 6d, second half: two replicas behind ServingFrontend over phase
    6's static index, then two streaming replicas with their own slot pools,
    then the launcher (its --serve-http in a subprocess, its --distributed
    in this process)."""
    import concurrent.futures
    import contextlib
    import io
    import os
    import queue
    import signal
    import threading
    import types

    import numpy as np

    from repro_torch import StreamingIndex
    from repro_torch.launch import serve
    from repro_torch.obs import ServingFrontend, parse_exposition
    from repro_torch.serving import (
        LocalExecutor,
        ReplicaSet,
        ServingRuntime,
        StreamingLocalExecutor,
        label_words_row,
        mixed_workload,
        percentile,
        wall_clock,
    )

    t_part = time.perf_counter()
    n = corpus.n
    labels_host = corpus.labels.cpu().numpy()
    attrs_host = corpus.attrs.cpu().numpy()

    def replica(executor):
        return ServingRuntime(executor, n_labels=10, tiers=serving_tiers(), ladder=(8, 32, 128),
                              families=("label", "range"), max_wait=0.005, max_pending=1024,
                              clock=wall_clock)

    items = mixed_workload(7, corpus, HTTP_REQUESTS, 10, k_choices=(4, 8, 16))
    tier = ReplicaSet([replica(LocalExecutor(corpus, index)) for _ in range(2)])
    launch.reset()
    fe = ServingFrontend(tier, host="127.0.0.1", port=0)
    addr = fe.start()

    def send(item):
        t0 = time.perf_counter()
        status, body = http_json(addr, "/v1/search", search_body(item))
        return status, body, time.perf_counter() - t0

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(HTTP_CLIENTS) as pool:
        answers = list(pool.map(send, items))
    wall = time.perf_counter() - t0
    for it, (status, body, _) in zip(items, answers):
        check(status == 200 and body.get("error") is None, f"http: status {status}: {body}")
        resp = types.SimpleNamespace(ids=np.asarray(body["ids"], np.int64))
        check(response_satisfies(resp, it, labels_host, attrs_host),
              f"http: request {body['req_id']} returned an id outside its constraint")
    status, text = http_json(addr, "/metrics")
    check(status == 200 and isinstance(text, str), f"/metrics: status {status}")
    fams = parse_exposition(text)
    events = fams["repro_serving_events_total"]
    for i, rt in enumerate(tier.replicas):
        with tier.locks[i]:
            for key, v in rt.telemetry.counters.items():
                check(events.value(event=key, replica=str(i)) == v,
                      f"/metrics: replica {i} {key} {events.value(event=key, replica=str(i))} "
                      f"!= telemetry {v}")
            check(fams["repro_serving_latency_seconds"].hist_count(replica=str(i))
                  == rt.telemetry.latency_hist.total, f"/metrics: replica {i} latency count")
    check(fams["repro_tier_replicas"].value() == 2, "/metrics: tier replicas")
    status, health = http_json(addr, "/healthz")
    check(status == 200 and health["status"] == "ok" and len(health["replicas"]) == 2,
          f"/healthz: {health}")
    status, varz = http_json(addr, "/varz")
    check(status == 200 and varz["n_replicas"] == 2 and varz["started_requests"] == HTTP_REQUESTS,
          f"/varz: {status}")
    report = fe.close(drain=True)
    torch.cuda.synchronize()
    counts = launch.read()
    check(report["in_flight"] == 0, f"http close: {report['in_flight']} requests in flight")
    for i, rt in enumerate(tier.replicas):
        c = rt.telemetry.counters
        check(c["submitted"] == c["completed"] + c["shed_total"],
              f"http close: replica {i} lost a request")
    check(sum(report["completed_per_replica"]) == HTTP_REQUESTS, "http: a request not completed")
    check(counts["gather_distance"] > 0, "http: gather_distance never launched")
    lat = [t for _, _, t in answers]
    share = [sum(1 for _, b, _ in answers if b["replica"] == i) / HTTP_REQUESTS for i in (0, 1)]
    row = dict(shape="http_2rep_1m", requests=HTTP_REQUESTS, clients=HTTP_CLIENTS, wall_s=wall,
               req_per_s_wall=HTTP_REQUESTS / wall, latency_p50_s=percentile(lat, 50),
               latency_p99_s=percentile(lat, 99), replica_share=share,
               flushes=[rt.telemetry.counters["batches"] for rt in tier.replicas],
               busy_s=[rt.busy_seconds for rt in tier.replicas], scrape_bytes=len(text.encode()),
               families=len(fams), launches={k: v for k, v in counts.items() if v})
    log(f"http {json.dumps(row)}")
    del tier, fe

    # Two streaming replicas, each with its own 1.5M-slot pool.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stier = ReplicaSet([
        replica(StreamingLocalExecutor(StreamingIndex.from_static(
            corpus, index, capacity=n + n // 2, ef_insert=32, seed=args.seed, device=dev),
            consolidate_after=64)) for _ in range(2)])
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    launch.reset()
    sfe = ServingFrontend(stier, host="127.0.0.1", port=0)
    saddr = sfe.start()
    src = int(torch.randint(0, n, (1,), generator=torch.Generator().manual_seed(args.seed)))
    vec = (corpus.vectors[src] + 0.01).cpu().numpy()
    lab = int(labels_host[src])

    def ask_each():
        """The same label query to each replica directly (its pump steps
        it): [(ids, dists, epoch)]."""
        out = []
        for i, rt in enumerate(stier.replicas):
            with stier.locks[i]:
                rid = rt.submit(vec, 8, "label", label_words_row([lab], 10))
            deadline = time.monotonic() + HTTP_TIMEOUT
            resp = None
            while resp is None and time.monotonic() < deadline:
                with stier.locks[i]:
                    resp = rt.poll(rid)
                time.sleep(0.002)
            check(resp is not None and resp.ok, f"http churn: replica {i} did not answer")
            out.append((resp.ids.tolist(), resp.dists.tobytes(), resp.epoch))
        return out

    t1 = time.perf_counter()
    status, up = http_json(saddr, "/v1/upsert", {"vector": vec.tolist(), "label": lab,
                                                 "attrs": [0.5, 0.5]})
    upsert_s = time.perf_counter() - t1
    check(status == 200 and up["ok"] and up["slot_consistent"], f"http upsert: {up}")
    check(len({r["epoch"] for r in up["replicas"]}) == 1, f"http upsert epochs: {up}")
    slot = up["slot"]
    after_up = ask_each()
    check(after_up[0] == after_up[1], "http churn: replicas answer differently after the upsert")
    t1 = time.perf_counter()
    status, dl = http_json(saddr, "/v1/delete", {"slot": slot})
    delete_s = time.perf_counter() - t1
    check(status == 200 and dl["ok"] and dl["slot_consistent"], f"http delete: {dl}")
    check(len(set(stier.epochs())) == 1, f"http churn: epochs {stier.epochs()}")
    after_del = ask_each()
    check(after_del[0] == after_del[1], "http churn: replicas answer differently after the delete")
    check(all(slot not in ids for ids, _, _ in after_del), "http churn: the dead slot was served")
    sreport = sfe.close(drain=True)
    torch.cuda.synchronize()
    counts = launch.read()
    check(sreport["in_flight"] == 0, "http churn close: requests in flight")
    for i, rt in enumerate(stier.replicas):
        c = rt.telemetry.counters
        check(c["submitted"] == c["completed"] + c["shed_total"] + c["upserts_applied"]
              + c["deletes_applied"], f"http churn close: replica {i} lost a request")
        rt.executor.index.pool.check_accounting()
    row = dict(shape="http_2rep_churn_1m", capacity=n + n // 2, setup_s=setup_s,
               upsert_wall_s=upsert_s, delete_wall_s=delete_s, slot=slot,
               epochs=stier.epochs(), upsert_found=slot in after_up[0][0],
               replicas_agree=True, dead_slot_served=False,
               launches={k: v for k, v in counts.items() if v})
    log(f"http {json.dumps(row)}")
    del stier, sfe

    # The launcher: --serve-http 0 --replicas 2 in a subprocess, driven by
    # requests and stopped by SIGTERM.
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    on_cpu = ["--device", "cpu"] if dev.type == "cpu" else []
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--n", str(LAUNCHER_N),
         "--serve-http", "0", "--replicas", "2", *on_cpu], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, cwd=root, env=env)
    lines: "queue.Queue[str]" = queue.Queue()
    reader = threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout], daemon=True)
    reader.start()
    try:
        seen, laddr = [], None
        deadline = time.monotonic() + 300
        while laddr is None and time.monotonic() < deadline and proc.poll() is None:
            try:
                line = lines.get(timeout=1.0)
            except queue.Empty:
                continue
            seen.append(line)
            if "serving on " in line:
                laddr = line.split("serving on ")[1].strip()
        check(laddr is not None, "launcher: no address within 300 s:\n" + "".join(seen))
        up_s = time.perf_counter() - t0
        for i in range(LAUNCHER_REQUESTS):
            status, body = http_json(laddr, "/v1/search", {
                "query": [0.1 * i] * 32, "k": 4, "family": "label", "labels": [i]})
            check(status == 200 and body["filled"] == 4 and body["replica"] in (0, 1),
                  f"launcher: {status} {body}")
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=120)
        reader.join(timeout=10)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    rest = []
    while not lines.empty():
        rest.append(lines.get())
    out = "".join(seen + rest)
    check(proc.returncode == 0, f"launcher: exit {proc.returncode}:\n{out[-3000:]}")
    shutdown = json.loads(out[out.index('{\n  "shutdown"'):])["shutdown"]
    check(shutdown["in_flight"] == 0 and shutdown["replicas"] == 2
          and sum(shutdown["completed_per_replica"]) == LAUNCHER_REQUESTS,
          f"launcher: shutdown report {shutdown}")
    log(f"http launcher {json.dumps(dict(wall_s=time.perf_counter() - t0, up_s=up_s, requests=LAUNCHER_REQUESTS, shutdown=shutdown))}")

    # The launcher's --distributed in this process: a 1x1 mesh on the card.
    launch.reset()
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main(["--n", str(LAUNCHER_N), "--requests", "64", "--distributed", *on_cpu])
    torch.cuda.synchronize()
    counts = launch.read()
    text = buf.getvalue()
    check("served 64/64 requests" in text and "mesh: {'data': 1, 'model': 1}" in text,
          f"launcher --distributed: {text[-2000:]}")
    check(counts["l2_matmul"] > 0 and counts["gather_distance"] > 0,
          "launcher --distributed: its build or walk ran without the kernels")
    log(f"distributed launcher {json.dumps(dict(wall_s=time.perf_counter() - t0, launches={k: v for k, v in counts.items() if v}, summary=text.strip().splitlines()[-1]))}")
    log(f"http: part wall {time.perf_counter() - t_part:.1f} s (host clock)")


def knn_graph_recall(graph, exact, chunk=65536) -> float:
    """Share of the exact graph's edges that ``graph`` holds, over all rows."""
    hits = 0
    for s in range(0, graph.shape[0], chunk):
        a, b = graph[s : s + chunk], exact[s : s + chunk]
        hits += int(((a[:, :, None] == b[:, None, :]) & (b >= 0)[:, None, :]).sum())
    return hits / int((exact >= 0).sum())


def profile_batch(name, run):
    """Device busy share of one batch and its costliest kernels, from a
    torch.profiler trace (prints "not measured" and returns None where the
    trace has no device events; else returns the traced batch's wall, its
    device busy seconds and its kernel count). The batch runs twice: the first, a warm-up step of the
    profiler's schedule, is traced and discarded, so no kernel of the
    recorded batch falls before the trace is running (a trace started
    right at the batch lost its first kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        run()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prof.step()
    by_name = {}
    for e in prof.events():
        # ProfilerStep* spans the step on the device timeline; it is no kernel.
        if e.device_type == DeviceType.CUDA and not e.name.startswith("ProfilerStep"):
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    busy_us = sum(us for _, us in by_name.values())
    if busy_us == 0:
        log(f"profile {name}: device time not measured (the trace holds no device events)")
        return None
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    log(f"profile {name}: wall {wall * 1e3:.1f} ms (profiler on), device busy "
        f"{busy_us / 1e3:.1f} ms = {busy_us / 1e6 / wall:.3f} of wall, "
        f"{sum(n for n, _ in by_name.values())} kernels")
    for kname, (n, us) in top:
        log(f"profile {name}:   {us / 1e3:8.2f} ms {n:6d}x {kname[:90]}")
    # The ported kernels inside the batch (they launch from their own
    # libraries, outside PyTorch's dispatcher).
    found = False
    for kernel in KERNEL_NAMES:
        hits = [(n, us) for kname, (n, us) in by_name.items() if f"{kernel}_kernel" in kname]
        if hits:
            found = True
            log(f"profile {name}:   {kernel}: {sum(us for _, us in hits) / 1e3:.3f} ms in "
                f"{sum(n for n, _ in hits)} launches")
    if not found:
        log(f"profile {name}:   no ported kernel in the trace")
    return dict(wall_s=wall, busy_s=busy_us / 1e6, kernels=sum(n for n, _ in by_name.values()))


def two_tower_phase(args, dev, launch: LaunchCounts):
    """two-tower-retrieval on the card: the three serve shapes, then AIRSHIP
    constrained retrieval over the item tower's embeddings of items
    0..n-1 (examples/constrained_serving.py at full size)."""
    from repro_torch import (
        Corpus,
        SearchParams,
        build_index,
        constrained_search,
        equal_constraint,
        exact_constrained_search,
        recall,
    )
    from repro_torch.archs.recsys import RECSYS_SHAPES, serve_fn, shape_batch
    from repro_torch.data import two_tower_batch
    from repro_torch.distributed import MeshInfo
    from repro_torch.graph.build import span_seconds
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.recsys import two_tower_init
    from repro_torch.models.recsys.models import VOCAB_PAD
    from repro_torch.roofline.model import recsys_terms, two_tower_serve_terms

    bags_before = launch.total["embedding_bag"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = tt_config()
    n = args.n
    def table_gb(vocab):
        return cfg.padded_vocab(vocab, VOCAB_PAD) * cfg.embed_dim * 4 / 1e9

    log(f"two-tower-retrieval: embed_dim {cfg.embed_dim}, towers {cfg.tower_mlp}, hist_len "
        f"{cfg.hist_len}, float32; item_vocab {cfg.item_vocab} (as published); cut: user_vocab "
        f"50000000 -> {cfg.user_vocab} (tables {2 * table_gb(50_000_000):.1f} GB as published; "
        f"here item {table_gb(cfg.item_vocab):.1f} GB + user {table_gb(cfg.user_vocab):.1f} GB); "
        f"card memory {torch.cuda.get_device_properties(0).total_memory / 1e9:.1f} GB")
    gen = torch.Generator(device=dev).manual_seed(args.seed + 31)
    t0 = time.perf_counter()
    model = two_tower_init(gen, cfg, device=dev).requires_grad_(False)  # serving only
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    # The item corpus: the item tower over items 0..n-1 (set-up of
    # retrieval_cand and of the walk), in chunks of serve_bulk's size.
    corpus_vec = torch.cat([model.item(torch.arange(s, min(s + TT_BULK, n), dtype=torch.int32,
                                                    device=dev))
                            for s in range(0, n, TT_BULK)])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    log(f"two-tower: init {t1 - t0:.2f} s, item tower over {n} items {t2 - t1:.3f} s (set-up)")

    shapes = dict(RECSYS_SHAPES, retrieval_cand=dict(kind="serve", batch=1, n_candidates=n))
    outs = {}
    for shape in ("serve_p99", "serve_bulk", "retrieval_cand"):
        batch = shape_batch(cfg, shape, args.seed, 1, shapes=shapes,
                            candidates=corpus_vec if shape == "retrieval_cand" else None,
                            device=dev)
        fn = serve_fn(cfg, shape, shapes)
        fn(model, batch)  # warm-up batch
        launch.reset()
        t0 = time.perf_counter()
        out = fn(model, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch.read()
        b = shapes[shape]["batch"]
        row = dict(shape=f"{shape}_tt", batch=b, wall_s=wall, users_per_s=b / wall,
                   launches={k: v for k, v in launches.items() if v})
        outs[shape] = (batch, fn, out)
        log(f"serve {json.dumps(row)}")
        if shape == "serve_bulk":
            # The bound is the call's own work, its valid history rows
            # counted; the reference's terms ride along, not as a bound.
            ref_flops, ref_hbm, ref_coll, _ = recsys_terms(cfg, b, 1, "serve")
            hist_rows = int((batch["hist"] >= 0).sum())
            roofline_line("serve_bulk_tt", two_tower_serve_terms(cfg, b, hist_rows), wall,
                          kind="serve", batch=b, hist_rows=hist_rows,
                          reference_terms=dict(flops=ref_flops, hbm_bytes=ref_hbm,
                                               coll_bytes=ref_coll))
        check(launches["embedding_bag"] == 1, f"{shape}: embedding_bag launched "
                                              f"{launches['embedding_bag']} times, expected 1")
        if shape == "retrieval_cand":
            vals, ids = out
            check(vals.shape == (1, 100) and ids.shape == (1, 100) and ids.dtype == torch.int32,
                  "retrieval_cand: bad top-k shape")
            check(bool((ids >= 0).all() & (ids < n).all()), "retrieval_cand: ids out of range")
            check(bool((vals[:, :-1] >= vals[:, 1:]).all()), "retrieval_cand: not descending")
            u = model.user(batch)
            want = torch.topk(u @ corpus_vec.T, 100).values
            check(float((want - vals).abs().max()) <= 1e-5,
                  "retrieval_cand: the top-100 scores are not the largest")
            check(bool(((u @ corpus_vec[ids[0].long()].T)[0] - vals[0]).abs().max() <= 1e-5),
                  "retrieval_cand: ids do not carry their scores")
        else:
            check(out.shape == (b,) and bool(torch.isfinite(out).all())
                  and float(out.abs().max()) <= 1 + 1e-5,
                  f"{shape}: scores not finite cosines of shape ({b},)")
    # retrieval_cand's two-phase top-k over a (1, 4) mesh of the card: each
    # candidate shard takes its own top-100, one more top-100 merges them.
    mi = MeshInfo(mesh=make_test_mesh(4, model=4, device=dev))
    batch, _, (vals, ids) = outs["retrieval_cand"]
    fn = serve_fn(cfg, "retrieval_cand", shapes, mesh=mi)
    fn(model, batch)  # warm-up batch
    launch.reset()
    t0 = time.perf_counter()
    vals4, ids4 = fn(model, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch.read()
    check(launches["embedding_bag"] == 1, "retrieval_cand_tt_p4: embedding_bag not launched once")
    check(vals4.shape == (1, 100) and ids4.dtype == torch.int32,
          "retrieval_cand_tt_p4: bad top-k shape")
    check(float((vals4 - vals).abs().max()) <= 1e-5,
          "retrieval_cand_tt_p4: scores differ from the single-device top-100")
    gaps = (vals[:, 1:] - vals[:, :-1]).abs()
    clear = torch.ones_like(vals, dtype=torch.bool)
    clear[:, 1:] &= gaps > 1e-4
    clear[:, :-1] &= gaps > 1e-4
    check(bool((ids4[clear] == ids[clear]).all()),
          "retrieval_cand_tt_p4: ids differ from the single-device top-100 beyond ties")
    row = dict(shape="retrieval_cand_tt_p4", batch=1, wall_s=wall, users_per_s=1 / wall,
               mesh=mi.mesh.shape, ids_equal=bool(torch.equal(ids4, ids)),
               ids_compared=int(clear.sum()), launches={k: v for k, v in launches.items() if v})
    log(f"serve {json.dumps(row)}")
    profile_batch("serve_bulk_tt", lambda: outs["serve_bulk"][1](model, outs["serve_bulk"][0]))
    del outs

    # AIRSHIP over the item tower: 10 random categories, the exact index
    # (airship-sift1m's degree and sample), 256 users of two_tower_batch as
    # queries, one wanted category each.
    cats = torch.randint(0, 10, (n,), generator=gen, dtype=torch.int32, device=dev)
    corpus = Corpus(vectors=corpus_vec, labels=cats)
    launch.reset()
    spans = {}
    t0 = time.perf_counter()
    index = build_index(gen, corpus, degree=32, sample_size=128, method="exact", device=dev,
                        spans=spans)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    build_launches = launch.read()
    sec = span_seconds(spans)
    blocks = math.ceil(n / BUILD_BLOCK)
    log(f"build airship_tt: exact index over {n} item-tower rows (d = {cfg.tower_mlp[-1]}), "
        f"degree 32, sample 128: {t1 - t0:.3f} s (host clock) = products {sec['products']:.3f} s "
        f"({blocks} l2_matmul launches of ({BUILD_BLOCK}, {n}, {cfg.tower_mlp[-1]})) + masks and "
        f"top-k {sec['topk']:.3f} s + reverse edges {sec['reverse_edges']:.3f} s + the rest "
        f"{t1 - t0 - sec['products'] - sec['topk'] - sec['reverse_edges']:.3f} s; launches "
        f"{json.dumps(build_launches)}")
    check(build_launches["l2_matmul"] == blocks + 1,
          f"airship_tt build: {build_launches['l2_matmul']} l2_matmul launches, expected "
          f"{blocks} + 1 medoid")
    check(int((index.neighbors >= 0).sum(-1).min()) > 0, "airship_tt: an empty adjacency row")

    launch.reset()
    qb = two_tower_batch(args.seed, 2, TT_QUERIES, cfg.user_vocab, cfg.item_vocab, cfg.hist_len,
                         device=dev)
    queries = model.user(qb)
    query_launches = launch.read()
    check(query_launches["embedding_bag"] == 1, "airship_tt: the user tower did not launch "
                                                "embedding_bag once")
    want = torch.randint(0, 10, (TT_QUERIES,), generator=gen, dtype=torch.int32, device=dev)
    cons = equal_constraint(want, 10)
    _, true_ids = exact_constrained_search(corpus, queries, cons, 10)

    def walk(iters):
        params = SearchParams(mode="prefer", k=10, ef_result=TT_EF_RESULT, n_start=32,
                              max_iters=iters, use_kernel=True)
        return constrained_search(corpus, index, queries, cons, params)

    walk(4)  # warm-up: the same shapes, a few iterations
    launch.reset()
    t0 = time.perf_counter()
    res = walk(TT_MAX_ITERS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    walk_launches = launch.read()
    rec = float(recall(res.ids, true_ids))
    hit = res.ids >= 0
    in_cat = bool((cats[res.ids.clamp_min(0).long()] == want[:, None])[hit].all())
    row = dict(shape="airship_tt_256", wall_s=wall, qps=TT_QUERIES / wall, recall_at_10=rec,
               iters=int(res.stats.iters),
               dist_evals_mean=float(res.stats.dist_evals.float().mean()),
               hops_mean=float(res.stats.hops.float().mean()),
               filled_mean=float(hit.float().sum(-1).mean()), all_in_category=in_cat,
               ef_result=TT_EF_RESULT, max_iters=TT_MAX_ITERS,
               launches={k: v for k, v in walk_launches.items() if v})
    log(f"search {json.dumps(row)}")
    check(res.ids.shape == (TT_QUERIES, 10) and bool(torch.isfinite(res.dists[hit]).all()),
          "airship_tt_256: bad result shape or non-finite distances")
    check(in_cat, "airship_tt_256: a returned item is outside its wanted category")
    check(walk_launches["gather_distance"] > 0, "airship_tt_256: gather_distance never launched")
    check(rec >= 0.5, f"airship_tt_256: recall@10 {rec} < 0.5")
    peak = torch.cuda.max_memory_allocated()
    log(f"two-tower: peak device memory {peak / 1e9:.2f} GB (max_memory_allocated) of "
        f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.1f} GB")
    bags = launch.total["embedding_bag"] - bags_before
    check(bags == 5, f"two-tower: embedding_bag launched {bags} times, expected 5 (3 serve "
                     f"shapes + retrieval_cand on the (1, 4) mesh + the walk's queries)")


# --------------------------------------------------------------------------- training

# Phase 8's cuts (widths are never cut): a DLRM table, and the two-tower
# user and item vocabularies, capped at TRAIN_VOCAB_CAP rows (MLPerf's
# max-ind-range hash trick), so that the tables, their dense gradients and
# AdamW's two moments fit the card: DLRM 187,771,136 padded rows (96.1 GB of
# tables alone) -> 24,067,072 (12.3 GB; 49.3 GB with grads, m and v);
# two-tower 2 x 50M rows (~410 GB with grads, m and v) -> 2 x 4M (32.8 GB).
# DeepFM trains at its published config, nothing cut.
TRAIN_VOCAB_CAP = 4_000_000
TRAIN_STEPS = (("deepfm", 5), ("dlrm-mlperf", 3), ("two-tower-retrieval", 3))
BWD_B, BWD_L, BWD_D, BWD_V = 65_536, 50, 256, TRAIN_VOCAB_CAP  # the two-tower train batch's bag


def train_arch(name):
    """``get_arch(name)`` with phase 8's vocabulary cuts."""
    import dataclasses

    from repro_torch.archs import get_arch
    from repro_torch.archs.recsys import RecsysArch

    arch = get_arch(name)
    cfg = arch.cfg
    if cfg.model == "dlrm":
        cfg = dataclasses.replace(cfg, vocab_sizes=tuple(min(v, TRAIN_VOCAB_CAP)
                                                         for v in cfg.vocab_sizes))
    elif cfg.model == "two_tower":
        cfg = dataclasses.replace(cfg, user_vocab=TRAIN_VOCAB_CAP, item_vocab=TRAIN_VOCAB_CAP)
    return RecsysArch(cfg, arch.shapes)


def bag_backward_inputs(gen, v, d, b, length, integer, dev, pad=0.3):
    """ids with ``pad`` padding, an all-padding bag 0, bag 1 holding row 0
    twice, row V - 1 and ids past V (clamped to V - 1); g (B, D)."""
    ids = torch.randint(0, v, (b, length), generator=gen, dtype=torch.int32, device=dev)
    ids[torch.rand((b, length), generator=gen, device=dev) < pad] = -1
    ids[0] = -1
    ids[1, :5] = torch.tensor([0, 0, v - 1, v, v + 7], dtype=torch.int32)
    if integer:
        g = torch.randint(-8, 9, (b, d), generator=gen, device=dev).float()
    else:
        g = torch.randn((b, d), generator=gen, device=dev)
    return ids, g


def bag_backward_phase(args, dev):
    """The embedding bag's backward kernel against its plain version, bit
    for bit, on integer and float gradients in both modes (repeated ids,
    all-padding bags, ids >= V, D = 256 / 10 / 128 / 13, the float4 and the
    scalar paths); then its device time at the two-tower train batch's bag
    against its bound, the plain version and one index_add_."""
    from repro_torch.data import two_tower_batch
    from repro_torch.kernels.embedding_bag import (
        embedding_bag_backward_cuda,
        embedding_bag_backward_plain,
    )

    gen = torch.Generator(device=dev).manual_seed(args.seed + 41)
    max_err, n_checks = 0.0, 0
    # (V, D, B, L): the train shape; heavy repeats (V far below B * L); the
    # scalar path at D = 10 and 13; D = 128 (DLRM's width) with long runs.
    cases = ((BWD_V, BWD_D, 4096, BWD_L), (1000, 10, 512, BWD_L), (50, 128, 300, 20),
             (5000, 13, 77, 33), (3, 256, 64, 40))
    for integer in (True, False):
        for v, d, b, length in cases:
            ids, g = bag_backward_inputs(gen, v, d, b, length, integer, dev)
            for mode in ("sum", "mean"):
                got = embedding_bag_backward_cuda(ids, g, v, mode)
                torch.cuda.synchronize()
                want = embedding_bag_backward_plain(ids, g, v, mode)
                err = float((got - want).abs().max())
                check(torch.equal(got, want), f"embedding_bag_backward {mode} "
                      f"{'int' if integer else 'float'} V={v} D={d} B={b} L={length}: differs "
                      f"from its plain version (max abs {err})")
                max_err = max(max_err, err)
                n_checks += 1
    shapes = ", ".join(f"V={v} D={d} B={b} L={n}" for v, d, b, n in cases)
    log(f"kernels: {n_checks} embedding_bag_backward kernel/plain comparisons passed, all exact "
        f"(integer and float g; sum and mean; {shapes}; all-padding bags, repeated ids, ids >= "
        f"V); max abs err {max_err:.3e}")

    # Device time at the two-tower train batch's bag: its ids (30% padding)
    # over the cut 4M-row item table, a float upstream gradient.
    ids = two_tower_batch(args.seed, 0, BWD_B, BWD_V, BWD_V, BWD_L, device=dev)["hist"]
    g = torch.randn((BWD_B, BWD_D), generator=gen, device=dev)
    got = embedding_bag_backward_cuda(ids, g, BWD_V)
    want = embedding_bag_backward_plain(ids, g, BWD_V)
    err = float((got - want).abs().max())
    check(torch.equal(got, want), f"embedding_bag_backward at the train shape: differs from its "
                                  f"plain version (max abs {err})")
    del got, want
    valid = int((ids >= 0).sum())
    n_bytes = BWD_V * BWD_D * 4 + BWD_B * BWD_D * 4 + ids.numel() * 4
    bd = bound_ms(n_bytes, float(valid) * BWD_D)
    # The library yardstick: index_add_ of the masked (B * L, D) rows (made
    # once, outside the timing: 3.4 GB) into a zeroed (V, D).
    flat = ids.reshape(-1)
    rows = g.repeat_interleave(BWD_L, 0).mul_((flat >= 0)[:, None])
    index = flat.clamp(0, BWD_V - 1).long()

    def lib(index, rows):
        return torch.zeros((BWD_V, BWD_D), device=dev).index_add_(0, index, rows)

    lib_err = float((lib(index, rows) - embedding_bag_backward_cuda(ids, g, BWD_V)).abs().max())
    check(lib_err <= 1e-4, f"index_add_ disagrees with embedding_bag_backward by {lib_err}")
    t = dict(ms=events_ms(embedding_bag_backward_cuda, (ids, g, BWD_V), reps=10),
             plain_ms=events_ms(embedding_bag_backward_plain, (ids, g, BWD_V), reps=2),
             library_ms=events_ms(lib, (index, rows), reps=5),
             bound_ms=bd[0], bound_by=bd[1], bytes=n_bytes)
    t["ms_again"] = events_ms(embedding_bag_backward_cuda, (ids, g, BWD_V), reps=10)
    del rows, index
    torch.cuda.empty_cache()
    log(f"time embedding_bag_backward train B={BWD_B} L={BWD_L} D={BWD_D} V={BWD_V} "
        f"({valid} valid ids): kernel {t['ms']:.4f} ms (again {t['ms_again']:.4f} ms; stable "
        f"sort of the keys, zeroed (V, D) output and the kernel), plain {t['plain_ms']:.4f} ms, "
        f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}, {n_bytes / 1e9:.4f} GB: the dense "
        f"output written once + g + ids), {n_bytes / t['ms'] / 1e6:.1f} GB/s; library "
        f"torch.zeros((V, D)).index_add_(0, ids, masked rows) {t['library_ms']:.4f} ms (max abs "
        f"diff {lib_err:.3e})")
    return max_err, t


def train_phase(args, dev, launch: LaunchCounts) -> None:
    """Phase 8: AdamW training through ``get_arch(name).make_cell("train_batch")``
    and ``shape_batch`` on the card: DeepFM (published config, 5 steps), DLRM
    (MLPerf widths, tables capped, 3 steps), two-tower (published widths,
    vocabularies capped, 3 steps; the forward bag and its backward kernel
    once a step). One `train {...}` line each; fails on a loss that is not
    finite, a parameter leaf that did not change, or a bag launch count."""
    from repro_torch.archs.recsys import shape_batch
    from repro_torch.train import reference_layout

    t_phase = time.perf_counter()
    for name, steps in TRAIN_STEPS:
        arch = train_arch(name)
        cfg = arch.cfg
        b = arch.shapes["train_batch"]["batch"]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cell = arch.make_cell("train_batch")
        t0 = time.perf_counter()
        model, opt_state, batch = cell.make_inputs(args.seed, dev)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        views = reference_layout(model)
        n_params = sum(p.numel() for p in views.values())
        sums = {k: float(p.detach().sum(dtype=torch.float64)) for k, p in views.items()}
        walls, losses = [], []
        launch.reset()
        for step in range(steps):
            if step:
                batch = shape_batch(cfg, "train_batch", args.seed, step, shapes=arch.shapes,
                                    device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model, opt_state, metrics = cell.fn(model, opt_state, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            losses.append(float(metrics["loss"]))
        launches = launch.read()
        peak = torch.cuda.max_memory_allocated()
        unchanged = [k for k, p in views.items()
                     if float(p.detach().sum(dtype=torch.float64)) == sums[k]]
        warm = sum(walls[1:]) / len(walls[1:])  # the steps after the first
        row = dict(cell=f"train_{cfg.name.replace('-', '_')}", model=cfg.model, batch=b,
                   steps=steps, init_s=t_init, first_step_s=walls[0], step_s_warm=warm,
                   step_s=walls, examples_per_s=b / warm, loss=losses,
                   peak_gb=peak / 1e9, params=n_params, leaves=len(views),
                   launches={k: v for k, v in launches.items() if v})
        if cfg.model == "dlrm":
            row["tables_rows"] = sum(cfg.padded_vocab(v, 256) for v in cfg.vocab_sizes)
        log(f"train {json.dumps(row)}")
        check(all(math.isfinite(x) for x in losses), f"train {name}: a loss is not finite")
        check(not unchanged, f"train {name}: parameters did not change: {unchanged[:5]}")
        bags = 0 if cfg.model != "two_tower" else steps
        check(launches["embedding_bag"] == bags and launches["embedding_bag_backward"] == bags,
              f"train {name}: bag kernels launched {launches['embedding_bag']} / "
              f"{launches['embedding_bag_backward']} times, expected {bags} each")
        if cfg.model == "two_tower":
            profile_batch("train_two_tower",
                          lambda: cell.fn(model, opt_state, shape_batch(
                              cfg, "train_batch", args.seed, steps, shapes=arch.shapes,
                              device=dev)))
        del model, opt_state, batch, views, metrics
        log_memory(f"after train {name}")
    log(f"training: phase wall {time.perf_counter() - t_phase:.1f} s (host clock)")


# --------------------------------------------------------------------------- phase 9
# 9a: flash_attention against F.scaled_dot_product_attention at granite's
# prefill heads (S cut to 4,096: SDPA's float32 math path holds the whole
# (B, H, S, S) score matrix) and at SASRec's train batch.
ATTN_SHAPES = {
    "granite_4k": dict(b=1, s=4096, h=32, hkv=8, dh=64, chunk=512),
    "sasrec_train": dict(b=65_536, s=50, h=1, hkv=1, dh=50, chunk=50),
}
ATTN_OUT_TOL = 1e-4  # absolute, on outputs of |v|-weighted means (values O(1))
ATTN_GRAD_RTOL = 1e-4  # of each gradient's largest element
SASREC_STEPS = 3
SASREC_SERVE = ("serve_p99", "serve_bulk", "retrieval_cand")
# 9c: granite-3-2b's serve cells. prefill_32k at batch 1 (at 32 one f32
# score chunk is 68.7 GB), decode_32k at batch 16 (the cache 42.9 GB, 343.6
# GB at 128), long_500k as published; 8 decode steps from random bf16
# caches at the last 8 positions.
LM_NAME = "granite-3-2b"
LM_BATCH = {"prefill_32k": 1, "decode_32k": 16, "long_500k": 1}
LM_DECODE_STEPS = 8
LM_TF_TOKENS = 32  # teacher-forcing check: (2, 32) tokens at 2 layers of full width
LM_TF_TOL = {"float32": 2e-3, "bfloat16": 0.1}  # abs on logits; 2e-3 is tests/test_models.py's


def sdpa(q, k, v):
    """The yardstick: one F.scaled_dot_product_attention call, causal, GQA,
    on (B, S, H, dh) tensors."""
    import torch.nn.functional as F

    out = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                         is_causal=True, enable_gqa=True)
    return out.transpose(1, 2)


def attention_phase(args, dev) -> None:
    """9a: flash_attention forward and backward against SDPA in float32 at
    the two shapes, and card == CPU on a small case; one `attn {...}` line
    a shape."""
    from repro_torch.models.common.flash import AttnMeta, flash_attention

    gen = torch.Generator(device=dev).manual_seed(args.seed + 91)
    # card == CPU (2, 64, 4 heads over 2, dh 16, chunk 24: a padded tail)
    small = [torch.randn(shape, generator=gen, device=dev)
             for shape in ((2, 64, 4, 16), (2, 64, 2, 16), (2, 64, 2, 16), (2, 64, 4, 16))]
    meta = AttnMeta(causal=True, q_offset=0, chunk=24, soft_cap=0.0)
    errs = []
    for d in (dev, torch.device("cpu")):
        q, k, v, w = (t.to(d).requires_grad_(i < 3) for i, t in enumerate(small))
        out = flash_attention(q, k, v, meta)
        errs.append([out.detach().cpu()] + [g.cpu() for g in
                                            torch.autograd.grad(out, (q, k, v), w)])
    small_err = max(float((a - b).abs().max()) for a, b in zip(*errs))
    check(small_err <= 2e-5, f"attn: flash_attention on the card differs from the CPU by "
                             f"{small_err}")
    log(f"attn: card == CPU on (2, 64, 4 / 2, 16), chunk 24, forward and gradients: max abs "
        f"diff {small_err:.3e} (tolerance 2e-5)")
    for name, sh in ATTN_SHAPES.items():
        b, n, h, hkv, dh = sh["b"], sh["s"], sh["h"], sh["hkv"], sh["dh"]
        q = torch.randn((b, n, h, dh), generator=gen, device=dev).requires_grad_()
        k = torch.randn((b, n, hkv, dh), generator=gen, device=dev).requires_grad_()
        v = torch.randn((b, n, hkv, dh), generator=gen, device=dev).requires_grad_()
        dout = torch.randn((b, n, h, dh), generator=gen, device=dev)
        meta = AttnMeta(causal=True, q_offset=0, chunk=sh["chunk"], soft_cap=0.0)

        def flash(q, k, v):
            return flash_attention(q, k, v, meta)

        def fwd_bwd(fn):
            def run(q, k, v, dout):
                out = fn(q, k, v)
                return torch.autograd.grad(out, (q, k, v), dout)
            return run

        got, want = flash(q, k, v), sdpa(q, k, v)
        out_err = float((got - want).detach().abs().max())
        g_got = torch.autograd.grad(got, (q, k, v), dout)
        g_want = torch.autograd.grad(want, (q, k, v), dout)
        grad_err = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                       for a, b in zip(g_got, g_want))
        del got, want, g_got, g_want
        check(out_err <= ATTN_OUT_TOL, f"attn {name}: flash_attention differs from SDPA by "
                                       f"{out_err} (tolerance {ATTN_OUT_TOL})")
        check(grad_err <= ATTN_GRAD_RTOL, f"attn {name}: gradients differ from SDPA's by "
                                          f"{grad_err} of their largest (tolerance "
                                          f"{ATTN_GRAD_RTOL})")
        with torch.no_grad():
            fwd_ms = events_ms(flash, (q, k, v), reps=3)
            sdpa_fwd_ms = events_ms(sdpa, (q, k, v), reps=3)
        bwd_ms = events_ms(fwd_bwd(flash), (q, k, v, dout), reps=3)
        sdpa_bwd_ms = events_ms(fwd_bwd(sdpa), (q, k, v, dout), reps=3)
        # the flash loop computes the whole rectangle, 4 b h s^2 dh operations
        # forward; the causal function needs the lower triangle's, and q, k,
        # v read and the output written once
        flops = 4.0 * b * h * n * n * dh
        fwd_bound = bound_ms(4.0 * b * n * dh * (2 * h + 2 * hkv), 2.0 * b * h * n * (n + 1) * dh)
        row = dict(shape=name, b=b, s=n, h=h, hkv=hkv, dh=dh, chunk=sh["chunk"],
                   max_abs_err=out_err, grad_rel_err=grad_err, flash_fwd_ms=fwd_ms,
                   sdpa_fwd_ms=sdpa_fwd_ms, flash_fwd_bwd_ms=bwd_ms,
                   sdpa_fwd_bwd_ms=sdpa_bwd_ms, fwd_ratio=fwd_ms / sdpa_fwd_ms,
                   fwd_bound_ms=fwd_bound[0], fwd_bound_by=fwd_bound[1],
                   fwd_tflops_rectangle=flops / fwd_ms / 1e9)
        log(f"attn {json.dumps(row)}")
        del q, k, v, dout
        torch.cuda.empty_cache()


def sasrec_phase(args, dev) -> None:
    """9b: SASRec at its published config (arXiv 1808.09781; nothing cut):
    3 AdamW steps of train_batch (B = 65,536), then serve_p99, serve_bulk
    and retrieval_cand; one `sasrec {...}` line each."""
    from repro_torch.archs import get_arch
    from repro_torch.archs.recsys import shape_batch
    from repro_torch.train import reference_layout

    arch = get_arch("sasrec")
    cfg = arch.cfg
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cell = arch.make_cell("train_batch")
    t0 = time.perf_counter()
    model, opt_state, batch = cell.make_inputs(args.seed, dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    views = reference_layout(model)
    sums = {k: float(p.detach().sum(dtype=torch.float64)) for k, p in views.items()}
    b = arch.shapes["train_batch"]["batch"]
    walls, losses = [], []
    for step in range(SASREC_STEPS):
        if step:
            batch = shape_batch(cfg, "train_batch", args.seed, step, shapes=arch.shapes,
                                device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, opt_state, metrics = cell.fn(model, opt_state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
    unchanged = [k for k, p in views.items()
                 if float(p.detach().sum(dtype=torch.float64)) == sums[k]]
    warm = sum(walls[1:]) / len(walls[1:])
    log("sasrec " + json.dumps(dict(
        cell="train_batch", batch=b, steps=SASREC_STEPS, init_s=t_init, first_step_s=walls[0],
        step_s_warm=warm, step_s=walls, examples_per_s=b / warm, loss=losses,
        peak_gb=torch.cuda.max_memory_allocated() / 1e9, leaves=len(views))))
    check(all(math.isfinite(x) for x in losses), "sasrec train_batch: a loss is not finite")
    check(not unchanged, f"sasrec train_batch: parameters did not change: {unchanged}")
    del opt_state, batch, metrics, views
    for shape in SASREC_SERVE:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fn = arch.make_cell(shape).fn
        batch = shape_batch(cfg, shape, args.seed, 0, shapes=arch.shapes, device=dev)
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            scores = fn(model, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        users = batch["seq"].shape[0]
        check(tuple(scores.shape) == tuple(batch["candidates"].shape)
              and bool(torch.isfinite(scores).all()), f"sasrec {shape}: scores of shape "
                                                      f"{tuple(scores.shape)}, or not finite")
        warm = min(walls[1:])
        log("sasrec " + json.dumps(dict(
            cell=shape, users=users, candidates=batch["candidates"].shape[1],
            first_wall_s=walls[0], wall_s=warm, users_per_s=users / warm,
            scored_per_s=scores.numel() / warm,
            peak_gb=torch.cuda.max_memory_allocated() / 1e9)))
        del batch, scores
    del model
    log_memory("after phase 9b")


def lm_arch(shape: str):
    """granite-3-2b's LMArch with phase 9c's batch of ``shape``."""
    from repro_torch.archs import get_arch
    from repro_torch.archs.lm import LMArch

    arch = get_arch(LM_NAME)
    shapes = {k: dict(v, global_batch=LM_BATCH.get(k, v["global_batch"]))
              for k, v in arch.shapes.items()}
    return LMArch(arch.cfg, arch.optimizer_name, shapes, arch.grad_accum)


def lm_teacher_forcing(args, dev) -> None:
    """Decode equals teacher forcing on the card at 2 layers of granite's full
    width, in float32 and in bf16: (2, LM_TF_TOKENS) tokens decoded one at
    a time from a zero cache against forward_hidden @ lm_head at every
    position."""
    import dataclasses

    from repro_torch.models.transformer import decode_step, forward_hidden, init_cache, init_params

    base = dataclasses.replace(lm_arch("prefill_32k").cfg, n_layers=2)
    toks = torch.randint(0, base.vocab_size, (2, LM_TF_TOKENS), dtype=torch.int32, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(args.seed + 7))
    for dt in (torch.float32, torch.bfloat16):
        cfg = dataclasses.replace(base, param_dtype=dt, compute_dtype=dt)
        model = init_params(torch.Generator(device=dev).manual_seed(args.seed), cfg, device=dev)
        with torch.inference_mode():
            ref = model.lm_head(forward_hidden(model, toks)).float()
            cache = init_cache(cfg, 2, LM_TF_TOKENS, device=dev)
            outs = []
            for t in range(LM_TF_TOKENS):
                lg, cache = decode_step(model, cache, toks[:, t])
                outs.append(lg)
            err = float((torch.stack(outs, 1) - ref).abs().max())
        tol = LM_TF_TOL[str(dt).split(".")[1]]
        log(f"lm: decode == teacher forcing at 2 layers of {LM_NAME}'s width, {dt}: max abs "
            f"diff {err:.3e} on logits up to {float(ref.abs().max()):.3f} (tolerance {tol})")
        check(err <= tol, f"lm: decode differs from teacher forcing by {err} ({dt})")
        del model, cache, ref, outs


def lm_phase(args, dev) -> None:
    """9c: granite-3-2b at full width and depth, bf16 weights from --seed:
    prefill_32k (batch 1), decode_32k (batch 16) and long_500k (batch 1),
    8 decode steps each from a random bf16 cache at its last 8 positions;
    one `lm {...}` line a cell and `profile decode_32k`."""
    from repro_torch.data import lm_batch
    from repro_torch.models.transformer import init_params
    from repro_torch.roofline.model import lm_serve_bound

    lm_teacher_forcing(args, dev)
    cfg = lm_arch("prefill_32k").cfg
    t0 = time.perf_counter()
    model = init_params(torch.Generator(device=dev).manual_seed(args.seed), cfg, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"lm: {LM_NAME} {n_params} parameters ({cfg.param_dtype}, "
        f"{sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9:.3f} GB) drawn in "
        f"{time.perf_counter() - t0:.2f} s; param_count() {cfg.param_count()}")
    check(n_params == cfg.param_count(), "lm: the model's parameters differ from param_count()")

    for shape in ("prefill_32k", "decode_32k", "long_500k"):
        arch = lm_arch(shape)
        sh = arch.shapes[shape]
        b, n = sh["global_batch"], sh["seq_len"]
        fn = arch.make_cell(shape).fn
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        if shape == "prefill_32k":
            bound = lm_serve_bound(cfg, "prefill", b, n)
            tokens = lm_batch(args.seed, 0, b, n, cfg.vocab_size, device=dev)["tokens"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = fn(model, tokens)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            check(tuple(logits.shape) == (b, cfg.vocab_padded)
                  and logits.dtype == torch.float32 and bool(torch.isfinite(logits).all()),
                  f"lm {shape}: logits of shape {tuple(logits.shape)} {logits.dtype}, or not "
                  f"finite")
            row = dict(cell=shape, batch=b, seq=n, layers=cfg.n_layers, wall_s=wall,
                       tokens_per_s=b * n / wall)
            del tokens, logits
        else:
            bound = lm_serve_bound(cfg, "decode", b, n)
            cache = lm_cache(cfg, b, n, args.seed, dev)
            ptrs = (cache["k"].data_ptr(), cache["v"].data_ptr())
            tokens = lm_batch(args.seed, 1, b, LM_DECODE_STEPS, cfg.vocab_size,
                              device=dev)["tokens"]
            cache, walls, logits = timed_decode(
                model, cache, tokens, fn,
                lambda: (cache["k"].data_ptr(), cache["v"].data_ptr()) == ptrs, shape)
            check(int(cache["pos"]) == n, f"lm {shape}: pos {int(cache['pos'])} after the steps")
            warm = sorted(walls[1:])[len(walls[1:]) // 2]
            row = dict(cell=shape, batch=b, cache_len=n, cache_gb=2 * cache["k"].numel() * 2 / 1e9,
                       steps=LM_DECODE_STEPS, first_step_s=walls[0], step_s_median=warm,
                       step_s=walls, tokens_per_s=b / warm)
            cache["pos"] = torch.tensor(n - 1, dtype=torch.int32, device=dev)
            prof = profile_batch(shape, lambda: fn(model, cache, tokens[:, 0]))
            row["launches_per_step"] = prof["kernels"] if prof else "not measured"
            del cache, logits, tokens
        row.update(peak_gb=torch.cuda.max_memory_allocated() / 1e9, bound_s=bound["bound_s"],
                   bound_by=bound["bound_by"], bound_share=bound["bound_s"] / (
                       row.get("wall_s") or row["step_s_median"]),
                   flops_attn=bound["flops_attn"], flops_proj=bound["flops_proj"],
                   hbm_bytes=bound["hbm_bytes"])
        log(f"lm {json.dumps(row)}")
        log_memory(f"after lm {shape}")
    del model


def lm_cache(cfg, b: int, n: int, seed: int, dev) -> dict:
    """A decode cache (GQA's (L, b, n, Hkv, dh) bf16 k and v, or MLA's (L,
    b, n, r + dr) latent c) filled with normal draws from ``seed``, at
    position n - LM_DECODE_STEPS."""
    from repro_torch.models.transformer import init_cache

    cache = init_cache(cfg, b, n, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    for key in ("c",) if cfg.attn_type == "mla" else ("k", "v"):
        for layer in cache[key]:
            layer.normal_(generator=gen)
    cache["pos"].fill_(n - LM_DECODE_STEPS)
    return cache


# 9d: deepseek-v2-236b (MLA + MoE) at full width. Depth cut from 1 dense + 59
# MoE layers to 1 + 4 (17.28e9 parameters, 34.55 GB of bf16 weights);
# prefill_32k at batch 1 (at 32 the MoE dispatch alone holds 80.5 GB),
# decode_32k at batch 128 as published (24.2 GB of latent cache), long_500k
# as published (3.0 GB), then again on a (1, 4) mesh of the card (four
# sequence shards, the MoE expert-parallel over 4), the logits of each step
# whose tokens route as the one-device run's held to that run's within
# DS_MESH_TOL: only the order of the shards' sums differs (the LSE combine,
# the gate sums and the outputs, each rounded to bf16), a few bf16
# roundings of the residual stream, as LM_TF_TOL's bf16 case allows for.
# deepseek-v3-671b is counted on the meta device.
DS_NAME = "deepseek-v2-236b"
DS_LAYERS = 5
DS_BATCH = {"prefill_32k": 1, "decode_32k": 128, "long_500k": 1}
DS_MESH_TOL = 0.1  # abs on logits up to ~3


def ds_arch():
    """deepseek-v2-236b's LMArch with phase 9d's depth and batches."""
    import dataclasses

    from repro_torch.archs import get_arch
    from repro_torch.archs.lm import LMArch

    arch = get_arch(DS_NAME)
    shapes = {k: dict(v, global_batch=DS_BATCH.get(k, v["global_batch"]))
              for k, v in arch.shapes.items()}
    return LMArch(dataclasses.replace(arch.cfg, n_layers=DS_LAYERS), arch.optimizer_name, shapes,
                  arch.grad_accum)


def ds_teacher_forcing(args, dev) -> None:
    """Decode (absorbed MLA over the latent cache) equals teacher forcing
    (the expanded MLA) at 2 layers of deepseek-v2-236b's width with no
    experts (the capacity drop makes an MoE's decode and prefill differ by
    design), in float32 and in bf16."""
    import dataclasses

    from repro_torch.models.transformer import decode_step, forward_hidden, init_cache, init_params

    base = dataclasses.replace(ds_arch().cfg, n_layers=2, n_experts=0)
    toks = torch.randint(0, base.vocab_size, (2, LM_TF_TOKENS), dtype=torch.int32, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(args.seed + 8))
    for dt in (torch.float32, torch.bfloat16):
        cfg = dataclasses.replace(base, param_dtype=dt, compute_dtype=dt)
        model = init_params(torch.Generator(device=dev).manual_seed(args.seed), cfg, device=dev)
        with torch.inference_mode():
            ref = model.lm_head(forward_hidden(model, toks)).float()
            cache = init_cache(cfg, 2, LM_TF_TOKENS, device=dev)
            outs = []
            for t in range(LM_TF_TOKENS):
                lg, cache = decode_step(model, cache, toks[:, t])
                outs.append(lg)
            err = float((torch.stack(outs, 1) - ref).abs().max())
        tol = LM_TF_TOL[str(dt).split(".")[1]]
        log(f"lm: decode == teacher forcing at 2 MLA layers of {DS_NAME}'s width, no experts, "
            f"{dt}: max abs diff {err:.3e} on logits up to {float(ref.abs().max()):.3f} "
            f"(tolerance {tol})")
        check(err <= tol, f"lm: MLA decode differs from teacher forcing by {err} ({dt})")
        del model, cache, ref, outs


def drop_hooks(model, sink: list):
    """Pre-hooks on each MoE layer appending (routed pairs, pairs dropped by
    capacity) of its call to ``sink``; returns the handles."""
    from repro_torch.models.transformer.moe import capacity_drops

    return [lp.ffn.register_forward_pre_hook(
        lambda mod, a: sink.append(capacity_drops(mod, mod.cfg, a[0])))
        for lp in model.moe_layers]


def drop_shares(sink) -> list:
    return [dropped / max(routed, 1) for routed, dropped in sink]


def route_hooks(model, sink: list):
    """Pre-hooks on each MoE layer appending (the layer, a copy of its input)
    to ``sink``: one copy a layer in the timed step, routed afterwards by
    ``routes_of``."""
    return [lp.ffn.register_forward_pre_hook(lambda mod, a: sink.append((mod, a[0].clone())))
            for lp in model.moe_layers]


def routes_of(steps) -> list:
    """Each step's (layer, input) pairs -> its layers' (T, E) masks of the
    experts the tokens select."""
    from repro_torch.models.transformer.moe import routed_experts

    return [[routed_experts(mod, mod.cfg, x) for mod, x in step] for step in steps]


def timed_decode(model, cache, tokens, fn, same_cache, what,
                 routes=None) -> tuple[dict, list, list]:
    """LM_DECODE_STEPS timed steps, each ending in a sync, its logits checked
    finite and ``same_cache()`` true (the cache written in place) -> (the
    cache after them, each step's wall, each step's logits); with
    ``routes``, each step's list of its MoE layers' (layer, input) pairs is
    appended to it (``route_hooks``)."""
    walls, logits = [], []
    for t in range(LM_DECODE_STEPS):
        hooks = []
        if routes is not None:
            routes.append([])
            hooks = route_hooks(model, routes[-1])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = fn(model, cache, tokens[:, t])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        for h in hooks:
            h.remove()
        check(bool(torch.isfinite(lg).all()) and tuple(lg.shape) == (
            tokens.shape[0], model.cfg.vocab_padded),
              f"lm {what}: step {t}'s logits are not finite or of shape {tuple(lg.shape)}")
        check(same_cache(), f"lm {what}: the cache moved in step {t}")
        logits.append(lg)
    return cache, walls, logits


def ds_phase(args, dev) -> None:
    """9d: deepseek-v2-236b at full width, depth cut to DS_LAYERS (one dense,
    four MoE), bf16 weights from --seed: prefill_32k (batch 1), decode_32k
    (batch 128) and long_500k (batch 1), 8 decode steps each from a random
    bf16 latent cache at its last 8 positions, long_500k again on a (1, 4)
    mesh of the card; one `lm {...}` line a cell and `profile
    decode_32k_v2`. deepseek-v3-671b's counts on the meta device."""
    from repro_torch.archs import get_arch
    from repro_torch.data import lm_batch
    from repro_torch.distributed import MeshInfo
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.transformer import init_params, shard_cache
    from repro_torch.models.transformer.moe import capacity
    from repro_torch.roofline.model import lm_serve_bound

    v3 = get_arch("deepseek-v3-671b").cfg
    log(f"lm: deepseek-v3-671b param_count {v3.param_count()} active_param_count "
        f"{v3.active_param_count()} (meta device)")
    ds_teacher_forcing(args, dev)
    arch = ds_arch()
    cfg = arch.cfg
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = init_params(torch.Generator(device=dev).manual_seed(args.seed), cfg, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"lm: {DS_NAME} cut to {DS_LAYERS} layers ({cfg.n_dense} dense, {cfg.n_moe} MoE): "
        f"{n_params} parameters ({cfg.param_dtype}, "
        f"{sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9:.3f} GB) drawn in "
        f"{time.perf_counter() - t0:.2f} s; param_count() {cfg.param_count()}")
    check(n_params == cfg.param_count(), "lm: the model's parameters differ from param_count()")

    for shape in ("prefill_32k", "decode_32k", "long_500k"):
        sh = arch.shapes[shape]
        b, n = sh["global_batch"], sh["seq_len"]
        fn = arch.make_cell(shape).fn
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        sink: list = []
        if shape == "prefill_32k":
            bound = lm_serve_bound(cfg, "prefill", b, n)
            tokens = lm_batch(args.seed, 0, b, n, cfg.vocab_size, device=dev)["tokens"]
            hooks = drop_hooks(model, sink)  # 4 router products and sorts beside a ~40 s prefill
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = fn(model, tokens)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            for h in hooks:
                h.remove()
            check(tuple(logits.shape) == (b, cfg.vocab_padded)
                  and logits.dtype == torch.float32 and bool(torch.isfinite(logits).all()),
                  f"lm {shape}: logits of shape {tuple(logits.shape)} {logits.dtype}, or not "
                  f"finite")
            row = dict(cell=f"{shape}_v2", model=DS_NAME, batch=b, seq=n, layers=cfg.n_layers,
                       wall_s=wall, tokens_per_s=b * n / wall, launches_per_step="not measured")
            del tokens, logits
        else:
            bound = lm_serve_bound(cfg, "decode", b, n)
            cache = lm_cache(cfg, b, n, args.seed, dev)
            mesh = None
            if shape == "long_500k":
                mi = MeshInfo(mesh=make_test_mesh(4, model=4, device="cuda:0"))
                mesh = (mi, shard_cache(cache, mi))
            ptr = cache["c"].data_ptr()
            tokens = lm_batch(args.seed, 1, b, LM_DECODE_STEPS, cfg.vocab_size,
                              device=dev)["tokens"]
            routes = [] if mesh is not None else None
            cache, walls, logits = timed_decode(model, cache, tokens, fn,
                                             lambda: cache["c"].data_ptr() == ptr, shape, routes)
            check(int(cache["pos"]) == n, f"lm {shape}: pos {int(cache['pos'])} after the steps")
            warm = sorted(walls[1:])[len(walls[1:]) // 2]
            row = dict(cell=f"{shape}_v2", model=DS_NAME, batch=b, cache_len=n,
                       cache_gb=cache["c"].numel() * 2 / 1e9, layers=cfg.n_layers,
                       steps=LM_DECODE_STEPS, first_step_s=walls[0], step_s_median=warm,
                       step_s=walls, tokens_per_s=b / warm)
            cache["pos"] = torch.tensor(n - 1, dtype=torch.int32, device=dev)
            hooks = drop_hooks(model, sink)
            fn(model, cache, tokens[:, 0])
            for h in hooks:
                h.remove()
            prof = profile_batch(f"{shape}_v2", lambda: fn(model, cache, tokens[:, 0]))
            row["launches_per_step"] = prof["kernels"] if prof else "not measured"
            del cache
        row.update(capacity=capacity(cfg, b * (n if shape == "prefill_32k" else 1),
                                     cfg.n_experts),
                   drop_share=drop_shares(sink), routed_pairs=[r for r, _ in sink])
        row.update(peak_gb=torch.cuda.max_memory_allocated() / 1e9, bound_s=bound["bound_s"],
                   bound_by=bound["bound_by"], bound_share=bound["bound_s"] / (
                       row.get("wall_s") or row["step_s_median"]),
                   flops_attn=bound["flops_attn"], flops_proj=bound["flops_proj"],
                   hbm_bytes=bound["hbm_bytes"])
        log(f"lm {json.dumps(row)}")
        if shape != "prefill_32k":
            if mesh is not None:
                ds_mesh_long(mesh, model, tokens, (logits, routes), walls, bound, arch)
            del logits, tokens, mesh
        log_memory(f"after lm {shape}_v2")
    del model


def ds_mesh_long(mesh, model, tokens, one, walls_one, bound, arch) -> None:
    """long_500k on the (1, 4) mesh of the card from the same starting cache;
    one `lm {...}` line (cell long_500k_v2_p4). A step whose MoE layers
    route its token to the same experts as the one-device run's step holds
    its logits within DS_MESH_TOL of that run's. The shards' sums round in
    another order, so a token near a tie at the bf16 threshold may route
    elsewhere (a flip), and a flipped step's logits part by the experts'
    difference: flipped steps are counted, and at least one step must be
    held."""
    want, routes_one = one
    mi, cache = mesh
    fn = arch.make_cell("long_500k", mi).fn
    blocks = cache["c"][0]
    ptrs = [blk.data_ptr() for blk in blocks]
    routes = []
    cache, walls, logits = timed_decode(model, cache, tokens, fn,
                                     lambda: [blk.data_ptr() for blk in blocks] == ptrs,
                                     "long_500k_v2_p4", routes)
    check(all(a is b for a, b in zip(cache["c"][0], blocks))
          and int(cache["pos"]) == blocks[0].shape[2] * len(blocks),
          f"lm long_500k_v2_p4: the cache's blocks were replaced, or pos {int(cache['pos'])}")
    errs = [float((a - b).abs().max()) for a, b in zip(logits, want)]
    routes, routes_one = routes_of(routes), routes_of(routes_one)
    flipped = [any(not torch.equal(a, b) for a, b in zip(r_mesh, r_one))
               for r_mesh, r_one in zip(routes, routes_one)]
    held = [e for e, f in zip(errs, flipped) if not f]
    check(bool(held) and max(held) <= DS_MESH_TOL,
          f"lm long_500k_v2_p4: {len(held)} steps route as the one-device run's, their logits "
          f"{held} apart (tolerance {DS_MESH_TOL})")
    warm = sorted(walls[1:])[len(walls[1:]) // 2]
    log("lm " + json.dumps(dict(
        cell="long_500k_v2_p4", model=DS_NAME, mesh=[1, 4], shards=len(blocks),
        shard_rows=blocks[0].shape[2], steps=LM_DECODE_STEPS, first_step_s=walls[0],
        step_s_median=warm, step_s=walls, tokens_per_s=1 / warm,
        one_device_step_s_median=sorted(walls_one[1:])[len(walls_one[1:]) // 2],
        max_abs_diff_vs_one_device=errs, routes_flipped=flipped,
        expert_sets_differing=[sum(int((a != b).any(-1).sum()) for a, b in zip(rm, ro))
                               for rm, ro in zip(routes, routes_one)], tolerance=DS_MESH_TOL,
        logit_max=float(max(lg.abs().max() for lg in want)),
        peak_gb=torch.cuda.max_memory_allocated() / 1e9, bound_s=bound["bound_s"],
        bound_by=bound["bound_by"], bound_share=bound["bound_s"] / warm)))
    del cache, blocks


# --------------------------------------------------------------------------- phase 10
# LM training: train_4k through LMArch.make_cell on the card (Adafactor or
# AdamW as the arch names, clip 1.0, its grad_accum), bf16 weights from
# --seed, seq 4096. No ported kernel is on this path. Cuts (PERF.md §4):
# every batch from 256 sequences; deepseek-v2-236b's depth from 1 dense +
# 59 MoE layers to 1 + 1 (5.4e9 parameters, all 160 experts); deepseek-
# v3-671b's from 3 dense + 58 MoE layers to its 3 dense layers and the MTP
# block (one V3 MoE layer, 11.3e9 parameters, does not train on one card
# with its state). (name, layers or None for all, sequences, steps)
LM_TRAIN_CELLS = (("granite-3-2b", None, 8, 2), ("deepseek-v2-236b", 2, 2, 3),
                  ("deepseek-v3-671b", 3, 4, 2))
# card == CPU: two train_4k steps of each at the smoke widths (float32),
# from each of CARD_CPU_SEEDS seeds (--seed, --seed + 1, ...)
CARD_CPU_SEEDS = 3
LM_TRAIN_SMOKE = (("smoke-gqa", "adamw", 1), ("smoke-mla-moe", "adafactor", 2))
LM_TRAIN_LR = {"adamw": 3e-4, "adafactor": 1e-3}


def card_equals_cpu(name, cell, dev, lr, seed, dtype="float32") -> None:
    """Two steps of ``cell`` from the same weights, state and batch on the
    CPU and on the card, held to each other by ``train.parity``: the
    metrics of both steps, and the parameters after the first, each limit
    checked against its control."""
    from repro_torch.train.parity import LEAF_FAR_SHARE, LOSS_RTOL, failures, step_readings

    r = step_readings(cell, dev, seed, lr)
    log(f"card == CPU {name}: metrics of two steps max rel diff {r['rel']:.3e} (limit "
        f"{LOSS_RTOL[dtype]}; control, one update's change of the loss: {r['update_rel']:.3e}); "
        f"parameters max abs diff {r['worst']:.3e} (limit {2 * lr + 1e-6:.3e}), {r['far']} of "
        f"{r['elements']} elements beyond 1e-3 lr + 1e-6, at most {r['leaf_far']:.3e} of a leaf's "
        f"({r['leaf_far_name']}; limit {LEAF_FAR_SHARE[dtype]}; control, a leaf's update dropped "
        f"or sign-flipped, least of {r['controlled']} of {r['leaves']} leaves: "
        f"{r['control']:.3e}, {r['control_name']})")
    for msg in failures(r, lr, dtype):
        check(False, f"card == CPU {name}: {msg}")


def leaf_sums(views) -> dict:
    return {k: float(v.detach().sum(dtype=torch.float64)) for k, v in views.items()}


def train_cell_run(cell, dev, seed, steps, next_batch):
    """Init, then ``steps`` steps of a train cell (``next_batch(step)`` after
    the first), each ending in a sync -> (row, the leaves whose values did
    not change, the leaves whose first moment is still zero). A bf16
    leaf's update can round away (p + u in bf16, as the reference adds):
    RMSNorm scales at 1.0 do not move under AdamW at lr 3e-4, whose update
    is under half of bf16's ulp there; the first moment shows that the
    leaf's gradient reached the optimizer."""
    from repro_torch.train import reference_layout

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, state, batch = cell.make_inputs(seed, dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    views = reference_layout(model)
    before = leaf_sums(views)
    walls, metrics = [], []
    for step in range(steps):
        if step:
            batch = next_batch(step)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, state, m = cell.fn(model, state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
    after = leaf_sums(views)
    unmoved = [k for k in views if after[k] == before[k]]
    silent = [k for k, v in state["m"].items() if not bool(v.any())]
    warm = walls[1:] or walls  # the steps after the first
    row = dict(init_s=t_init, first_step_s=walls[0], step_s_warm=sum(warm) / len(warm),
               step_s=walls, metrics=metrics, peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               params=sum(v.numel() for v in views.values()), leaves=len(views),
               every_leaf_moved=not unmoved, every_leaf_updated=not silent,
               unmoved_bf16=[k for k in unmoved if views[k].dtype == torch.bfloat16])
    unmoved = [k for k in unmoved if views[k].dtype != torch.bfloat16]
    del model, state, batch, views
    return row, unmoved + silent


def check_train_row(what, row, unmoved) -> None:
    check(all(math.isfinite(v) for m in row["metrics"] for v in m.values()),
          f"{what}: a loss is not finite")
    check(not unmoved, f"{what}: parameters not updated, or float32 ones that did not "
                       f"change: {unmoved[:5]}")


def lm_train_phase(args, dev) -> None:
    """Phase 10: card == CPU for two train_4k steps of the smoke LM configs,
    then granite-3-2b, deepseek-v2-236b and deepseek-v3-671b's train_4k on
    the card with phase 10's cuts; one `lm_train {...}` line each."""
    import dataclasses

    from repro_torch.archs import get_arch
    from repro_torch.archs.lm import LMArch
    from repro_torch.data import lm_batch
    from repro_torch.roofline.model import lm_train_bound

    t_phase = time.perf_counter()
    for name, opt, accum in LM_TRAIN_SMOKE:
        base = get_arch(name)
        cfg = dataclasses.replace(base.cfg, router_aux_coef=0.01) if base.cfg.is_moe else base.cfg
        cell = LMArch(cfg, opt, base.shapes, accum).make_cell("train_4k")
        for seed in range(args.seed, args.seed + CARD_CPU_SEEDS):
            card_equals_cpu(f"{name} train_4k ({opt}, grad_accum {accum}) seed {seed}", cell, dev,
                            LM_TRAIN_LR[opt], seed)
    for name, layers, b, steps in LM_TRAIN_CELLS:
        base = get_arch(name)
        cfg = base.cfg if layers is None else dataclasses.replace(base.cfg, n_layers=layers)
        shapes = {"train_4k": dict(base.shapes["train_4k"], global_batch=b)}
        arch = LMArch(cfg, base.optimizer_name, shapes, base.grad_accum)
        s = shapes["train_4k"]["seq_len"]
        row, unmoved = train_cell_run(
            arch.make_cell("train_4k"), dev, args.seed, steps,
            lambda step: lm_batch(args.seed, step, b, s, cfg.vocab_size, device=dev))
        bound = lm_train_bound(cfg, b, s, arch.grad_accum)
        row = dict(cell=f"train_4k_{name}", card=args.card, layers=cfg.n_layers, dense=cfg.n_dense,
                   moe=cfg.n_moe, mtp=cfg.mtp, batch=b, seq=s, grad_accum=arch.grad_accum,
                   optimizer=arch.optimizer_name, remat=cfg.remat, steps=steps,
                   tokens_per_s=b * s / row["step_s_warm"], bound_s=bound["bound_s"],
                   bound_by=bound["bound_by"], bound_share=bound["bound_s"] / row["step_s_warm"],
                   **row)
        log(f"lm_train {json.dumps(row)}")
        check_train_row(f"lm_train {name}", row, unmoved)
        log_memory(f"after lm_train {name}")
    log(f"lm training: phase wall {time.perf_counter() - t_phase:.1f} s (host clock)")


# --------------------------------------------------------------------------- phase 11
# MACE (arXiv:2206.07697) through GNNArch.make_cell, AdamW: full_graph_sm
# (cora, 2,708 x 10,556) and molecule (128 graphs of 30 x 64) as published;
# minibatch_lg samples 1,024 seeds x fanouts (15, 10) on the card from a
# synthetic graph of reddit's size (PyG Reddit: 232,965 nodes, 114,615,892
# edges, 602 features), a fresh subgraph a step; ogb_products (2,449,029 x
# 61,859,140, d_feat 100, bf16) in the dst-partitioned layout over a (1,
# OGB_SHARDS) mesh of the card, cut by the largest factor of OGB_FACTORS
# whose peak, predicted from a run at OGB_CALIBRATE, fits OGB_FIT of the
# card (PERF.md §4).
MACE_STEPS = 3
REDDIT_NODES, REDDIT_EDGES = 232_965, 114_615_892
OGB_SHARDS = 16
OGB_FACTORS = (1, 2, 4, 8, 16, 32, 64)  # nodes and edges divided by this
OGB_CALIBRATE = 256
OGB_FIT = 0.8
DST_SMALL = (4096, 65_536, 4)  # nodes, edges, shards: dst == simple on the card


def mace_row(cell, sh, n, e, row, cfg, card) -> dict:
    from repro_torch.roofline.model import mace_bound

    bound = mace_bound(cfg, n, e, sh["mode"])
    return dict(cell=cell, card=card, mode=sh["mode"], nodes=n, edges=e, d_feat=cfg.d_feat,
                compute=str(cfg.compute_dtype).split(".")[1], steps=len(row["step_s"]),
                nodes_per_s=n / row["step_s_warm"], edges_per_s=e / row["step_s_warm"],
                examples_per_s=sh.get("batch", sh.get("batch_nodes", 1)) / row["step_s_warm"],
                bound_s=bound["bound_s"], bound_by=bound["bound_by"],
                bound_share=bound["bound_s"] / row["step_s_warm"], **row)


def reddit_graph(seed, dev):
    """A uniform random graph of reddit's size on the card, as CSR: (indptr
    (N + 1,), indices (E,)) int32, node features (N, 602) normal, and the
    generator that drew them."""
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    rows = torch.randint(0, REDDIT_NODES, (REDDIT_EDGES,), generator=gen, device=dev)
    counts = torch.bincount(rows, minlength=REDDIT_NODES)
    del rows
    indptr = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), torch.cumsum(counts, 0)])
    indices = torch.randint(0, REDDIT_NODES, (REDDIT_EDGES,), generator=gen, dtype=torch.int32,
                            device=dev)
    feats = torch.randn((REDDIT_NODES, 602), generator=gen, device=dev)
    return indptr.to(torch.int32), indices, feats, gen


def ogb_arch(factor: int, n_shards: int):
    from repro_torch.archs import get_arch
    from repro_torch.archs.gnn import GNNArch

    base = get_arch("mace")
    sh = base.shapes["ogb_products"]
    cut = dict(sh, n_nodes=-(-sh["n_nodes"] // factor), n_edges=-(-sh["n_edges"] // factor))
    return GNNArch(base.base_cfg, {"ogb_products": cut}), cut


def dst_small_check(args, dev) -> None:
    """The dst-partitioned loss over DST_SMALL's shards of the card equals
    the simple loss on the same graph: float32 within 1e-5 relative, and
    bf16 (the ogb_products cell's dtype) logged beside it."""
    import dataclasses

    from repro_torch.data import gnn_batch
    from repro_torch.distributed import MeshInfo
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.gnn import mace as gm
    from repro_torch.models.gnn.distributed import dst_partitioned_loss, partition_by_destination

    n, e, shards = DST_SMALL
    cfg = dataclasses.replace(gm.MACEConfig(), d_feat=100)
    model = gm.init_params(torch.Generator(device=dev).manual_seed(args.seed), cfg, device=dev)
    batch = gnn_batch(args.seed, 0, n, e, d_feat=100, device=dev)
    mi = MeshInfo(make_test_mesh(shards, model=shards, device=dev))
    part = partition_by_destination(batch, shards)
    for dt in (torch.float32, torch.bfloat16):
        c = dataclasses.replace(cfg, compute_dtype=dt)
        with torch.no_grad():
            simple = float(gm.loss(model, c, batch)[0])
            dst = float(dst_partitioned_loss(model, c, mi, part)[0])
        rel = abs(dst - simple) / abs(simple)
        log(f"mace: dst-partitioned over {shards} shards of the card == simple at {n} x {e}, "
            f"{dt}: {dst:.7g} vs {simple:.7g}, rel diff {rel:.3e}")
        if dt == torch.float32:
            check(rel <= 1e-5, f"mace: dst-partitioned differs from simple by {rel}")
    del model, batch, part


def mace_phase(args, dev) -> None:
    """Phase 11: card == CPU for two steps of each smoke-mace cell, the dst
    == simple check, then mace's four cells on the card; one `mace {...}`
    line each."""
    import dataclasses

    from repro_torch.archs import get_arch
    from repro_torch.archs.gnn import graph_size
    from repro_torch.distributed import MeshInfo
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.gnn.sampler import sample_subgraph

    t_phase = time.perf_counter()
    smoke = get_arch("smoke-mace")
    for shape in smoke.shape_names():
        dt = str(smoke.cfg_for(shape).compute_dtype).split(".")[1]
        for seed in range(args.seed, args.seed + CARD_CPU_SEEDS):
            card_equals_cpu(f"smoke-mace {shape} ({dt}) seed {seed}", smoke.make_cell(shape),
                            dev, 1e-3, seed, dt)
    dst_small_check(args, dev)
    arch = get_arch("mace")
    for shape in ("full_graph_sm", "molecule"):
        sh = arch.shapes[shape]
        n, e = graph_size(sh)
        row, unmoved = train_cell_run(arch.make_cell(shape), dev, args.seed, MACE_STEPS,
                                      lambda step: arch.batch(shape, args.seed, step, dev))
        log(f"mace {json.dumps(mace_row(shape, sh, n, e, row, arch.cfg_for(shape), args.card))}")
        check_train_row(f"mace {shape}", row, unmoved)

    # minibatch_lg: a fresh sampled subgraph of the reddit-size graph a step
    sh = arch.shapes["minibatch_lg"]
    t0 = time.perf_counter()
    indptr, indices, feats, gen = reddit_graph(args.seed, dev)
    torch.cuda.synchronize()
    t_graph = time.perf_counter() - t0
    sample_s = []

    def sampled(step):
        seeds = torch.randint(0, REDDIT_NODES, (sh["batch_nodes"],), generator=gen, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sub = sample_subgraph(indptr, indices, seeds, sh["fanouts"], generator=gen)
        torch.cuda.synchronize()
        sample_s.append(time.perf_counter() - t0)
        nodes = sub["nodes"].long()
        n = nodes.shape[0]
        # positions synthesized a subgraph slot, as gnn_batch draws them: a
        # node sampled twice at one position would put a zero edge vector,
        # whose rhat = rvec / 1e-9 has slope 1e9, between two slots
        return {"positions": torch.randn((n, 3), generator=gen, device=dev),
                "node_feat": feats[nodes], "senders": sub["senders"],
                "receivers": sub["receivers"],
                "energy": torch.randn((1,), generator=gen, device=dev),
                "forces": torch.randn((n, 3), generator=gen, device=dev) * 0.1}

    cell = arch.make_cell("minibatch_lg")
    inner = cell.make_inputs

    def make_inputs(seed, device):
        model, state, _ = inner(seed, device)
        return model, state, sampled(0)

    n, e = graph_size(sh)
    row, unmoved = train_cell_run(dataclasses.replace(cell, make_inputs=make_inputs), dev,
                                  args.seed, MACE_STEPS, sampled)
    row = mace_row("minibatch_lg", sh, n, e, row, arch.cfg_for("minibatch_lg"), args.card)
    row.update(graph_nodes=REDDIT_NODES, graph_edges=REDDIT_EDGES, graph_build_s=t_graph,
               sample_s=sample_s)
    log(f"mace {json.dumps(row)}")
    check_train_row("mace minibatch_lg", row, unmoved)
    del indptr, indices, feats
    log_memory("after mace minibatch_lg")

    # ogb_products: calibrate the peak, then the largest cut that fits
    mi = MeshInfo(make_test_mesh(OGB_SHARDS, model=OGB_SHARDS, device=dev))
    gc.collect()
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0]
    base_alloc = torch.cuda.memory_allocated()
    cal, sh_cal = ogb_arch(OGB_CALIBRATE, OGB_SHARDS)
    row_cal, _ = train_cell_run(cal.make_cell("ogb_products", mi), dev, args.seed, 1, None)
    per_edge = (row_cal["peak_gb"] * 1e9 - base_alloc) / sh_cal["n_edges"]
    full_edges = arch.shapes["ogb_products"]["n_edges"]
    factor = next((f for f in OGB_FACTORS if per_edge * full_edges / f <= OGB_FIT * free),
                  OGB_FACTORS[-1])
    log(f"mace: ogb_products calibration at 1/{OGB_CALIBRATE} ({sh_cal['n_nodes']} x "
        f"{sh_cal['n_edges']}): peak {row_cal['peak_gb']:.3f} GB, {per_edge:.1f} B an edge; "
        f"predicted peak at the published size {per_edge * full_edges / 1e9:.1f} GB against "
        f"{OGB_FIT} x {free / 1e9:.1f} GB free: runs at 1/{factor}")
    ogb, sh_cut = ogb_arch(factor, OGB_SHARDS)
    n, e = graph_size(sh_cut, OGB_SHARDS)
    row, unmoved = train_cell_run(
        ogb.make_cell("ogb_products", mi), dev, args.seed, 2,
        lambda step: ogb.batch("ogb_products", args.seed, step, dev, mi))
    row = mace_row("ogb_products", sh_cut, n, e, row, ogb.cfg_for("ogb_products"), args.card)
    row.update(cut_factor=factor, shards=OGB_SHARDS, predicted_peak_gb=per_edge * e / 1e9)
    log(f"mace {json.dumps(row)}")
    check_train_row("mace ogb_products", row, unmoved)
    log_memory("after mace ogb_products")
    log(f"mace: phase wall {time.perf_counter() - t_phase:.1f} s (host clock)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000, help="corpus size (airship-sift1m: 1M)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    # 1. environment
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    args.card = smi.stdout.strip().splitlines()[0]  # name, power limit: beside every row
    log(args.card)
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 products (phase 9's LM) accumulate in float32
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda", 0)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    # 2. build
    from repro_torch.kernels import BUILD_LOGS, build_all

    t0 = time.perf_counter()
    paths = build_all()
    log(f"build: {', '.join(p.name for p in paths.values())} in "
        f"{time.perf_counter() - t0:.2f} s (set-up)")
    for stem, out in BUILD_LOGS.items():
        log(f"ptxas {stem}: {ptxas_summary(out)}")

    # 3.-6.
    max_err, timings = kernel_phase(args, dev)
    pq_err, pq_timings = pq_kernel_phase(args, dev)
    l2_err, l2_timing = l2_kernel_phase(args, dev)
    bag_err, bag_timings = bag_kernel_phase(args, dev)
    # 3b. the tuner's lattice at the main path's shapes
    tune_phase(args, dev)
    small_world_phase(args, dev)
    two_tower_small_phase(args, dev)
    launch = LaunchCounts()
    world = search_phase(args, dev, launch)
    # 6b. streaming and hybrid, over phase 6's world
    streaming_phase(args, dev, launch, world)
    # 6c. serving, over phase 6's world
    serving_phase(args, dev, launch, world)
    log_memory("after phase 6c")
    # 6d. scale-out (mesh, replicas, HTTP, the launcher), over phase 6's world
    scaleout_phase(args, dev, launch, world)
    del world
    # the serving phases' objects (a closure cycle among them) may pin
    # cached segments that phase 7's 51.2 GB table needs
    log_memory("after phase 6d, the world freed")
    # 7. two-tower-retrieval, after the airship-sift1m world is freed
    two_tower_phase(args, dev, launch)
    log_memory("after phase 7, its tables freed")
    # 8. recsys training: the bag's backward kernel, then DeepFM, DLRM and
    # the two-tower model
    bwd_err, bwd_timing = bag_backward_phase(args, dev)
    train_phase(args, dev, launch)
    log_memory("after phase 8")
    # 9. attention, SASRec, granite-3-2b and deepseek-v2-236b serving (no
    # ported kernel on this path: launch counts stay as phases 3-8 left them)
    t9 = time.perf_counter()
    attention_phase(args, dev)
    sasrec_phase(args, dev)
    lm_phase(args, dev)
    log_memory("after phase 9c")
    # 9d. deepseek-v2-236b (MLA + MoE), after 9c's model and caches are freed
    t9d = time.perf_counter()
    ds_phase(args, dev)
    log(f"phase 9d: wall {time.perf_counter() - t9d:.1f} s (host clock)")
    log(f"phase 9: wall {time.perf_counter() - t9:.1f} s (host clock)")
    log_memory("after phase 9d")
    # 10. LM training; 11. MACE (no ported kernel on either path: the counts
    # read after them must stay 0)
    launch.reset()
    lm_train_phase(args, dev)
    mace_phase(args, dev)
    idle = launch.read()
    check(not any(idle.values()), f"phases 10-11 launched ported kernels: {idle}")

    max_err.update(pq_err, l2_matmul=l2_err, embedding_bag=bag_err,
                   embedding_bag_backward=bwd_err)
    rows = {name: timings[32][name] for name in ("gather_distance", "fused_expand")}
    rows["fused_expand_adc"] = pq_timings["fused_expand_adc"][32]
    rows["pq_adc"] = pq_timings["pq_adc"]
    rows["l2_matmul"] = l2_timing
    rows["embedding_bag"] = bag_timings["serve_bulk"]
    rows["embedding_bag_backward"] = bwd_timing
    sources = {
        "gather_distance": ("src/repro_torch/csrc/gather_distance.cu",
                            "src/repro/kernels/gather_distance/gather_distance.py:85"),
        "fused_expand": ("src/repro_torch/csrc/fused_expand.cu",
                         "src/repro/kernels/fused_expand/fused_expand.py:216"),
        "fused_expand_adc": ("src/repro_torch/csrc/fused_expand_adc.cu",
                             "src/repro/kernels/fused_expand/fused_expand.py:408"),
        "pq_adc": ("src/repro_torch/csrc/pq_adc.cu", "src/repro/kernels/pq_adc/pq_adc.py:41"),
        "l2_matmul": ("src/repro_torch/csrc/l2_matmul.cu",
                      "src/repro/kernels/l2_matmul/l2_matmul.py:48"),
        "embedding_bag": ("src/repro_torch/csrc/embedding_bag.cu",
                          "src/repro/kernels/embedding_bag/embedding_bag.py:39"),
        # No TPU kernel: the reference differentiates embedding_bag_sum's jnp.
        "embedding_bag_backward": ("src/repro_torch/csrc/embedding_bag_backward.cu",
                                   "src/repro/models/recsys/models.py:94"),
    }
    kernels = []
    for name, (source, replaces) in sources.items():
        t = rows[name]
        kernels.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                            launches=launch.total[name], max_abs_err=max_err[name], ms=t["ms"],
                            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                            bound_by=t["bound_by"], library_ms=t.get("library_ms"),
                            config=t.get("config")))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
