"""Two measurements behind choices in the port, on one NVIDIA GPU.

    python3 tools/fused_expand_adc_ab.py [--n 1000000]

1. The timing method (chip_smoke.py's ``device_ms``): one small launch,
   gather_distance over 256 x 32 candidates, read as the first reading of
   the process (raw, not dropped), then through ``device_ms`` beside other
   kernels, after a 3 s pause and again.
2. fused_expand_adc's all-padding vote (``csrc/fused_expand_adc.cu``: a
   block whose ids are all padding stages nothing) against variant B, the
   same source with the vote removed, so every block starts its table copy
   before its ids arrive. Isolated at the smoke's shapes with one table kept
   in L2 or a table per call, with no padding or half the rows padding;
   then inside serve_256_pq_fused (airship-sift1m at --n, as chip_smoke.py
   builds it): the share of all-padding rows per launch, and the kernel's
   traced time in the walk as it runs, with the query tables read just
   before each launch (warm in L2), and with L2 overwritten just before each
   launch (cold), for both variants, twice, in alternating order.

Prints the card's name and power limit, then one line per measurement.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch import kernels as K  # noqa: E402
from repro_torch.kernels import fused_expand as FX  # noqa: E402

VOTE = re.compile(r"  // A block whose candidates are all padding.*?\n    return;\n  }\n", re.S)


def build_variants():
    """The committed library (A) and the one without the vote (B)."""
    out = K.BUILD_DIR / "ab"
    (out / "csrc").mkdir(parents=True, exist_ok=True)
    for f in K.CSRC.iterdir():
        (out / "csrc" / f.name).write_bytes(f.read_bytes())
    src = (out / "csrc" / "fused_expand_adc.cu").read_text()
    vote = VOTE.search(src)
    if vote is None:
        sys.exit("the all-padding vote is not in csrc/fused_expand_adc.cu")
    (out / "csrc" / "fused_expand_adc.cu").write_text(src.replace(vote.group(0), ""))
    lib_b = out / "libfused_expand_adc_B.so"
    proc = subprocess.Popen([K._nvcc(), *K.NVCC_FLAGS, "-I", str(out / "csrc"), "-o", str(lib_b),
                             str(out / "csrc" / "fused_expand_adc.cu")],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    paths = K.build_all()
    log, _ = proc.communicate()
    if proc.returncode != 0:
        sys.exit(log)
    return {"A": ctypes.CDLL(str(paths["fused_expand_adc"])), "B": ctypes.CDLL(str(lib_b))}


def timing_state(gen, n, dev):
    from repro_torch.kernels.gather_distance import gather_distance_cuda

    corpus = torch.randn((n, cs.D_MAIN), generator=gen, device=dev)
    queries = torch.randn((cs.B, cs.D_MAIN), generator=gen, device=dev)
    labels = torch.randint(0, 10, (n,), generator=gen, dtype=torch.int32, device=dev)
    words = cs.rand_words(gen, (cs.B, 1), dev)
    gd, fx = [], []
    for _ in range(26):
        ids, visited, _, _, _ = cs.kernel_inputs(gen, labels, 32, 0.0, "label", 10, False)
        gd.append((queries, corpus, ids))
        fx.append((queries, corpus, ids, visited, labels, words))

    def fx_kernel(*a):
        return FX.fused_expand_cuda(*a, family="label")

    cs._first_reading = False  # the raw first reading
    seq = [("gather_distance, first reading", cs.device_ms(gather_distance_cuda, gd)),
           ("fused_expand", cs.device_ms(fx_kernel, fx)),
           ("launch floor", cs.launch_floor_ms(cs.B, 32, dev)),
           ("gather_distance", cs.device_ms(gather_distance_cuda, gd))]
    time.sleep(3)
    seq += [("gather_distance after a 3 s pause", cs.device_ms(gather_distance_cuda, gd)),
            ("fused_expand", cs.device_ms(fx_kernel, fx)),
            ("gather_distance", cs.device_ms(gather_distance_cuda, gd))]
    print("timing state, us at 256 x 32:", json.dumps([(k, round(v * 1e3, 3)) for k, v in seq]),
          flush=True)


def isolated(gen, n, dev, use):
    m_sub, n_cent = 16, 256
    codes = torch.randint(0, n_cent, (n, m_sub), generator=gen, dtype=torch.int32, device=dev)
    visited = cs.rand_words(gen, (cs.B, (n + 31) // 32), dev)
    labels = torch.randint(0, 10, (n,), generator=gen, dtype=torch.int32, device=dev)
    words = cs.rand_words(gen, (cs.B, 1), dev)

    def kernel(*a):
        return FX.fused_expand_adc_cuda(*a, family="label")

    for m in (32, 128):
        for n_luts in (1, 26):
            luts = [torch.randn((cs.B, m_sub, n_cent), generator=gen, device=dev)
                    for _ in range(n_luts)]
            for pad in (0.0, 0.5):
                sets = []
                for i in range(26):
                    ids = cs.kernel_inputs(gen, labels, m, 0.0, "label", 10, False)[0]
                    # whole rows of padding, as the walk's finished queries give
                    ids[torch.rand(cs.B, generator=gen, device=dev) < pad] = -1
                    sets.append((luts[i % n_luts], codes, ids, visited, labels, words))
                got = {}
                for v in ("A", "B", "B", "A"):
                    use(v)
                    got.setdefault(v, []).append(round(cs.device_ms(kernel, sets) * 1e3, 3))
                outs = []
                for v in ("A", "B"):
                    use(v)
                    outs.append(kernel(*sets[1]))
                if not all(torch.equal(x, y) for x, y in zip(*outs)):
                    sys.exit("variants A and B disagree")
                table = "one table in L2" if n_luts == 1 else "a table per call"
                print(f"isolated M={m}, {table}, padding rows {pad}: us {json.dumps(got)}",
                      flush=True)


def walk(n, dev, use):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch import (GraphIndex, SearchParams, build_index, constrained_search,
                             equal_constraint, make_labeled_corpus, make_queries, pq_train)
    from repro_torch.graph import add_reverse_edges

    # chip_smoke.py's world and queries: the same draws in the same order
    gen = torch.Generator(device=dev).manual_seed(0)
    corpus = make_labeled_corpus(gen, n, cs.D_MAIN, 10, device=dev)
    knn = build_index(gen, corpus, degree=32, sample_size=128, method="exact",
                      reverse_edges=False, device=dev)
    index = GraphIndex(neighbors=add_reverse_edges(knn.neighbors, corpus.vectors, 32),
                       sample_ids=knn.sample_ids, entry_point=knn.entry_point)
    del knn
    queries, qlab = make_queries(gen, corpus, cs.B)
    cons = equal_constraint(qlab, 10)
    pq = pq_train(gen, corpus.vectors, m_sub=16, n_cent=256, iters=20)
    params = SearchParams(mode="prefer", k=10, ef_result=128, ef_sat=128, ef_other=128,
                          n_start=32, max_iters=512, approx="pq", fuse_expand="on")

    def run():
        return constrained_search(corpus, index, queries, cons, params, pq_index=pq)

    kernel = FX.fused_expand_adc_cuda
    state = {"mode": None}
    counts = []
    wipe = torch.empty(2 * cs.L2_BYTES // 4, device=dev)

    def hooked(lut, codes, ids, *a, **k):
        if state["mode"] == "count":
            counts.append(torch.stack([(ids < 0).all(1).sum(), (ids < 0).sum(),
                                       torch.tensor(ids.numel(), device=dev)]))
        elif state["mode"] == "tables warm":
            lut.sum()
        elif state["mode"] == "L2 cold":
            wipe.zero_()
        return kernel(lut, codes, ids, *a, **k)

    FX.fused_expand_adc_cuda = hooked
    use("A")
    ra = run()
    use("B")
    rb = run()
    same = torch.equal(ra.ids, rb.ids) and torch.equal(ra.dists, rb.dists) and all(
        torch.equal(getattr(ra.stats, f), getattr(rb.stats, f))
        for f in ("dist_evals", "hops", "visited", "iters"))
    if not same:
        sys.exit("serve_256_pq_fused differs between variants A and B")
    state["mode"] = "count"
    use("A")
    run()
    state["mode"] = None
    c = torch.stack(counts).cpu().double()
    m = int(ra.stats.iters)
    rows = c[:, 0] / cs.B
    q = len(c) // 4
    print(f"walk: {m} iterations, A == B; {len(c)} launches of {cs.B} x "
          f"{int(c[0, 2]) // cs.B} candidates; all-padding rows a launch: mean "
          f"{float(rows.mean()):.4f}, by quarter of the walk "
          f"{[round(float(rows[i * q:(i + 1) * q].mean()), 4) for i in range(4)]}; "
          f"padding ids {float(c[:, 1].sum() / c[:, 2].sum()):.4f}", flush=True)

    def traced():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):
                run()
                torch.cuda.synchronize()
                prof.step()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA and "fused_expand_adc_kernel" in e.name]
        return len(us), sum(us) / 1e3

    for rep in range(2):
        for mode in (None, "tables warm", "L2 cold"):
            for v in (("A", "B") if rep == 0 else ("B", "A")):
                state["mode"] = mode
                use(v)
                launches, ms = traced()
                print(f"walk traced, {mode or 'as it runs'}, variant {v}: {ms:.4f} ms in "
                      f"{launches} launches, {ms / launches * 1e3:.3f} us a launch", flush=True)
    state["mode"] = None
    FX.fused_expand_adc_cuda = kernel


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    libs = build_variants()

    def use(v):
        K._LIBS["fused_expand_adc"] = libs[v]

    gen = torch.Generator(device=dev).manual_seed(5)
    timing_state(gen, args.n, dev)
    torch.cuda.empty_cache()
    isolated(gen, args.n, dev, use)
    torch.cuda.empty_cache()
    walk(args.n, dev, use)
    use("A")
    return 0


if __name__ == "__main__":
    sys.exit(main())
