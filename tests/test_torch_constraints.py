"""The port's dedup masks, constraints, Eq.-1 estimator, policies and exact
oracle against the reference on the same integer-valued numpy inputs
(helpers shared with test_torch_primitives.py). Reference calls are jitted,
as the search loop runs them."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import alter_ratio as ref_alter
from repro.core import constraints as ref_cons
from repro.core import exact as ref_exact
from repro.core.engine import expand as ref_expand
from repro.core.engine import policy as ref_policy
from repro.core.estimator import sample_satisfied_mask as ref_sample_mask
from repro.core.types import Corpus as RefCorpus
from repro.core.types import GraphIndex as RefGraph
from repro_torch.core import alter_ratio as port_alter
from repro_torch.core import constraints as port_cons
from repro_torch.core import exact as port_exact
from repro_torch.core.engine import expand as port_expand
from repro_torch.core.engine import policy as port_policy
from repro_torch.core.estimator import sample_satisfied_mask as port_sample_mask
from repro_torch.core.types import Corpus, GraphIndex
from test_torch_primitives import (  # noqa: F401 (torch_threads is an autouse fixture)
    T,
    _port_queue,
    _ref_queue,
    eq,
    sorted_queue,
    torch_threads,
)


# --------------------------------------------------------------------------- dedup masks


def test_mask_first_occurrence_both_variants():
    for m in (6, 40, 130, 200):  # pairwise up to 128, sort-based beyond
        rng = np.random.default_rng(m)
        ids = rng.integers(-1, m // 3 + 2, size=(4, m)).astype(np.int32)
        valid = rng.random((4, m)) < 0.7
        want = jax.jit(ref_expand.mask_first_occurrence)(jnp.asarray(ids), jnp.asarray(valid))
        eq(want, port_expand.mask_first_occurrence(T(ids), T(valid)))
        eq(jax.jit(ref_expand.mask_first_occurrence_sorted)(jnp.asarray(ids),
                                                             jnp.asarray(valid)),
           port_expand.mask_first_occurrence_sorted(T(ids), T(valid)))
        eq(want, port_expand.mask_first_occurrence_sorted(T(ids), T(valid)))


# --------------------------------------------------------------------------- constraints


def _cons_world(seed=0, n=130, labels=40, tomb=False):
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, labels, size=n).astype(np.int32)
    lab[31] = 31
    attrs = rng.integers(0, 30, size=(n, 2)).astype(np.float32)
    vec = rng.integers(-5, 6, size=(n, 4)).astype(np.float32)
    tombs = rng.integers(0, 2**32, size=((n + 31) // 32,), dtype=np.uint64).astype(np.uint32)
    ref = RefCorpus(vectors=jnp.asarray(vec), labels=jnp.asarray(lab), attrs=jnp.asarray(attrs),
                    tombstones=jnp.asarray(tombs) if tomb else None)
    port = Corpus(vectors=T(vec), labels=T(lab), attrs=T(attrs),
                  tombstones=T(tombs) if tomb else None)
    return rng, ref, port


def _constraint_pairs(rng, b, labels=40):
    ql = rng.integers(0, labels, size=b).astype(np.int32)
    ql[0] = 31
    ref_l = ref_cons.unequal_pct_constraint(jax.random.PRNGKey(3), jnp.asarray(ql), labels, 30.0)
    lo = rng.integers(0, 20, size=b).astype(np.float32)
    return {
        "label": (ref_l, port_cons.LabelSetConstraint(words=T(ref_l.words))),
        "equal": (ref_cons.equal_constraint(jnp.asarray(ql), labels),
                  port_cons.equal_constraint(T(ql), labels)),
        "range": (ref_cons.RangeConstraint(lo=jnp.asarray(lo), hi=jnp.asarray(lo + 8),
                                           col=jnp.int32(1)),
                  port_cons.RangeConstraint(lo=T(lo), hi=T(lo + 8), col=1)),
        "udf": (lambda lab, a: (lab % 4 == 1) | (a[0] > 20.0),
                lambda lab, a: (lab % 4 == 1) | (a[:, 0] > 20.0)),
    }


@pytest.mark.parametrize("family", ["label", "equal", "range", "udf"])
def test_satisfied_fns_and_tables(family):
    for tomb in (False, True):
        rng, ref_corpus, port_corpus = _cons_world(tomb=tomb)
        b = 5
        ref_c, port_c = _constraint_pairs(rng, b)[family]
        ids = rng.integers(-1, ref_corpus.n, size=(b, 50)).astype(np.int32)
        ids[:, 0] = 31
        eq(jax.jit(ref_cons.make_satisfied_fn(ref_c, ref_corpus))(jnp.asarray(ids)),
           port_cons.make_satisfied_fn(port_c, port_corpus)(T(ids)))
        ref_t = ref_cons.constraint_tables(ref_c, ref_corpus, include_udf=True)
        port_t = port_cons.constraint_tables(port_c, port_corpus, include_udf=True)
        assert ref_t.family == port_t.family
        eq(ref_t.meta, port_t.meta)
        if port_t.family != "udf":
            eq(ref_t.cons, port_t.cons)
        assert (ref_t.tomb is None) == (port_t.tomb is None)
        if family == "udf":
            assert port_cons.constraint_tables(port_c, port_corpus) is None
        if tomb:
            eq(ref_cons.tombstone_test(ref_corpus.tombstones, jnp.asarray(ids)),
               port_cons.tombstone_test(port_corpus.tombstones, T(ids)))


def test_label_set_from_lists_and_words_bit31():
    allowed = [[0, 31], [5, 33, 39], []]
    eq(ref_cons.label_set_from_lists(allowed, 40).words,
       port_cons.label_set_from_lists(allowed, 40, device="cpu").words)
    w = port_cons.label_set_from_lists(allowed, 40, device="cpu").words
    assert int(w[0, 0]) < 0  # bit 31 set, stored as int32


def test_unequal_pct_constraint_shape_and_exclusion():
    ql = torch.tensor([0, 3, 31, 39], dtype=torch.int32)
    cons = port_cons.unequal_pct_constraint(torch.Generator().manual_seed(0), ql, 40, 25.0)
    bits = (cons.words.to(torch.int64) & 0xFFFFFFFF)
    labels = torch.arange(40)
    allowed = ((bits[:, labels // 32] >> (labels % 32)) & 1).bool()
    assert (allowed.sum(-1) == 10).all()
    assert not allowed[torch.arange(4), ql.long()].any()


# --------------------------------------------------------------------------- estimator, policy


def test_sample_mask_and_alter_ratio():
    rng, ref_corpus, port_corpus = _cons_world(n=200)
    nbrs = rng.integers(-1, 200, size=(200, 8)).astype(np.int32)
    sample = rng.permutation(200)[:32].astype(np.int32)
    ref_g = RefGraph(neighbors=jnp.asarray(nbrs), sample_ids=jnp.asarray(sample),
                     entry_point=jnp.int32(0))
    port_g = GraphIndex(neighbors=T(nbrs), sample_ids=T(sample), entry_point=torch.tensor(0))
    for ref_c, port_c in _constraint_pairs(rng, 6).values():
        ref_sat = ref_cons.make_satisfied_fn(ref_c, ref_corpus)
        port_sat = port_cons.make_satisfied_fn(port_c, port_corpus)
        # Jitted as the search loop runs them (eager dispatch is slow here).
        rm = jax.jit(lambda s: ref_sample_mask(ref_sat, s, 6))(ref_g.sample_ids)
        pm = port_sample_mask(port_sat, port_g.sample_ids, 6)
        eq(rm, pm)
        eq(jax.jit(lambda g, m: ref_alter.estimate_alter_ratio(g, ref_sat, m, 8))(ref_g, rm),
           port_alter.estimate_alter_ratio(port_g, port_sat, pm, 8))


def test_policies():
    rng = np.random.default_rng(7)
    sd, si = sorted_queue(rng, 8, 4)
    od, oi = sorted_queue(rng, 8, 4)
    sd[0], od[1] = np.inf, np.inf
    cnt_sat = rng.integers(0, 5, 8).astype(np.int32)
    cnt_total = cnt_sat + rng.integers(0, 5, 8).astype(np.int32)
    ratio = (rng.integers(0, 5, 8) / 4).astype(np.float32)
    for mode in ("vanilla", "start", "alter", "prefer"):
        ref = ref_policy.get_policy(mode)(_ref_queue(sd, si), _ref_queue(od, oi),
                                          jnp.asarray(cnt_sat), jnp.asarray(cnt_total),
                                          jnp.asarray(ratio))
        port = port_policy.get_policy(mode)(_port_queue(sd, si), _port_queue(od, oi),
                                            T(cnt_sat), T(cnt_total), T(ratio))
        eq(ref, port)
        assert ref_policy.is_two_queue(mode) == port_policy.is_two_queue(mode)


# --------------------------------------------------------------------------- exact oracle


def test_exact_oracle_and_recall():
    rng, ref_corpus, port_corpus = _cons_world(n=300)
    q = rng.integers(-5, 6, size=(5, 4)).astype(np.float32)
    for block in (64, 65536):  # many blocks, and one
        for family, (ref_c, port_c) in _constraint_pairs(rng, 5).items():
            if family == "udf":
                continue  # the reference oracle is jitted and cannot take a closure
            rd, ri = ref_exact.exact_constrained_search(ref_corpus, jnp.asarray(q), ref_c, 10,
                                                        block=block)
            pd, pi = port_exact.exact_constrained_search(port_corpus, T(q), port_c, 10,
                                                         block=block)
            eq(rd, pd)
            eq(ri, pi)
            noisy = np.where(rng.random((5, 10)) < 0.3, -1, np.asarray(ri)).astype(np.int32)
            np.testing.assert_allclose(float(port_exact.recall(T(noisy), pi)),
                                       float(ref_exact.recall(jnp.asarray(noisy), ri)),
                                       rtol=1e-6)
