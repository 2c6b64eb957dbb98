"""The port's sorted-run merge on subnormal distances, on the card.

``sort_run`` + ``queue_merge_sorted`` must equal ``queue_push`` bit for bit
on any batch, subnormal distances included (the reference's own merge
flushes them; tests/test_torch_queue_subnormal.py holds the port to the
reference's ``queue_push`` on the CPU at these cases). Here the card's merge
and push must equal each other and the CPU's, bit for bit.

Marked ``cuda``; skips where there is no CUDA device. JAX-free:

    python -m pytest -m cuda tests/test_torch_cuda*.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import queue as pq

TINY = float(np.float32(1.4e-45))  # the least subnormal float32
# (cap, live distances, new distances, new valid)
SUBNORMAL_CASES = {
    "counterexample": (2, [TINY], [0.0], [False]),
    "subnormal_ties": (4, [TINY, 3e-39], [TINY, 0.0, 2e-40, 3e-39], [True, True, True, True]),
    "invalid_and_overflow": (3, [], [5e-41, TINY, 5e-41, 1.0, 0.0],
                             [True, False, True, True, True]),
    "full_queue": (3, [0.0, TINY, 2e-44], [TINY, 0.0, 1e-44], [True, True, False]),
}


def merge_and_push(case, device="cpu"):
    """The port's (merge of the sorted run, push) on ``device``: each a
    (dists, ids) pair of numpy arrays."""
    cap, live, new, valid = case
    q = pq.queue_init(1, cap, device=device)
    if live:
        q = pq.queue_push(q, torch.tensor([live], dtype=torch.float32, device=device),
                          torch.arange(len(live), dtype=torch.int32, device=device)[None],
                          torch.ones((1, len(live)), dtype=torch.bool, device=device))
    nd = torch.tensor([new], dtype=torch.float32, device=device)
    ni = torch.arange(100, 100 + len(new), dtype=torch.int32, device=device)[None]
    nv = torch.tensor([valid], dtype=torch.bool, device=device)
    merged = pq.queue_merge_sorted(q, *pq.sort_run(nd, ni, nv))
    pushed = pq.queue_push(q, nd, ni, nv)
    return ((merged.dists.cpu().numpy(), merged.ids.cpu().numpy()),
            (pushed.dists.cpu().numpy(), pushed.ids.cpu().numpy()))


def assert_same_bits(got, want):
    np.testing.assert_array_equal(got[0].view(np.int32), want[0].view(np.int32))
    np.testing.assert_array_equal(got[1], want[1])


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: these tests hold the card's results")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SUBNORMAL_CASES))
def test_merge_equals_push_on_subnormals_on_the_card(dev, name):
    merged, pushed = merge_and_push(SUBNORMAL_CASES[name], device=dev)
    _, cpu_pushed = merge_and_push(SUBNORMAL_CASES[name])
    assert_same_bits(merged, pushed)
    assert_same_bits(pushed, cpu_pushed)
    d = pushed[0]
    assert np.any((d > 0) & (d < np.finfo(np.float32).tiny)), "no subnormal kept"
