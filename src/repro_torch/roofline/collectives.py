"""Collective-byte accounting (port of ``repro.roofline.collectives``).

The reference parses the compiled HLO for its collective ops. The port
compiles nothing: one controller drives every mesh position, and a
collective is a move of each position's part to another device followed by
a reduction or a join there. So the port counts its own moves instead. Each
cross-position move reports itself to every open ``tally``; outside a tally
a report costs one list check.

The record is the reference's dict: ``per_op_bytes``, ``per_op_counts`` and
``total_bytes``, under the reference's five kinds. A move is counted by its
result's bytes at one position, the reference's measure: the gathered
output of an all-gather, the payload of an all-reduce. A move that the
controller repeats for each data group (the groups the reference runs at
once) is counted once, by the first group: the loops over groups open
``group(g)``, and a report inside a group past the first is dropped.

The hooks and their kinds:

  * ``core/distributed.py``, the merge: each shard's (B, P, K) distances
    and ids gathered on the group's first device (all-gather, 2 ops);
  * ``core/distributed.py::_combine_stats``: the stats summed or maxed over
    the shards (all-reduce, one op a field);
  * ``distributed/meshinfo.py::sum_in_order``: the ``psum`` of a mesh axis
    (all-reduce): a table read's row blocks, the MoE's gate sums and
    outputs, a graph shard's energies, the int8 compressed mean;
  * ``distributed/layout.py::gather``: a leaf made whole from its blocks
    (all-gather, a weight move);
  * ``models/recsys/models.py::mesh_lookup``: the join of a field's
    column blocks (all-gather);
  * ``distributed/tensor_parallel.py``: a resident leaf that the data
    axes split gathered for each model shard (all-gather, one op a leaf and
    shard, the gathered block), and its gradient's slices summed back onto
    the blocks by the backward (reduce-scatter, one op a leaf and shard,
    one block), both also counted as weight moves
    (``Tally.weight_counts``); a row-parallel product's partials summed
    over the model positions (all-reduce, one op) and, in the backward,
    the gradients of the sum placed on each model position summed again
    (all-reduce, one op); an activation's blocks joined over them
    (all-gather, one op) and, in the backward, each block's gradients
    summed back onto it (reduce-scatter, one op); none over a model axis
    of one position;
  * ``models/transformer/model.py``: the vocabulary-parallel
    cross-entropy's max, sum of exponentials and label logit over the
    model positions (all-reduce, 3 ops a chunk), and the data groups'
    loss sums (all-reduce, one op each);
  * ``models/transformer/attention.py::_lse_combine``: the sequence
    shards' max, sum and output (all-reduce, 3 ops);
  * ``models/gnn/distributed.py``: each layer's node features gathered
    from the graph shards (all-gather).

Autograd carries the gradients back through the same moves; those
backward moves are not reported (no hook sees them), where the reference's
HLO holds its backward collectives too, but for the experts'
reduce-scatter, whose backward reports to the tallies its forward saw.

The reference's HLO pass reads only the first shape of a tuple-shaped
collective, so where XLA combines several reductions into one op it counts
one op of the first operand's bytes. The port counts every reduced tensor
as an op of its own bytes.
"""
from __future__ import annotations

import contextlib
import threading
from collections import defaultdict
from typing import Iterator

import torch

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")

# The hooks sit deep in the model code, so the open tallies and the data
# group are found here rather than passed down; they are per thread, so a
# tally sees only the moves of the thread that opened it.
_local = threading.local()


def _open() -> list:
    if not hasattr(_local, "tallies"):
        _local.tallies, _local.group = [], 0
    return _local.tallies


class Tally:
    """The collectives reported while it is open (``with tally() as t``)."""

    def __init__(self):
        self.per_op_bytes: dict = defaultdict(int)
        self.per_op_counts: dict = defaultdict(int)
        self.weight_counts: dict = defaultdict(int)  # the moves of parameters, by kind
        self.weight_bytes: dict = defaultdict(int)

    def __enter__(self) -> "Tally":
        _open().append(self)
        return self

    def __exit__(self, *exc) -> None:
        _open().remove(self)

    def result(self) -> dict:
        return {"per_op_bytes": dict(self.per_op_bytes),
                "per_op_counts": dict(self.per_op_counts),
                "total_bytes": sum(self.per_op_bytes.values())}


def tally() -> Tally:
    return Tally()


@contextlib.contextmanager
def group(g: int) -> Iterator[None]:
    """Run the body as data group ``g``: only group 0's reports count."""
    _open()
    prev, _local.group = _local.group, g
    try:
        yield
    finally:
        _local.group = prev


def open_tallies() -> tuple:
    """The tallies a report made here would reach (none inside a data group
    past the first): a backward pass, which autograd may run on a thread of
    its own, reports its moves to the tallies its forward saw
    (``record_into``)."""
    tallies = _open()
    return () if _local.group else tuple(tallies)


def record(kind: str, *tensors: torch.Tensor, weights: bool = False) -> None:
    """One op of ``kind`` for each of ``tensors``, each the op's result at
    one position."""
    record_into(open_tallies(), kind, *tensors, weights=weights)


def record_into(tallies, kind: str, *tensors: torch.Tensor, weights: bool = False) -> None:
    """``record`` into the given tallies; ``weights``: the op moves a
    parameter's blocks (also counted in ``Tally.weight_counts`` and
    ``weight_bytes``)."""
    if kind not in KINDS:
        raise ValueError(f"unknown collective {kind!r}")
    for t in tallies:
        for x in tensors:
            t.per_op_bytes[kind] += x.numel() * x.element_size()
            t.per_op_counts[kind] += 1
            if weights:
                t.weight_counts[kind] += 1
                t.weight_bytes[kind] += x.numel() * x.element_size()
