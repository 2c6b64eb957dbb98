"""Slot-pool corpus: fixed-capacity mutable storage (port of
``repro.streaming.slots``).

The pool pre-allocates ``capacity`` slots and mutates rows in place:

  * a slot is LIVE (searchable and returnable), PENDING (deleted by
    tombstone, still wired into the graph as a routing node until
    consolidation) or FREE (on the free list, referenced by no edge);
  * the tombstone bitmap marks everything non-returnable (PENDING and
    FREE); the traversal masks it exactly like a failed constraint;
  * accounting: ``n_live + n_pending + n_free == capacity`` and
    ``popcount(tombstones) == n_pending + n_free``.

Where the state lives. The rows a search reads stay on the device and are
written in place: vectors, labels, attributes and the adjacency. The
lifecycle state stays on the host: the tombstone bitmap (uint32 words, as
the reference keeps them), the free and pending lists, the numpy
``RandomState``, the histograms and postings. The host also keeps a copy
of the label and attribute columns, written by the same call as the
device's (``SlotPool.write_row``), so the histograms, postings and range
index never wait on the device.

``StreamingIndex`` publishes immutable epoch-versioned ``IndexSnapshot``s:
publishing clones the device arrays (a device-to-device copy, ~1 GB at
capacity 1.5M and d = 128) and uploads the bitmap and the sample, so a
snapshot never changes under later mutations.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from repro_torch.common.bits import WORD_BITS, tail_bits
from repro_torch.common.device import resolve_device
from repro_torch.core.histogram import AttributeHistograms
from repro_torch.core.posting import PostingLists, RangeIndex
from repro_torch.core.types import Corpus, GraphIndex

PAD = -1


def _host(a, dtype) -> np.ndarray:
    """A tensor or array as a numpy array of ``dtype`` (a copy)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.array(a, dtype=dtype)


class SlotPool:
    """Fixed-capacity row storage with a LIFO free list + tombstone bitmap.

    ``vectors`` (capacity, d) float32, ``labels_dev`` (capacity,) int32 and
    ``attrs_dev`` (capacity, a) float32 live on ``device``; ``labels``,
    ``attrs`` and ``tombstones`` (uint32 words) are host numpy arrays.
    """

    def __init__(self, vectors, labels, attrs, capacity: int, device="cuda"):
        dev = resolve_device(device)
        vectors = torch.as_tensor(vectors)
        n0, d = vectors.shape
        if capacity < n0:
            raise ValueError(f"capacity {capacity} < initial corpus size {n0}")
        self.capacity = int(capacity)
        self.device = dev
        self.vectors = torch.zeros((capacity, d), dtype=torch.float32, device=dev)
        self.vectors[:n0] = vectors.to(device=dev, dtype=torch.float32)
        self.labels = np.zeros((capacity,), np.int32)
        self.labels[:n0] = _host(labels, np.int32)
        self.labels_dev = torch.from_numpy(self.labels).to(dev, copy=True)
        self.attrs: Optional[np.ndarray] = None
        self.attrs_dev: Optional[torch.Tensor] = None
        if attrs is not None:
            attrs = _host(attrs, np.float32)
            self.attrs = np.zeros((capacity, attrs.shape[1]), np.float32)
            self.attrs[:n0] = attrs
            self.attrs_dev = torch.from_numpy(self.attrs).to(dev, copy=True)
        # Slots [n0, capacity) start FREE: tombstoned (non-returnable) and
        # unreferenced until an insert claims them.
        self.tombstones = tail_bits(n0, capacity)
        self.free: List[int] = list(range(capacity - 1, n0 - 1, -1))  # LIFO
        self.pending: List[int] = []
        self.n_live = n0

    # --- rows ------------------------------------------------------------
    def write_row(self, slot: int, vector: torch.Tensor, label: int, attrs=None) -> None:
        """Write one slot's vector, label and attributes (device and host)."""
        self.vectors[slot] = vector.to(device=self.device, dtype=torch.float32)
        self.labels[slot] = np.int32(label)
        self.labels_dev[slot] = int(label)
        if self.attrs is not None:
            self.attrs[slot] = 0.0 if attrs is None else _host(attrs, np.float32)
            self.attrs_dev[slot] = torch.from_numpy(self.attrs[slot]).to(self.device)

    # --- bitmap ----------------------------------------------------------
    def _set_dead(self, slot: int) -> None:
        self.tombstones[slot // WORD_BITS] |= np.uint32(1) << np.uint32(slot % WORD_BITS)

    def _set_alive(self, slot: int) -> None:
        self.tombstones[slot // WORD_BITS] &= ~(np.uint32(1) << np.uint32(slot % WORD_BITS))

    def is_live(self, slot: int) -> bool:
        word = self.tombstones[slot // WORD_BITS]
        return not bool((word >> np.uint32(slot % WORD_BITS)) & np.uint32(1))

    def live_mask(self) -> np.ndarray:
        """(capacity,) bool: LIVE slots (tombstone bit clear)."""
        bits = np.unpackbits(self.tombstones.view(np.uint8), bitorder="little")[: self.capacity]
        return bits == 0

    def live_ids(self) -> np.ndarray:
        return np.nonzero(self.live_mask())[0].astype(np.int32)

    # --- lifecycle -------------------------------------------------------
    @property
    def n_free(self) -> int:
        return len(self.free)

    @property
    def n_pending(self) -> int:
        return len(self.pending)

    def alloc(self) -> int:
        """Claim a FREE slot (still tombstoned until ``commit``)."""
        if not self.free:
            raise RuntimeError(
                "slot pool exhausted: consolidate pending tombstones or grow capacity"
            )
        return self.free.pop()

    def commit(self, slot: int) -> None:
        """FREE -> LIVE after the caller wrote the slot's rows + edges."""
        self._set_alive(slot)
        self.n_live += 1

    def release(self, slot: int) -> bool:
        """LIVE -> PENDING (tombstoned; edges stay until consolidation)."""
        if not self.is_live(slot):
            return False
        self._set_dead(slot)
        self.pending.append(slot)
        self.n_live -= 1
        return True

    def reclaim(self, slot: int) -> None:
        """PENDING -> FREE once consolidation has unhooked every in-edge."""
        self.pending.remove(slot)
        self.free.append(slot)

    def stats(self) -> dict:
        """Occupancy gauges; the states always partition the capacity."""
        return {
            "capacity": self.capacity,
            "live": self.n_live,
            "pending": self.n_pending,
            "free": self.n_free,
        }

    def check_accounting(self) -> None:
        """Raise if the slot-state partition or the bitmap drifted."""
        total = self.n_live + self.n_pending + self.n_free
        if total != self.capacity:
            raise AssertionError(
                f"slot accounting broken: live {self.n_live} + pending "
                f"{self.n_pending} + free {self.n_free} != {self.capacity}"
            )
        dead_bits = int((~self.live_mask()).sum())
        if dead_bits != self.n_pending + self.n_free:
            raise AssertionError(
                f"tombstone popcount {dead_bits} != pending+free "
                f"{self.n_pending + self.n_free}"
            )


@dataclass(frozen=True)
class IndexSnapshot:
    """One immutable epoch of the mutable index (tensors it owns)."""

    epoch: int
    corpus: Corpus  # tombstones set: every search masks dead slots
    graph: GraphIndex


class StreamingIndex:
    """Mutable proximity-graph index over a slot pool.

    Mutations (``insert`` / ``delete`` / ``consolidate``, in mutate.py and
    consolidate.py) write the pool and the device adjacency in place and
    mark the index dirty; ``snapshot()`` publishes the next epoch on
    demand. Every mutation keeps graph/build.py's adjacency invariants
    (rows distance-ascending, self-free, duplicate-free, -1 padded).
    """

    def __init__(self, pool: SlotPool, neighbors, sample_ids, entry_point: int, *,
                 ef_insert: int = 32, seed: int = 0):
        self.pool = pool
        neighbors = torch.as_tensor(neighbors)
        cap, deg = pool.capacity, neighbors.shape[1]
        self.neighbors = torch.full((cap, deg), PAD, dtype=torch.int32, device=pool.device)
        self.neighbors[: neighbors.shape[0]] = neighbors.to(device=pool.device,
                                                            dtype=torch.int32)
        self.sample_ids = _host(sample_ids, np.int32)
        self.entry_point = int(entry_point)
        self.ef_insert = int(ef_insert)
        self.rng = np.random.RandomState(seed)
        self.epoch = 0
        self._dirty = True
        self._snap: Optional[IndexSnapshot] = None
        self.consolidations = 0
        # Hybrid-routing stats: label / range histograms and posting lists,
        # kept by insert / delete (+-1 a mutation; consolidation moves
        # PENDING -> FREE and never changes live membership), exact at
        # every publication. The range index re-sorts lazily per epoch.
        live = pool.live_mask()
        self.histograms = AttributeHistograms.from_arrays(pool.labels, pool.attrs, live)
        self.postings = PostingLists.from_arrays(pool.labels, live)
        self.range_index = RangeIndex()

    @classmethod
    def from_static(cls, corpus: Corpus, graph: GraphIndex, *, capacity: Optional[int] = None,
                    ef_insert: int = 32, seed: int = 0, device="cuda") -> "StreamingIndex":
        """Pool-ify a built (corpus, graph) on ``device``: pad every array to
        ``capacity`` (default n + max(64, n // 2)) and start the free list
        after them."""
        n0 = corpus.n
        cap = int(capacity) if capacity is not None else n0 + max(64, n0 // 2)
        pool = SlotPool(corpus.vectors, corpus.labels, corpus.attrs, cap, device=device)
        return cls(pool, graph.neighbors, graph.sample_ids, int(graph.entry_point),
                   ef_insert=ef_insert, seed=seed)

    # --- geometry --------------------------------------------------------
    @property
    def dim(self) -> int:
        return self.pool.vectors.shape[1]

    @property
    def degree(self) -> int:
        return self.neighbors.shape[1]

    @property
    def capacity(self) -> int:
        return self.pool.capacity

    @property
    def device(self) -> torch.device:
        return self.pool.device

    def mark_dirty(self) -> None:
        self._dirty = True

    # --- hybrid-routing stats maintenance ---------------------------------
    def _attrs_row(self, slot: int):
        return None if self.pool.attrs is None else self.pool.attrs[slot]

    def on_slot_committed(self, slot: int) -> None:
        """FREE -> LIVE bookkeeping: histograms + postings gain the slot."""
        label = int(self.pool.labels[slot])
        self.histograms.on_insert(label, self._attrs_row(slot))
        self.postings.on_insert(label, slot)

    def on_slot_released(self, slot: int) -> None:
        """LIVE -> PENDING bookkeeping: histograms + postings drop the slot."""
        label = int(self.pool.labels[slot])
        self.histograms.on_delete(label, self._attrs_row(slot))
        self.postings.on_delete(label, slot)

    def range_postings(self, lo: float, hi: float, col: int) -> np.ndarray:
        """Sorted LIVE ids with attrs[:, col] in [lo, hi]: the range family's
        posting set (lazy per-epoch re-sort, then binary search)."""
        if self.pool.attrs is None:
            return np.empty((0,), np.int32)
        self.range_index.refresh(self.pool.attrs, self.pool.live_mask(), self.epoch)
        return self.range_index.ids_for_range(lo, hi, col)

    def check_stats_exact(self) -> None:
        """Raise if the incremental histograms / postings drifted from the
        pool's ground truth."""
        live = self.pool.live_mask()
        self.histograms.check_exact(self.pool.labels, live)
        truth_ids = np.nonzero(live)[0]
        truth_labels = self.pool.labels[truth_ids]
        order = np.argsort(truth_labels, kind="stable")
        labs, ids = truth_labels[order], truth_ids[order]
        cuts = np.flatnonzero(np.diff(labs)) + 1
        for lab, run in zip(labs[np.r_[0, cuts]] if labs.size else [], np.split(ids, cuts)):
            if not np.array_equal(self.postings.ids_for_label(int(lab)), run):
                raise AssertionError(f"posting list drifted for label {int(lab)}")
        total = sum(self.postings.count_label(lab) for lab in range(len(self.postings._sets)))
        if total != truth_ids.shape[0]:
            raise AssertionError("phantom postings outside live label space")

    # --- epoch publication ------------------------------------------------
    def snapshot(self) -> IndexSnapshot:
        """Publish (or reuse) the current epoch's immutable view."""
        if self._snap is None or self._dirty:
            self.epoch += 1
            # The incremental stats must agree with the pool's live count
            # at every publication (full check: ``check_stats_exact``).
            if self.histograms.n_live != self.pool.n_live:
                raise AssertionError(
                    f"histogram n_live {self.histograms.n_live} drifted from "
                    f"pool n_live {self.pool.n_live} at epoch {self.epoch}"
                )
            dev = self.device
            pool = self.pool
            corpus = Corpus(
                vectors=pool.vectors.clone(),
                labels=pool.labels_dev.clone(),
                attrs=None if pool.attrs_dev is None else pool.attrs_dev.clone(),
                tombstones=torch.from_numpy(pool.tombstones.view(np.int32)).to(dev, copy=True),
            )
            graph = GraphIndex(
                neighbors=self.neighbors.clone(),
                sample_ids=torch.from_numpy(self.sample_ids).to(dev, copy=True),
                entry_point=torch.tensor(self.entry_point, dtype=torch.int32, device=dev),
            )
            self._snap = IndexSnapshot(epoch=self.epoch, corpus=corpus, graph=graph)
            self._dirty = False
        return self._snap

    # --- mutations (mutate.py / consolidate.py) ----------------------------
    def insert(self, vector, label=0, attrs=None) -> int:
        from repro_torch.streaming.mutate import insert_one

        return insert_one(self, vector, label, attrs)

    def delete(self, slot: int) -> bool:
        """Tombstone one live slot; its edges stay until consolidation."""
        ok = self.pool.release(int(slot))
        if ok:
            self.on_slot_released(int(slot))
            self.mark_dirty()
        return ok

    def consolidate(self, max_slots: Optional[int] = None) -> int:
        from repro_torch.streaming.consolidate import consolidate

        return consolidate(self, max_slots=max_slots)
