"""Incremental attribute histograms for O(1) selectivity estimates (port
of ``repro.core.histogram``, numpy only, kept as the port's own copy).

The hybrid strategy router (core/router.py) must not pay the O(n)
``scan_selectivity`` per request — it needs a host-side estimate in
microseconds. These histograms are maintained *incrementally* by the
streaming layer: every ``insert``/``delete`` updates the counts by ±1
(consolidation moves PENDING→FREE slots and therefore never changes live
membership), so the histograms are EXACT for the label family at every
snapshot publication — not a sketch. Range estimates are exact only up to
within-bin interpolation (equi-width bins, edges frozen at construction).

Host-side numpy throughout — estimates never touch the device.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

WORD_BITS = 32
N_RANGE_BINS = 64


class AttributeHistograms:
    """Live-set label counts + per-column equi-width range histograms.

    ``label_counts[l]`` is the number of LIVE corpus rows with label ``l``;
    ``n_live`` the LIVE total. Range histograms bin each attribute column
    into ``n_bins`` equi-width cells between the edges observed at
    construction (out-of-range values clamp into the end bins, keeping
    counts exact even as streaming inserts drift past the initial extent —
    only the *interpolation* inside the end bins degrades).
    """

    def __init__(
        self,
        n_labels: int,
        n_attr_cols: int = 0,
        attr_edges: Optional[np.ndarray] = None,
        n_bins: int = N_RANGE_BINS,
    ):
        self.label_counts = np.zeros((max(int(n_labels), 1),), np.int64)
        self.n_live = 0
        self.n_bins = int(n_bins)
        self.n_attr_cols = int(n_attr_cols)
        if n_attr_cols > 0:
            if attr_edges is None:
                attr_edges = np.stack(
                    [np.zeros(n_attr_cols), np.ones(n_attr_cols)], axis=-1
                )
            self.attr_edges = np.asarray(attr_edges, np.float64)  # (C, 2)
            self.range_counts = np.zeros((n_attr_cols, self.n_bins), np.int64)
        else:
            self.attr_edges = None
            self.range_counts = None

    # --- construction -----------------------------------------------------
    @classmethod
    def from_arrays(
        cls,
        labels: np.ndarray,
        attrs: Optional[np.ndarray],
        live_mask: Optional[np.ndarray] = None,
        n_labels: Optional[int] = None,
        n_bins: int = N_RANGE_BINS,
    ) -> "AttributeHistograms":
        """Exact histograms over the LIVE rows of host arrays.

        ``live_mask`` (n,) bool selects live rows (None = all live);
        edges for the range histograms come from the live attrs' extent.
        """
        labels = np.asarray(labels)
        if live_mask is not None:
            live_mask = np.asarray(live_mask, bool)
            labels_live = labels[live_mask]
        else:
            labels_live = labels
        nl = int(n_labels) if n_labels is not None else (
            int(labels_live.max()) + 1 if labels_live.size else 1
        )
        cols = 0 if attrs is None else int(np.asarray(attrs).shape[1])
        edges = None
        attrs_live = None
        if cols:
            attrs_np = np.asarray(attrs, np.float64)
            attrs_live = attrs_np[live_mask] if live_mask is not None else attrs_np
            if attrs_live.shape[0]:
                lo = attrs_live.min(axis=0)
                hi = attrs_live.max(axis=0)
            else:
                lo, hi = np.zeros(cols), np.ones(cols)
            hi = np.where(hi > lo, hi, lo + 1.0)  # degenerate column guard
            edges = np.stack([lo, hi], axis=-1)
        h = cls(nl, cols, attr_edges=edges, n_bins=n_bins)
        if labels_live.size:
            counts = np.bincount(labels_live.astype(np.int64), minlength=nl)
            h.label_counts[: counts.shape[0]] = counts
        h.n_live = int(labels_live.shape[0])
        if cols and attrs_live is not None and attrs_live.shape[0]:
            for c in range(cols):
                bins = h._bin_of(c, attrs_live[:, c])
                h.range_counts[c] = np.bincount(bins, minlength=h.n_bins)
        return h

    @classmethod
    def from_corpus(cls, corpus, n_labels: Optional[int] = None,
                    n_bins: int = N_RANGE_BINS) -> "AttributeHistograms":
        """Exact histograms from a (possibly tombstoned) Corpus of tensors."""
        labels = corpus.labels.cpu().numpy()
        attrs = None if corpus.attrs is None else corpus.attrs.cpu().numpy()
        live = None
        if corpus.tombstones is not None:
            words = corpus.tombstones.cpu().numpy()
            bits = np.unpackbits(words.view(np.uint8), bitorder="little")
            live = bits[: labels.shape[0]] == 0
        return cls.from_arrays(labels, attrs, live, n_labels, n_bins)

    # --- incremental maintenance (streaming layer) -------------------------
    def _grow_labels(self, label: int) -> None:
        if label >= self.label_counts.shape[0]:
            grown = np.zeros((label + 1,), np.int64)
            grown[: self.label_counts.shape[0]] = self.label_counts
            self.label_counts = grown

    def _bin_of(self, col: int, val) -> np.ndarray:
        lo, hi = self.attr_edges[col]
        x = (np.asarray(val, np.float64) - lo) / (hi - lo)
        b = np.floor(x * self.n_bins).astype(np.int64)
        return np.clip(b, 0, self.n_bins - 1)  # out-of-range → end bins

    def on_insert(self, label: int, attrs_row: Optional[np.ndarray] = None) -> None:
        label = int(label)
        self._grow_labels(label)
        self.label_counts[label] += 1
        self.n_live += 1
        if self.range_counts is not None and attrs_row is not None:
            for c in range(self.n_attr_cols):
                self.range_counts[c, int(self._bin_of(c, attrs_row[c]))] += 1

    def on_delete(self, label: int, attrs_row: Optional[np.ndarray] = None) -> None:
        label = int(label)
        self._grow_labels(label)
        self.label_counts[label] -= 1
        self.n_live -= 1
        if self.range_counts is not None and attrs_row is not None:
            for c in range(self.n_attr_cols):
                self.range_counts[c, int(self._bin_of(c, attrs_row[c]))] -= 1

    # --- estimates ---------------------------------------------------------
    def estimate(self, family: str, operand) -> Optional[float]:
        """Estimated satisfied fraction of the LIVE set, or None when this
        histogram cannot cover the family (UDF, missing attrs).

        family "label": operand is the (Lw,) uint32 allowed-label bitmask
        row (serving wire format) — EXACT: sums the counts of set bits.
        family "range": operand is (lo, hi, col) — exact across fully
        covered bins, linear interpolation in the two partial end bins.
        """
        if self.n_live <= 0:
            return 0.0
        if family == "label":
            words = np.asarray(operand, np.uint32).reshape(-1)
            total = 0
            nl = self.label_counts.shape[0]
            for w, word in enumerate(words):
                word = int(word)
                while word:
                    bit = (word & -word).bit_length() - 1
                    lab = w * WORD_BITS + bit
                    if lab < nl:
                        total += int(self.label_counts[lab])
                    word &= word - 1
            return total / self.n_live
        if family == "range":
            if self.range_counts is None:
                return None
            lo, hi, col = float(operand[0]), float(operand[1]), int(operand[2])
            if col >= self.n_attr_cols or hi < lo:
                return 0.0 if hi < lo else None
            e_lo, e_hi = self.attr_edges[col]
            width = (e_hi - e_lo) / self.n_bins
            # fractional bin coordinates, clamped to the binned extent
            a = np.clip((lo - e_lo) / width, 0.0, self.n_bins)
            b = np.clip((hi - e_lo) / width, 0.0, self.n_bins)
            # b == n_bins (hi at/past the extent) folds into the last bin
            # with a full-coverage weight of 1.
            ia = min(int(np.floor(a)), self.n_bins - 1)
            ib = min(int(np.floor(b)), self.n_bins - 1)
            counts = self.range_counts[col]
            if ia == ib:
                total = float(counts[ia]) * max(b - a, 0.0)
            else:
                total = float(counts[ia]) * (ia + 1 - a)
                total += float(counts[ia + 1: ib].sum())
                total += float(counts[ib]) * (b - ib)
            return min(total / self.n_live, 1.0)
        return None

    # --- exactness check (tests / snapshot publication) --------------------
    def check_exact(self, labels: np.ndarray, live_mask: np.ndarray) -> None:
        """Raise if the incremental label counts drifted from ground truth."""
        labels = np.asarray(labels)
        live_mask = np.asarray(live_mask, bool)
        truth = np.bincount(
            labels[live_mask].astype(np.int64),
            minlength=self.label_counts.shape[0],
        )
        if int(live_mask.sum()) != self.n_live:
            raise AssertionError(
                f"histogram n_live {self.n_live} != ground truth "
                f"{int(live_mask.sum())}"
            )
        mine = self.label_counts
        if truth.shape[0] > mine.shape[0]:
            raise AssertionError("histogram label space narrower than corpus")
        if not np.array_equal(mine[: truth.shape[0]], truth):
            bad = np.nonzero(mine[: truth.shape[0]] != truth)[0][:8]
            raise AssertionError(f"label counts drifted at labels {bad.tolist()}")
        if mine[truth.shape[0]:].any():
            raise AssertionError("phantom counts beyond corpus label space")
