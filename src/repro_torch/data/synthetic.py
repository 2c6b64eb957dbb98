"""Synthetic corpora after the paper's data protocol (§3, 'Data'); port of
``repro.data.synthetic``.

Cluster-structured vectors, k-means labels (k = 10 for SIFT1M), optional R%
label randomisation, and queries near random corpus points with inherited
labels. Draws come from a ``torch.Generator`` on the target device, so the
numbers differ from the reference's threefry draws: the parity is
statistical.
"""
from __future__ import annotations

import torch

from repro_torch.common.device import check_generator, resolve_device
from repro_torch.common.distances import squared_l2
from repro_torch.common.kmeans import kmeans
from repro_torch.core.types import Corpus


def clustered_vectors(generator: torch.Generator, n: int, d: int, n_clusters: int, *,
                      spread: float = 0.15, anisotropic: bool = False, device="cuda"):
    """Gaussian blobs around unit-sphere centres -> (vectors (n, d), true (n,))."""
    dev = resolve_device(device)
    check_generator(generator, dev)
    centers = torch.randn((n_clusters, d), generator=generator, device=dev)
    centers = centers / centers.norm(dim=-1, keepdim=True)
    assign = torch.randint(0, n_clusters, (n,), generator=generator, dtype=torch.int32,
                           device=dev)
    noise = torch.randn((n, d), generator=generator, device=dev) * spread
    if anisotropic:
        scales = torch.rand((n_clusters, d), generator=generator, device=dev) * 1.4 + 0.3
        noise = noise * scales[assign.long()]
    return centers[assign.long()] + noise, assign


def kmeans_labels(generator: torch.Generator, vectors, k: int, sample: int = 100_000,
                  iters: int = 15):
    """Paper labelling: k-means fit on a subsample, label = nearest centroid."""
    n = vectors.shape[0]
    fit = vectors
    if n > sample:
        fit = vectors[torch.randperm(n, generator=generator, device=vectors.device)[:sample]]
    cent, _ = kmeans(generator, fit, k, iters)
    return squared_l2(vectors, cent).argmin(-1).to(torch.int32)


def randomize_labels(generator: torch.Generator, labels, n_labels: int, pct_random: float):
    """R% randomness (paper §3): with probability R%, a uniform label."""
    if pct_random <= 0:
        return labels
    coin = torch.rand(labels.shape, generator=generator, device=labels.device) < (
        pct_random / 100.0)
    rand = torch.randint(0, n_labels, labels.shape, generator=generator, dtype=labels.dtype,
                         device=labels.device)
    return torch.where(coin, rand, labels)


def make_labeled_corpus(generator: torch.Generator, n: int, d: int, n_labels: int, *,
                        pct_random: float = 0.0, spread: float = 0.15,
                        anisotropic: bool = False, use_kmeans_labels: bool = True,
                        device="cuda") -> Corpus:
    """End-to-end §3 protocol: clustered vectors -> k-means labels -> R%."""
    vecs, true = clustered_vectors(generator, n, d, n_labels, spread=spread,
                                   anisotropic=anisotropic, device=device)
    labels = kmeans_labels(generator, vecs, n_labels) if use_kmeans_labels else true
    labels = randomize_labels(generator, labels, n_labels, pct_random)
    return Corpus(vectors=vecs.contiguous(), labels=labels.contiguous())


def make_queries(generator: torch.Generator, corpus: Corpus, n_queries: int, *,
                 jitter: float = 0.05):
    """Queries near random corpus points; labels inherited (paper: 'the label
    of the query vector is generated in the same fashion')."""
    dev = corpus.vectors.device
    check_generator(generator, dev)
    idx = torch.randperm(corpus.n, generator=generator, device=dev)[:n_queries]
    noise = torch.randn((n_queries, corpus.dim), generator=generator, device=dev) * jitter
    return (corpus.vectors[idx] + noise).contiguous(), corpus.labels[idx].contiguous()
