"""MACE, higher-order E(3)-equivariant message passing (arXiv:2206.07697),
in a Cartesian basis (port of ``repro.models.gnn.mace``).

For l_max = 2 the irreps have exact Cartesian equivalents: l=0 a scalar,
l=1 a vector, l=2 a traceless symmetric matrix. Each layer builds the ACE
A-basis per node as Cartesian moments of the neighbour density (one
``index_add_`` over the receivers for each of A0 (N, K), A1 (N, K, 3) and
A2 (N, K, 3, 3)), then the B-basis as eight invariant contractions up to
correlation order 3 (A0, A1.A1, tr(A2 A2), A0^2, A1.A2.A1, tr(A2^3), A0^3,
A0 (A1.A1)), contracted pairwise in the order the reference's einsum path
takes, and a linear update of the node state. Messages are weighted by
scalar sender features only, as the reference's.

Parameters are ``nn.Module``s on an explicit device: ``embed`` (species
one-hot or node features -> K), ``layers`` (each ``radial`` MLP n_rbf ->
d_radial_mlp -> 3K with biases, ``mix_a`` K -> K, ``update`` 8K -> K;
stacked as the reference's, ``StackedLayers``) and ``readout`` (K
-> d_readout -> 1 with biases). Products run in ``cfg.compute_dtype``
with the weights cast to it, as the reference's ``x @ w.astype(x.dtype)``.

A self-loop edge's geometry does not depend on the positions, and the
port's forces take that derivative as exactly zero where the reference's
carry cancellation noise (``edge_geometry``); everything else is the
reference's arithmetic.

``energy`` runs each layer under ``torch.utils.checkpoint`` where
``cfg.remat_layers`` is set and autograd records; ``energy_and_forces``
takes the forces as ``-dE/dpositions`` with ``create_graph`` where
autograd records, so a training step differentiates through them a
second time.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.common.device import check_generator, resolve_device
from repro_torch.distributed.layout import flat_specs, stacked
from repro_torch.models.common.modules import MLP, Dense, StackedLayers


@dataclasses.dataclass(frozen=True)
class MACEConfig:
    name: str = "mace"
    n_layers: int = 2
    d_hidden: int = 128  # channels K
    l_max: int = 2
    correlation_order: int = 3
    n_rbf: int = 8
    r_cut: float = 2.5
    d_feat: int = 0  # input node feature dim; 0 -> species embedding
    n_species: int = 32
    d_radial_mlp: int = 64
    d_readout: int = 16
    # Recompute each interaction layer in the backward: the force objective
    # double-backwards through the (N, K, 13) A-basis.
    remat_layers: bool = True
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32

    @property
    def n_invariants(self) -> int:
        return 8


def bessel_rbf(dist, n_rbf: int, r_cut: float):
    """Bessel radial basis with a smooth polynomial cutoff envelope: dist
    (...,) -> (..., n_rbf)."""
    d = torch.clamp_min(dist, 1e-9)[..., None]
    n = torch.arange(1, n_rbf + 1, dtype=torch.float32, device=dist.device)
    basis = math.sqrt(2.0 / r_cut) * torch.sin(n * math.pi * d / r_cut) / d
    x = torch.clamp(dist / r_cut, 0.0, 1.0)
    env = 1.0 - 10.0 * x**3 + 15.0 * x**4 - 6.0 * x**5  # C2-smooth cutoff
    return basis * env[..., None]


def mlp_apply(mlp: MLP, x, act=F.silu):
    """``mlp_apply``: x @ w + b a layer in x's dtype (the weights cast to
    it), ``act`` between layers."""
    n = len(mlp.layers)
    for i, layer in enumerate(mlp.layers):
        x = x @ layer.weight.T.to(x.dtype) + layer.bias.to(x.dtype)
        if i < n - 1:
            x = act(x)
    return x


class MACELayer(nn.Module):
    def __init__(self, cfg: MACEConfig, device):
        super().__init__()
        k = cfg.d_hidden
        self.radial = MLP((cfg.n_rbf, cfg.d_radial_mlp, 3 * k), device=device)
        self.mix_a = Dense(k, k, dtype=cfg.param_dtype, device=device)
        self.update = Dense(cfg.n_invariants * k, k, dtype=cfg.param_dtype, device=device)

    def init_(self, generator: torch.Generator) -> "MACELayer":
        self.radial.init_(generator)
        self.mix_a.init_(generator)
        self.update.init_(generator)
        return self


class MACE(nn.Module):
    """``init_params``' parameters: ``embed``, ``readout`` and ``layers``.
    Built uninitialised; fill it with ``init_params`` or
    ``interop.mace_params_from_reference``."""

    def __init__(self, cfg: MACEConfig, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.embed = Dense(cfg.d_feat or cfg.n_species, cfg.d_hidden, dtype=cfg.param_dtype,
                           device=device)
        self.readout = MLP((cfg.d_hidden, cfg.d_readout, 1), device=device)
        self.layers = StackedLayers(MACELayer(cfg, device) for _ in range(cfg.n_layers))


def init_params(generator: torch.Generator, cfg: MACEConfig, device="cuda") -> MACE:
    """A ``MACE`` on ``device`` with the reference's init laws, drawn from
    ``generator`` in the reference's order: ``embed``, ``readout``, then
    each layer's ``radial``, ``mix_a`` and ``update`` (uniform in +-1 /
    sqrt(fan in), biases zero)."""
    dev = resolve_device(device)
    check_generator(generator, dev)
    model = MACE(cfg, device=dev)
    model.embed.init_(generator)
    model.readout.init_(generator)
    for layer in model.layers:
        layer.init_(generator)
    return model


def param_specs(cfg: MACEConfig, mi) -> dict:
    """The reference's layout of MACE's parameters over ``mi``: every leaf
    whole on every position (the dst-partitioned layout splits the graph,
    not the weights), keyed by the port's names."""
    mlp = {"layers": [{"w": (None, None), "b": (None,)} for _ in range(2)]}
    layer = {"radial": mlp, "mix_a": {"w": (None, None)}, "update": {"w": (None, None)}}
    return flat_specs({"embed": {"w": (None, None)}, "readout": mlp, "layers": stacked(layer)})


def embed_inputs(cfg: MACEConfig, feat):
    """The embedding's input: (N, d_feat) features, or the one-hot of (N,)
    species ids, in the compute dtype."""
    if cfg.d_feat:
        return feat.to(cfg.compute_dtype)
    return F.one_hot(feat.long(), cfg.n_species).to(cfg.compute_dtype)


def node_features(model: MACE, cfg: MACEConfig, feat):
    """(N, d_feat) features or (N,) species ids -> h (N, K) in the compute
    dtype."""
    return model.embed(embed_inputs(cfg, feat))


def edge_geometry(cfg: MACEConfig, pos_recv, pos_send, self_loop, dtype):
    """Receiver and sender positions (E, 3) -> (rbf (E, n_rbf) in ``dtype``,
    rhat (E, 3), y2 = rhat rhat^T - I / 3 (E, 3, 3)).

    A self-loop's (``self_loop``) rvec is zero whatever the positions, and
    so is its derivative. The reference differentiates pos[r] - pos[s]
    there: through rhat = rvec / 1e-9 that adds a term of order 1e9 to the
    node's force and subtracts it again, which leaves rounding noise of
    that order's ulp in the force. The port takes the zero (the same
    forward values) and its forces carry no such noise."""
    rvec = torch.where(self_loop[:, None], 0.0, pos_recv - pos_send)
    dist = torch.linalg.norm(rvec + 1e-12, dim=-1)
    rhat = rvec / torch.clamp_min(dist, 1e-9)[..., None]
    rbf = bessel_rbf(dist, cfg.n_rbf, cfg.r_cut).to(dtype)
    eye = torch.eye(3, dtype=rhat.dtype, device=rhat.device) / 3.0
    return rbf, rhat, rhat[:, :, None] * rhat[:, None, :] - eye


def interaction(lp: MACELayer, cfg: MACEConfig, h_send, rbf, rhat, y2, s, r, valid,
                n_recv: int):
    """One layer's update of the receivers: messages from sender features
    ``h_send`` (rows ``s``) into ``n_recv`` receiver rows ``r`` (edges not
    ``valid`` weigh zero) -> the (n_recv, K) addition to their state."""
    k = cfg.d_hidden
    dtype = h_send.dtype
    rad = mlp_apply(lp.radial, rbf)  # (E, 3K)
    rad = rad * valid[:, None].to(rad.dtype)
    r0, r1, r2 = rad[:, :k], rad[:, k : 2 * k], rad[:, 2 * k :]
    hs = lp.mix_a(h_send[s])  # (E, K) mixed sender scalars
    m0 = r0 * hs
    m1 = (r1 * hs)[:, :, None] * rhat.to(dtype)[:, None, :]  # (E, K, 3)
    m2 = (r2 * hs)[:, :, None, None] * y2.to(dtype)[:, None]  # (E, K, 3, 3)

    def seg(m):
        return torch.zeros((n_recv,) + m.shape[1:], dtype=m.dtype,
                           device=m.device).index_add(0, r, m)

    a0, a1, a2 = seg(m0), seg(m1), seg(m2)  # the ACE A-basis
    i_11 = (a1 * a1).sum(-1)
    i_22 = (a2 * a2).sum((-2, -1))
    # nkij,nki->nkj then nkj,nkj->nk; nkjl,nkij->nkli then nkli,nkli->nk
    i_121 = ((a1[..., :, None] * a2).sum(-2) * a1).sum(-1)
    i_222 = (torch.matmul(a2, a2).transpose(-1, -2) * a2).sum((-2, -1))
    feats = torch.cat([a0, i_11, i_22, a0 * a0, i_121, i_222, a0 * a0 * a0, a0 * i_11],
                      dim=-1)  # (N, 8K)
    return lp.update(feats)


def _layer(lp: MACELayer, cfg: MACEConfig, h, positions, senders, receivers):
    """The reference's ``_layer``: h (N, K) -> h + update(B-basis)."""
    valid = (senders >= 0) & (receivers >= 0)
    s = torch.clamp_min(senders, 0).long()
    r = torch.clamp_min(receivers, 0).long()
    rbf, rhat, y2 = edge_geometry(cfg, positions[r], positions[s], r == s, h.dtype)
    return h + interaction(lp, cfg, h, rbf, rhat, y2, s, r, valid, h.shape[0])


def maybe_remat(on: bool, fn, *args):
    """fn(*args), under a checkpoint where ``on`` and autograd records."""
    if on and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def energy(model: MACE, cfg: MACEConfig, batch: dict):
    """Total energy per graph: (G,) with ``node_graph`` / ``n_graphs`` in
    ``batch``, else (1,). batch: ``positions`` (N, 3), ``senders`` /
    ``receivers`` (E,) (-1 padded), ``species`` or ``node_feat``."""
    h = node_features(model, cfg, batch["node_feat"] if cfg.d_feat else batch["species"])
    positions = batch["positions"].to(cfg.compute_dtype)
    for lp in model.layers:
        h = maybe_remat(cfg.remat_layers, functools.partial(_layer, lp, cfg), h, positions,
                        batch["senders"], batch["receivers"])
    node_e = mlp_apply(model.readout, h)[..., 0]  # (N,)
    if "node_graph" in batch:
        return torch.zeros(batch["n_graphs"], dtype=node_e.dtype, device=node_e.device
                           ).index_add(0, batch["node_graph"].long(), node_e)
    return node_e.sum(0, keepdim=True)


def forces_of(energy_fn, positions):
    """(E = sum(energy_fn(positions)), -dE/dpositions); the gradient's graph
    is kept where autograd records, for a second backward."""
    graph = torch.is_grad_enabled()
    with torch.enable_grad():
        pos = positions.detach().requires_grad_(True)
        e = energy_fn(pos).sum()
        (g,) = torch.autograd.grad(e, pos, create_graph=graph)
    return (e if graph else e.detach()), -g


def energy_and_forces(model: MACE, cfg: MACEConfig, batch: dict):
    return forces_of(lambda pos: energy(model, cfg, dict(batch, positions=pos)),
                     batch["positions"])


def objective(e, f, batch: dict):
    """Energy + force MSE -> (total, {"loss", "e_loss", "f_loss"})."""
    e_target = batch["energy"].sum() if "energy" in batch else torch.zeros((), device=e.device)
    f_target = batch["forces"] if "forces" in batch else torch.zeros_like(f)
    e_loss = (e - e_target) ** 2 / max(batch["positions"].shape[0], 1)
    f_loss = ((f - f_target) ** 2).sum(-1).mean()
    total = e_loss + f_loss
    return total, {"loss": total, "e_loss": e_loss, "f_loss": f_loss}


def loss(model: MACE, cfg: MACEConfig, batch: dict):
    """Energy + force MSE (the standard MACE objective)."""
    e, f = energy_and_forces(model, cfg, batch)
    return objective(e, f, batch)
