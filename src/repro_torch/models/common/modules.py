"""Shared building blocks (port of ``repro.models.common.modules``).

``MLP`` is the reference's ``mlp_init`` / ``mlp_apply`` pair as an
``nn.Module``: ``nn.Linear`` layers with a ReLU between them and, with
``final_act``, after the last. ``init_`` draws the reference's
``dense_init`` law from an explicit generator: weights uniform in
[-1/sqrt(d_in), 1/sqrt(d_in)], biases zero. The numbers differ from the
reference's threefry draws; ``interop.two_tower_params_from_reference``
carries the reference's own weights across.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from repro_torch.common.device import resolve_device


class MLP(nn.Module):
    def __init__(self, dims: Sequence[int], *, final_act: bool = False, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        # skip_init: no draw from torch's global generator; init_ fills them.
        self.layers = nn.ModuleList(
            nn.utils.skip_init(nn.Linear, a, b, device=device)
            for a, b in zip(dims[:-1], dims[1:]))
        self.final_act = final_act

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> "MLP":
        for layer in self.layers:
            scale = 1.0 / math.sqrt(layer.in_features)
            layer.weight.uniform_(-scale, scale, generator=generator)
            layer.bias.zero_()
        return self

    def forward(self, x):
        n = len(self.layers)
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < n - 1 or self.final_act:
                x = torch.relu(x)
        return x
