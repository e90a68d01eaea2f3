"""Per-modality highway feature encoder.

Port of navc_tpu/models/encoder.py (reference models/Encoder.py): each
modality stream is Linear(dim_in -> dim_hidden) -> HighWay(gated tanh) ->
Dropout (train mode only, given a generator), and the stream hidden state is
the temporal mean (Encoder.py:47-59).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from .layers import dropout


class HighWay(nn.Module):
    """Gated highway block (reference models/Encoder.py:9-25)."""

    def __init__(self, hidden_size: int):
        super().__init__()
        self.w1 = nn.Linear(hidden_size, hidden_size)
        self.w2 = nn.Linear(hidden_size, hidden_size)

    def forward(self, x):
        y = torch.tanh(self.w1(x))
        gate = torch.sigmoid(self.w2(x))
        return gate * x + (1.0 - gate) * y


class HighWayStream(nn.Module):
    """One modality stream: Linear -> HighWay -> Dropout (Encoder.py:65)."""

    def __init__(self, dim_in: int, dim_hidden: int, p: float = 0.5):
        super().__init__()
        self.p = p
        self.linear = nn.Linear(dim_in, dim_hidden)
        self.highway = HighWay(dim_hidden)

    def forward(self, feats, generator=None):
        return dropout(self.highway(self.linear(feats)), self.p, generator)


class MultiStreamEncoder(nn.Module):
    """All modality streams, in modality order; streams are named
    ``Encoder_<CHAR>`` as in the flax tree."""

    def __init__(self, modality: str, dims: Sequence[int], dim_hidden: int,
                 encoder_dropout: float = 0.5):
        super().__init__()
        self.names = ["Encoder_%s" % ch.upper() for ch in modality.lower()]
        self.streams = nn.ModuleDict({
            name: HighWayStream(d, dim_hidden, encoder_dropout)
            for name, d in zip(self.names, dims)})

    def forward(self, input_feats: Sequence[torch.Tensor], generator=None):
        if len(input_feats) != len(self.names):
            raise ValueError("expected %d modality streams, got %d"
                             % (len(self.names), len(input_feats)))
        outputs: List[torch.Tensor] = [
            self.streams[name](f, generator)
            for name, f in zip(self.names, input_feats)]
        return outputs, [o.mean(dim=1) for o in outputs]
