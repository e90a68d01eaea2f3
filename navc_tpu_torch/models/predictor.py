"""Length head for NAR decoding.

Port of navc_tpu/models/predictor.py (reference models/Predictor.py:12-30):
Linear -> ReLU -> Dropout (train mode only) -> Linear(max_len) over the
temporal mean of the encoder output, log-softmaxed.
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import dropout


class LengthPredictor(nn.Module):
    key_name = "pred_length"

    def __init__(self, dim_hidden: int, max_len: int, p: float = 0.5):
        super().__init__()
        self.p = p
        self.fc1 = nn.Linear(dim_hidden, dim_hidden)
        self.fc2 = nn.Linear(dim_hidden, max_len)

    def forward(self, enc_output, generator=None):
        x = dropout(torch.relu(self.fc1(enc_output.mean(dim=1))), self.p,
                    generator)
        return {self.key_name: torch.log_softmax(self.fc2(x), dim=-1)}


AUXILIARY_PREDICTORS = {"length": LengthPredictor}
