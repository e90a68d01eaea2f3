"""Joint representation: per-stream norm + temporal fusion, eval mode.

Port of navc_tpu/models/fusion.py (reference
models/joint_representation.py:24-53): per-stream BatchNorm over the
flattened (B*T, C) activations with the running statistics (or LayerNorm
when ``norm_type == 'ln'``), then temporal concatenation or additive mean
fusion; stream hiddens are averaged. ``addition`` with norms applies ONE
norm to the averaged stream, as the JAX package documents.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from .layers import LayerNorm, normalize


class Fusion(nn.Module):
    def __init__(self, fusion: str = "temporal_concat", norm_type: str = "bn",
                 no_encoder_bn: bool = False, num_streams: int = 1,
                 dim_hidden: int = 512):
        super().__init__()
        if fusion not in ("temporal_concat", "addition", "none"):
            raise ValueError("Unsupported fusion type: %r" % fusion)
        self.fusion = fusion
        self.norms = nn.ModuleDict()
        if not no_encoder_bn:
            n = 1 if fusion == "addition" else num_streams
            for i in range(n):
                if norm_type.lower() == "bn":
                    self.norms["bn%d" % i] = nn.BatchNorm1d(dim_hidden, eps=1e-5)
                else:
                    self.norms["ln%d" % i] = LayerNorm(dim_hidden, 1e-5)

    def forward(self, encoder_outputs: Sequence[torch.Tensor],
                encoder_hiddens: Sequence[torch.Tensor]):
        enc_hidden = torch.stack(list(encoder_hiddens), dim=0).mean(0)
        outs: List[torch.Tensor] = list(encoder_outputs)
        if self.fusion == "none":
            return torch.cat(outs, dim=1), enc_hidden
        if self.fusion == "addition":
            outs = [torch.stack(outs, dim=0).mean(0)]
        if len(self.norms):
            normed = []
            for x, norm in zip(outs, self.norms.values()):
                if isinstance(norm, nn.BatchNorm1d):
                    # BN over (B*T, C) with the running statistics
                    # (reference joint_representation.py:44-45)
                    normed.append(normalize(x, norm.running_mean,
                                            norm.running_var, norm.eps,
                                            norm.weight, norm.bias))
                else:
                    normed.append(norm(x))
            outs = normed
        if self.fusion == "temporal_concat":
            return torch.cat(outs, dim=1), enc_hidden
        return outs[0], enc_hidden
