"""Joint representation: per-stream norm + temporal fusion.

Port of navc_tpu/models/fusion.py (reference
models/joint_representation.py:24-53): per-stream BatchNorm over the
flattened (B*T, C) activations (or LayerNorm when ``norm_type == 'ln'``),
then temporal concatenation or additive mean fusion; stream hiddens are
averaged. ``addition`` with norms applies ONE norm to the averaged stream,
as the JAX package documents.

BatchNorm is flax's ``BatchNorm(momentum=0.9)``: eval mode normalises with
the running statistics; train mode with the batch's mean and its BIASED
variance E[x^2] - E[x]^2 (clipped at 0), and moves the running statistics
0.9 / 0.1 towards them in place — torch's BatchNorm1d would use the
unbiased variance for the running update, so it is not called. Across
ranks (``stats_group``, the 'data' group a distributed training step sets)
the batch is the global one, as under navc_tpu's GSPMD: the statistics
come from the per-rank sums of x and x^2 and row counts, all-reduced by a
differentiable sum, so the backward sees the global statistics and the
running statistics move alike on every rank.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from ..parallel.distributed import GroupRef, all_reduce
from .layers import LayerNorm, normalize


class Fusion(nn.Module):
    stats_group: GroupRef = None  # the process group BatchNorm's training statistics span

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
                encoder_hiddens: Sequence[torch.Tensor], train: bool = False):
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
                    # BN over (B*T, C) (reference joint_representation.py:44-45)
                    normed.append(_batch_norm(x, norm, train, self.stats_group
                                              and self.stats_group.group))
                else:
                    normed.append(norm(x))
            outs = normed
        if self.fusion == "temporal_concat":
            return torch.cat(outs, dim=1), enc_hidden
        return outs[0], enc_hidden


def _batch_norm(x: torch.Tensor, norm: nn.BatchNorm1d, train: bool, group=None):
    if not train:
        return normalize(x, norm.running_mean, norm.running_var, norm.eps,
                         norm.weight, norm.bias)
    flat = x.reshape(-1, x.shape[-1]).to(torch.float32)
    if group is None:
        mean = flat.mean(0)
        var = ((flat * flat).mean(0) - mean * mean).clamp(min=0.0)
    else:
        c = flat.shape[1]
        sums = torch.cat([flat.sum(0), (flat * flat).sum(0),
                          flat.new_full((1,), float(flat.shape[0]))])
        sums = all_reduce(sums, group)
        mean = sums[:c] / sums[-1]
        var = (sums[c:2 * c] / sums[-1] - mean * mean).clamp(min=0.0)
    with torch.no_grad():
        norm.running_mean.mul_(0.9).add_(0.1 * mean)
        norm.running_var.mul_(0.9).add_(0.1 * var)
    return normalize(x, mean, var, norm.eps, norm.weight, norm.bias)
