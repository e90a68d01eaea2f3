"""The MLAMoE cells' weights, drawn from ``--seed`` on the device.

The language model's tensors are drawn in bfloat16, the type the program
holds them in (15.96 B parameters, 31.9 GB at the published widths), the
encoder's in float32, each in place from one device generator in the state
dict's order: a projection's weight (and an encoder bias)
U(-1/sqrt(fan_in), 1/sqrt(fan_in)), each expert's matrices by their own
fan-in, the token embeddings N(0, 1), norms at identity, BatchNorm's
running statistics at (0, 1), and the router's correction bias
``e_score_correction_bias`` N(0, B_CORR^2) (the configuration's
``assumed``: a trained model's bias is not zero, and at this scale it
changes some of the router's choices).
"""

from __future__ import annotations

from typing import Dict

import torch

from .reference.mla_moe_lm import param_shapes

B_CORR = 0.02


@torch.no_grad()
def make_weights(config: Dict, seed: int, device, out: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """``out``, a model's own state dict on ``device`` (the program holds
    the language model in the configuration's type), with every tensor
    drawn in place: no second copy of the weights. Returns the tensors by
    the reference's keys."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    shapes = param_shapes(config)
    sd = {}
    for k, s in shapes.items():
        t = sd[k] = out[k]
        if tuple(t.shape) != tuple(s):
            raise ValueError("%s: the model holds %s, the configuration states %s"
                             % (k, tuple(t.shape), s))
        if k.endswith("e_score_correction_bias"):
            t.normal_(0.0, B_CORR, generator=g)
        elif k.endswith(("running_mean", "bias", "num_batches_tracked")) \
                and not k.startswith("encoder."):
            t.zero_()
        elif k.endswith(("norm.weight", "running_var")) or ".norms." in k:
            t.fill_(1.0)
        elif k.endswith("embed_tokens.weight"):
            t.normal_(0.0, 1.0, generator=g)
        else:
            fan_in = s[-1] if k.endswith("weight") or k.startswith("lm.") else None
            if fan_in is None:  # an encoder bias: its weight's fan-in
                fan_in = shapes[k[:-len("bias")] + "weight"][1]
            bound = fan_in ** -0.5
            t.uniform_(-bound, bound, generator=g)
    return sd
