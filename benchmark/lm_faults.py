"""Faults planted in the MLAMoE program's timed path, for the cell's check
(``lm_check``): each takes a ``setattr(owner, name, value)`` (pytest's
``monkeypatch.setattr``, or the builtin for a process of its own) and
replaces one method of ``navc_tpu_torch.models.mla_moe`` before the
captioner is made, so the captured graphs hold the fault too.

  expert_dropped         routed expert 0's output left out (its pairs'
                         weight 0);
  bias_ignored           the router chooses by ``topk(s)``, without the
                         correction bias ``e_score_correction_bias``;
  cache_slot_off_by_one  a step's latent entry written one caption slot
                         early (from the second step on it overwrites the
                         previous token's entry, which no later step sees);
  position_off_by_one    a decode step's rotary position one too far (the
                         prefill's positions kept). At the published widths
                         in bfloat16 it moves the served log-probs by less
                         than the program's own rounding does (PERF.md), and
                         the cell's check does not see it.

CHECKED names the faults the cell's check has to find.
"""

from __future__ import annotations

from typing import Callable, Dict


def expert_dropped(setattr_: Callable) -> None:
    import torch

    from navc_tpu_torch.models import mla_moe

    forward = mla_moe.Experts.forward

    def dropped(self, x, idx, weight):
        return forward(self, x, idx, torch.where(idx == 0, 0.0, weight))

    setattr_(mla_moe.Experts, "forward", dropped)


def bias_ignored(setattr_: Callable) -> None:
    import torch

    from navc_tpu_torch.models import mla_moe

    def forward(self, x):
        s = torch.sigmoid(x.float() @ self.weight.float().t())
        idx = torch.topk(s, self.top_k, dim=-1).indices
        g = s.gather(1, idx)
        return idx, g / (g.sum(-1, keepdim=True) + 1e-20) * self.scale

    setattr_(mla_moe.Router, "forward", forward)


def position_off_by_one(setattr_: Callable) -> None:
    from navc_tpu_torch.models import mla_moe

    rope = mla_moe.MLAMoELM.rope

    def shifted(self, positions):  # a decode step's one position, not the prefill's
        return rope(self, positions + 1 if positions.numel() == 1 else positions)

    setattr_(mla_moe.MLAMoELM, "rope", shifted)


def cache_slot_off_by_one(setattr_: Callable) -> None:
    from navc_tpu_torch.models import mla_moe

    cached = mla_moe.MLAttention.cached

    def early(self, x, cos, sin, prefix, caption, t, k):
        return cached(self, x, cos, sin, prefix, caption, max(1, t - 1), k)

    setattr_(mla_moe.MLAttention, "cached", early)


FAULTS: Dict[str, Callable[[Callable], None]] = {
    f.__name__: f for f in (expert_dropped, bias_ignored, cache_slot_off_by_one,
                            position_off_by_one)}
CHECKED = ("expert_dropped", "bias_ignored", "cache_slot_off_by_one")
