"""Length-beam construction for NAR decoding.

Port of navc_tpu/decoding/length_beam.py (reference
decoding/na_generate.py:39-50, 66-77, 116-135). The canvas is a fixed width
(``cfg.max_len``, or its 8-aligned round-up when every forward runs through
the kernels); positions past each beam's length are PAD.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import constants as C
from ..ops.select import top_k_stable


def predict_length_beam(pred_length: torch.Tensor, length_beam_size: int,
                        length_bias: int, max_len: int,
                        gold_target_len: torch.Tensor = None) -> torch.Tensor:
    """Top-k predicted lengths, clamped to [4, max_len - 1].

    pred_length: (B, max_len) log-probs. Returns (B, length_beam_size) int32
    in descending-probability order; equal log-probs keep the lower length
    first, as ``lax.top_k`` does (a stable descending sort — ``torch.topk``
    does not promise that order). With ``gold_target_len`` the beam is
    centred on the gold length instead (na_generate.py:117-121).
    """
    if gold_target_len is not None:
        starts = gold_target_len.to(torch.int32) - (length_beam_size - 1) // 2
        beam = starts[:, None] + torch.arange(
            length_beam_size, dtype=torch.int32, device=pred_length.device)[None]
    else:
        _, idx = top_k_stable(pred_length, length_beam_size)
        beam = idx.to(torch.int32) + length_bias
    return beam.clamp(4, max_len - 1)


def build_canvas(beam: torch.Tensor, max_len: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """All-<mask> canvases with PAD tails per length beam: tokens
    (B*lbs, max_len) int32, pad_mask (B*lbs, max_len) bool, lengths
    (B*lbs,) int32."""
    lengths = beam.reshape(-1)
    pos = torch.arange(max_len, dtype=torch.int32, device=beam.device)[None]
    pad_mask = pos >= lengths[:, None]
    tokens = torch.where(pad_mask, C.PAD, C.MASK).to(torch.int32)
    return tokens, pad_mask, lengths


def enlarge(x: torch.Tensor, beam_size: int) -> torch.Tensor:
    """Tile rows beam_size times, row-major: (B, ...) -> (B*beam_size, ...)
    (reference misc/utils.py:205-229)."""
    return torch.repeat_interleave(x, beam_size, dim=0)


def select_best_length_beam(hypotheses: torch.Tensor, lprobs: torch.Tensor,
                            lengths: torch.Tensor, bsz: int, lbs: int,
                            beam_alpha: float):
    """Best length beam by sum(lprobs) / len**alpha (na_generate.py:66-77);
    the first best on ties. Returns (hypotheses (B, L), beam index (B,))."""
    max_len = hypotheses.shape[-1]
    hyp = hypotheses.reshape(bsz, lbs, max_len)
    lp = lprobs.reshape(bsz, lbs, max_len)
    lens = lengths.reshape(bsz, lbs).to(torch.float32)
    avg = lp.sum(-1) / torch.pow(lens, beam_alpha)
    best = avg.argmax(dim=-1)
    return hyp[torch.arange(bsz, device=hyp.device), best], best
