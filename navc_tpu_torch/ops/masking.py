"""Attention-mask builders and NAR input enhancement.

Port of navc_tpu/ops/masking.py (reference models/Decoder.py:9-54, 137).
Convention: boolean masks where True = position is masked OUT.
"""

from __future__ import annotations

import torch

from .. import constants as C


def non_pad_mask(seq: torch.Tensor) -> torch.Tensor:
    """(B, L) ids -> (B, L, 1) float mask, 1.0 where not PAD."""
    return (seq != C.PAD).to(torch.float32)[..., None]


def key_pad_mask(seq_k: torch.Tensor, len_q: int) -> torch.Tensor:
    """(B, Lk) key ids -> (B, Lq, Lk) bool mask, True where the key is PAD."""
    pad = seq_k == C.PAD
    return pad[:, None, :].expand(seq_k.shape[0], len_q, seq_k.shape[1])


def subsequent_mask(batch: int, len_s: int, watch: int = 0,
                    device=None) -> torch.Tensor:
    """(B, L, L) causal mask, True above the diagonal; ``watch`` > 0 also
    masks positions more than ``watch`` steps in the past."""
    i = torch.arange(len_s, device=device)[:, None]
    j = torch.arange(len_s, device=device)[None, :]
    m = j > i
    if watch != 0 and len_s >= watch:
        assert watch > 0
        m = m | (j <= i - watch)
    return m[None].expand(batch, len_s, len_s)


def resample_enc_output(enc_output: torch.Tensor,
                        tgt_tokens: torch.Tensor) -> torch.Tensor:
    """NAR enhance_input == 1: position j of row i reads
    ``enc_output[i, min(floor(j * T / len_i), T - 1)]``."""
    b, l = tgt_tokens.shape
    t = enc_output.shape[1]
    lengths = (tgt_tokens != C.PAD).sum(-1)
    scale = t / lengths.clamp(min=1).to(torch.float32)
    pos = torch.arange(l, dtype=torch.float32, device=enc_output.device)
    idx = (pos[None, :] * scale[:, None]).to(torch.int64).clamp(max=t - 1)
    return torch.gather(
        enc_output, 1, idx[:, :, None].expand(b, l, enc_output.shape[2]))


def meanpool_enc_output(enc_output: torch.Tensor, len_q: int) -> torch.Tensor:
    """NAR enhance_input == 2: the temporal mean broadcast over the token
    grid."""
    pooled = enc_output.mean(dim=1, keepdim=True)
    return pooled.expand(enc_output.shape[0], len_q, enc_output.shape[2])
