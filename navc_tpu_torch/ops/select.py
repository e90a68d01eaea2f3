"""Per-row ordinal-rank selection masks for the NAR refinement loop.

Port of navc_tpu/ops/select.py (reference decoding/algorithms.py:206-215,
369-379). Ties break stably — lower position first — by counting, exactly as
the JAX version does; ``torch.topk`` is not used because its tie order is
unspecified.
"""

from __future__ import annotations

import torch


def _ordinal_ranks(values: torch.Tensor, descending: bool = False) -> torch.Tensor:
    """(B, L) -> (B, L) ordinal ranks (0 = first in sort order), stable ties:
    rank(i) = #{j : v_j strictly before v_i} + #{j < i : v_j ties v_i}."""
    v = -values if descending else values
    vi = v[:, :, None]
    vj = v[:, None, :]
    before = (vj < vi).sum(-1)
    l = v.shape[-1]
    idx = torch.arange(l, device=values.device)
    tie_before = ((vj == vi) & (idx[None, None, :] < idx[:, None][None])).sum(-1)
    return before + tie_before


def rank_mask_smallest(values: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """True at the k[i] smallest entries of each row (ties broken stably)."""
    return _ordinal_ranks(values, descending=False) < k[:, None]


def rank_mask_largest(values: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """True at the k[i] largest entries of each row (ties broken stably)."""
    return _ordinal_ranks(values, descending=True) < k[:, None]


def top_k_stable(values: torch.Tensor, k: int):
    """(values, int64 indices) of the k largest entries of each row of the
    last axis, descending, lower index first among equal values — the order
    of ``lax.top_k``, from a stable sort (``torch.topk`` does not promise
    it)."""
    top, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return top[..., :k], idx[..., :k]
