"""Training losses with the reference's semantics (misc/crit.py).

Port of navc_tpu/runtime/crit.py:
  * language loss: -log p at non-PAD labels, summed over tokens and divided
    by the batch size (crit.py:40-48, 76-84); visual-word generation weights
    its two passes by ``cfg.nv_weights``;
  * length loss: ``nn.KLDivLoss()`` 'mean' — the sum of target * (log target
    - pred) over the B * max_len elements (crit.py:223), 0 where the target
    is 0;
  * metrics: word accuracy (pass 0 of visual-word generation leaves out MASK
    labels, crit.py:86-98) and the perplexity sums over non-PAD tokens.

The train forward hands over RAW logits (possibly bf16), where
``_label_logprob`` normalises at the label positions only with float32
reductions, or, on the fused CE route (ops/vocab_ce), each pass's per-row
(label log-prob, argmax) pair under ``tgt_word_rowstats``: the NLL is built
from those log-probs, so autograd hands K10 its gradient (-w * mask / B,
zero at PAD labels and dropped rows). The kernel's argmax may differ from
the logits' on bf16 near-ties (word accuracy only). A
``valid_mask`` (B,) drops padded rows of a final partial batch and divides
by the valid-row count. Across ranks (``group``, the 'data' group) the
denominators are the global batch's, as navc_tpu's one GSPMD array has
them: the valid-row count is all-reduced before any division, so the ranks'
losses sum to the global loss, and a final partial batch whose valid rows
fall unevenly across ranks gives the single-process loss. Every value stays
a tensor on its device: nothing here waits for the card or copies from the
host, so the step that calls it can be captured as a CUDA graph.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from .. import constants as C
from ..config import Config
from ..parallel.distributed import all_reduce_


def kl_length_loss(pred_logprobs: torch.Tensor, target: torch.Tensor,
                   valid_mask: Optional[torch.Tensor] = None,
                   rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """torch nn.KLDivLoss() 'mean' over all B * max_len elements;
    ``rows``: the batch's (valid) row count when it is not this one's
    (the global batch's)."""
    pos = target > 0
    safe = torch.where(pos, target, torch.ones_like(target))
    pointwise = torch.where(pos, target * (torch.log(safe) - pred_logprobs),
                            torch.zeros_like(target))
    if valid_mask is not None:
        pointwise = pointwise * valid_mask[:, None]
    if rows is not None:
        denom = rows * target.shape[1]
    elif valid_mask is not None:
        denom = valid_mask.sum().clamp(min=1.0) * target.shape[1]
    else:
        denom = float(target.shape[0] * target.shape[1])
    return pointwise.sum() / denom


def _label_logprob(lp: torch.Tensor, lab: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(log-softmax of raw logits ``lp`` at ``lab``, argmax of ``lp``), as
    ``(x[y] - max) - log(sum(exp(x - max)))`` in float32; ``lp`` may be
    bf16 (the gathered element is exact either way)."""
    m = lp.amax(-1, keepdim=True).to(torch.float32)
    lse = torch.log(torch.exp(lp.to(torch.float32) - m).sum(-1))
    g = lp.gather(-1, lab.long()[..., None])[..., 0].to(torch.float32)
    return (g - m[..., 0]) - lse, lp.argmax(-1)


def compute_losses(cfg: Config, results: Dict,
                   valid_mask: Optional[torch.Tensor] = None, group=None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The aggregate criterion (reference Criterion.get_loss,
    crit.py:156-181). ``results`` holds ``tgt_word_rowstats`` ((B, L) label
    log-probs and (B, L) argmax ids), ``tgt_word_logits`` (raw) or
    ``tgt_word_logprobs``, one per pass, ``tgt_word_labels``, and
    ``pred_length`` / ``tgt_length`` when 'length' is in ``cfg.crit``.
    Returns (total loss, metrics), every metric a 0-d float32 tensor.
    ``group``: the process group of the global batch, whose (valid) row
    count divides the losses."""
    metrics: Dict[str, torch.Tensor] = {}
    vwg = cfg.visual_word_generation
    from_rowstats = "tgt_word_rowstats" in results
    from_logits = "tgt_word_logits" in results
    logprob_sets: Sequence = (
        results["tgt_word_rowstats"] if from_rowstats
        else results["tgt_word_logits"] if from_logits
        else results["tgt_word_logprobs"])
    label_sets = results["tgt_word_labels"]
    if not isinstance(logprob_sets, (list, tuple)):
        logprob_sets = [logprob_sets]
    if not isinstance(label_sets, (list, tuple)):
        label_sets = [label_sets] * len(logprob_sets)
    assert len(logprob_sets) == len(label_sets)
    first = logprob_sets[0][0] if from_rowstats else logprob_sets[0]
    dev = first.device

    weights = list(cfg.nv_weights) if vwg else [1.0] * len(logprob_sets)
    if valid_mask is not None:
        batch_denom = valid_mask.sum()
    else:
        batch_denom = torch.full((), float(first.shape[0]), dtype=torch.float32,
                                 device=dev)  # a fill on the card, no host copy
    if group is not None:  # the global batch's count, before any division
        all_reduce_(batch_denom, group)
    if valid_mask is not None:
        batch_denom = batch_denom.clamp(min=1.0)

    lang_loss = torch.zeros((), dtype=torch.float32, device=dev)
    for i, (w, lp, lab) in enumerate(zip(weights, logprob_sets, label_sets)):
        if from_rowstats:
            gathered, pred = lp
        elif from_logits:
            gathered, pred = _label_logprob(lp, lab)
        else:
            gathered = lp.gather(-1, lab.long()[..., None])[..., 0]
            pred = lp.argmax(-1)
        nonpad = (lab != C.PAD).to(torch.float32)
        mask = nonpad if valid_mask is None else nonpad * valid_mask[:, None]
        nll = -(gathered * mask).sum()
        lang_loss = lang_loss + w * nll / batch_denom

        ind = lab != C.PAD
        if i == 0 and vwg:
            ind = ind & (lab != C.MASK)
        if valid_mask is not None:
            ind = ind & (valid_mask[:, None] > 0)
        metrics["word_acc%d_correct" % i] = ((pred == lab) & ind).sum().to(torch.float32)
        metrics["word_acc%d_count" % i] = ind.sum().to(torch.float32)
        if not (i == 0 and vwg):
            metrics["ppl_sum"] = nll.detach()
            metrics["ppl_count"] = mask.sum()

    assert len(cfg.crit) == len(cfg.crit_scale), \
        "crit %s and crit_scale %s must align" % (cfg.crit, cfg.crit_scale)
    scales = {name.lower(): s for name, s in zip(cfg.crit, cfg.crit_scale)}
    metrics["lang_loss"] = lang_loss.detach()
    total = scales.get("lang", 1.0) * lang_loss
    if "length" in [c.lower() for c in cfg.crit]:
        len_loss = kl_length_loss(results["pred_length"], results["tgt_length"],
                                  valid_mask, batch_denom if group is not None else None)
        metrics["length_loss"] = len_loss.detach()
        total = total + scales.get("length", 1.0) * len_loss
    metrics["total_loss"] = total.detach()
    metrics["num_samples"] = batch_denom.to(torch.float32)
    return total, metrics
