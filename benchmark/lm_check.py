"""The comparison that decides ``correct`` for an MLAMoE cell.

With random weights the logits over 163,840 ids are nearly flat and the
router's sigmoid scores lie close together, so tokens and expert choices
flip on rounding: the served captions are not compared token by token.
Each answer to a video the traffic names for the check (``check_rows``)
is held, token by token through its first EOS (or all of it), against the
plain reference's teacher-forced forward over ``[prefix, BOS, caption]``
(``reference/mla_moe_lm.py``, float32, TF32 off, on the same bfloat16
weights upcast per use), run once after the window in blocks of videos:

  logprob_err          the mean over those tokens of |the served
                       log-probability - the reference's log-probability of
                       the same token at the same position|;
  beam_rank_violation  the share of those tokens whose reference
                       log-probability lies below the reference's k-th best
                       at that position (k the beam) by more than the
                       cell's ``rank_tolerance``: a beam keeps only its rows'
                       k best candidates;
  unanswered           requests of the window that never came back, or came
                       back with another shape than (videos, max_len - 1)
                       tokens and log-probabilities.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from .reference import mla_moe_lm as RL


def through_eos(tokens: np.ndarray) -> np.ndarray:
    """(R, T) bool: each caption's positions up to and including its first
    EOS (all of them where it has none)."""
    eos = tokens == RL.EOS
    first = np.where(eos.any(1), eos.argmax(1), tokens.shape[1] - 1)
    return np.arange(tokens.shape[1])[None, :] <= first[:, None]


def served(client, reqs, pool: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(check rows of the answers, their tokens, their log-probabilities)
    of every answered request of ``pool``."""
    rows = client.check_rows(pool)
    out_rows, toks, lps = [], [], []
    for req in reqs:
        if req.pool != pool or req.hyp is None:
            continue
        tokens, lp = req.hyp
        pick = np.isin(req.rows, rows)
        out_rows.append(np.asarray(req.rows)[pick])
        toks.append(np.asarray(tokens)[pick])
        lps.append(np.asarray(lp)[pick])
    if not toks:
        return np.zeros(0, int), np.zeros((0, 0), int), np.zeros((0, 0), np.float32)
    return np.concatenate(out_rows), np.concatenate(toks), np.concatenate(lps)


def reference_readings(config: Dict, weights: Dict, feats: List[np.ndarray],
                       rows: np.ndarray, tokens: np.ndarray, device, precision: str = "fp32",
                       score: np.ndarray = None):
    """The reference's teacher-forced (log-probability of each token (of
    ``score``, else of the caption), k-th best, best token) over the
    captions ``tokens`` of the videos ``rows``, as numpy."""
    f = [torch.as_tensor(x[rows]).to(device) for x in feats]
    cap = torch.as_tensor(tokens).to(device)
    sc = None if score is None else torch.as_tensor(score).to(device)
    out = RL.teacher_forced(weights, config, f, cap, config["beam_size"], precision,
                            score=sc)
    return tuple(x.cpu().numpy() for x in out)


def unique_answers(rows: np.ndarray, tokens: np.ndarray):
    """(index of each distinct (row, caption) pair's first answer, each
    answer's distinct pair)."""
    keys = np.concatenate([rows[:, None], tokens], 1)
    _, first, inverse = np.unique(keys, axis=0, return_index=True, return_inverse=True)
    return first, inverse.reshape(-1)


def lm_checks(config: Dict, weights: Dict, client, reqs, device, check: Dict
              ) -> Tuple[Dict, int, Dict]:
    """({name: {"value", "limit"}}, requests failed, {pool: the answers and
    the reference's readings of them}) for the cell's ``check`` entry."""
    width = config["max_len"] - 1
    failed = 0
    for r in reqs:
        ok = (isinstance(r.hyp, tuple) and len(r.hyp) == 2
              and all(np.asarray(x).shape == (r.videos, width) for x in r.hyp))
        if not ok:
            r.hyp = None
            failed += 1
    tol = check["rank_tolerance"]
    err = viol = count = 0.0
    refs = {}
    for pool, (feats, _) in enumerate(client.pools):
        rows, tokens, lps = served(client, reqs, pool)
        if not len(rows):
            continue
        first, which = unique_answers(rows, tokens)
        ref_lp, kth, _ = reference_readings(config, weights, feats, rows[first],
                                            tokens[first], device)
        mask = through_eos(tokens)
        err += float((np.abs(lps - ref_lp[which]) * mask).sum())
        viol += float(((ref_lp[which] < kth[which] - tol) & mask).sum())
        count += float(mask.sum())
        refs[pool] = dict(rows=rows[first], tokens=tokens[first], lps=lps[first],
                          ref_lp=ref_lp, kth=kth)
    limits = check["limits"]
    return ({"logprob_err": {"value": err / count if count else float("inf"),
                             "limit": limits["logprob_err"]},
             "beam_rank_violation": {"value": viol / count if count else 1.0,
                                     "limit": limits["beam_rank_violation"]},
             "unanswered": {"value": failed, "limit": 0}}, failed, refs)
