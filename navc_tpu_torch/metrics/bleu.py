"""Corpus BLEU with the coco-caption evaluation conventions.

From-scratch implementation of the published BLEU metric as used by the
caption evaluation protocol (reference misc/cocoeval.py:70 via
pycocoevalcap/bleu): clipped n-gram precision against per-image max reference
counts, closest-reference effective length, and the brevity penalty
``exp(1 - 1/ratio)`` applied only when ratio < 1, with the protocol's
tiny/small smoothing constants.

A copy of navc_tpu/metrics/bleu.py: the port imports nothing of navc_tpu.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

_SMALL = 1e-9
_TINY = 1e-15


def _ngram_counts(tokens: Sequence[str], n: int) -> Dict[tuple, int]:
    counts: Dict[tuple, int] = defaultdict(int)
    for k in range(1, n + 1):
        for i in range(len(tokens) - k + 1):
            counts[tuple(tokens[i:i + k])] += 1
    return counts


def corpus_bleu(hyps: Dict[str, List[str]], refs: Dict[str, List[str]],
                n: int = 4) -> Tuple[List[float], List[List[float]]]:
    """Returns ([Bleu_1..Bleu_n] corpus scores, per-image score lists).

    hyps: {vid: [hypothesis string]}, refs: {vid: [ref strings]}.
    """
    total_guess = [0] * n
    total_correct = [0] * n
    total_testlen = 0
    total_reflen = 0.0
    per_image: List[List[float]] = [[] for _ in range(n)]

    for vid in hyps:
        hyp_tokens = hyps[vid][0].split()
        ref_token_lists = [r.split() for r in refs[vid]]
        testlen = len(hyp_tokens)

        # closest effective reference length (average when a single ref)
        reflens = [len(r) for r in ref_token_lists]
        if len(reflens) == 1:
            reflen: float = float(reflens[0])
        else:
            reflen = float(min((abs(l - testlen), l) for l in reflens)[1])
        total_testlen += testlen
        total_reflen += reflen

        max_ref_counts: Dict[tuple, int] = defaultdict(int)
        for rt in ref_token_lists:
            for gram, c in _ngram_counts(rt, n).items():
                max_ref_counts[gram] = max(max_ref_counts[gram], c)

        hyp_counts = _ngram_counts(hyp_tokens, n)
        guess = [max(0, testlen - k) for k in range(n)]
        correct = [0] * n
        for gram, c in hyp_counts.items():
            correct[len(gram) - 1] += min(c, max_ref_counts.get(gram, 0))

        for k in range(n):
            total_guess[k] += guess[k]
            total_correct[k] += correct[k]

        # per-image score with the same smoothing
        b = 1.0
        ratio = (testlen + _TINY) / (reflen + _SMALL)
        for k in range(n):
            b *= (correct[k] + _TINY) / (guess[k] + _SMALL)
            s = b ** (1.0 / (k + 1))
            if ratio < 1:
                s *= math.exp(1 - 1 / ratio)
            per_image[k].append(s)

    scores: List[float] = []
    b = 1.0
    ratio = (total_testlen + _TINY) / (total_reflen + _SMALL)
    for k in range(n):
        b *= (total_correct[k] + _TINY) / (total_guess[k] + _SMALL)
        s = b ** (1.0 / (k + 1))
        if ratio < 1:
            s *= math.exp(1 - 1 / ratio)
        scores.append(s)
    return scores, per_image
