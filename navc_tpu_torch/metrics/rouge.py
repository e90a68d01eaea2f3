"""ROUGE-L for caption evaluation.

From-scratch implementation of the published ROUGE-L F-measure as used by the
caption evaluation protocol (reference misc/cocoeval.py:72): LCS length
against each reference, max precision and max recall over references, F with
beta = 1.2.

A copy of navc_tpu/metrics/rouge.py: the port imports nothing of navc_tpu.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

BETA = 1.2


def lcs_length(a: List[str], b: List[str]) -> int:
    """Classic O(len(a)*len(b)) longest-common-subsequence length."""
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0] * (len(b) + 1)
        for j, y in enumerate(b, 1):
            cur[j] = prev[j - 1] + 1 if x == y else max(prev[j], cur[j - 1])
        prev = cur
    return prev[-1]


def sentence_rouge_l(hyp: str, refs: List[str]) -> float:
    h = hyp.split()
    prec, rec = [], []
    for r in refs:
        rt = r.split()
        l = lcs_length(rt, h)
        prec.append(l / len(h) if h else 0.0)
        rec.append(l / len(rt) if rt else 0.0)
    pmax, rmax = max(prec), max(rec)
    if pmax != 0 and rmax != 0:
        return ((1 + BETA ** 2) * pmax * rmax) / (rmax + BETA ** 2 * pmax)
    return 0.0


def corpus_rouge_l(hyps: Dict[str, List[str]], refs: Dict[str, List[str]]
                   ) -> Tuple[float, List[float]]:
    per_image = [sentence_rouge_l(hyps[vid][0], refs[vid]) for vid in hyps]
    return (sum(per_image) / len(per_image) if per_image else 0.0), per_image
