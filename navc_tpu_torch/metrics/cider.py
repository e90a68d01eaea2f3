"""CIDEr for caption evaluation.

From-scratch implementation of the published CIDEr consensus metric as used by
the caption evaluation protocol (reference misc/cocoeval.py:73): tf-idf
weighted 1..4-gram cosine similarity with reference-count clipping and a
sigma=6 Gaussian length penalty, averaged over n-gram orders and references,
scaled by 10.

Quirk preserved from the protocol implementation: the "length" used by the
Gaussian penalty counts bigrams (i.e. len - 1 for non-empty sentences).

A copy of navc_tpu/metrics/cider.py: the port imports nothing of navc_tpu.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Tuple

N = 4
SIGMA = 6.0


def _ngram_counts(tokens: List[str]) -> Dict[tuple, int]:
    counts: Dict[tuple, int] = defaultdict(int)
    for k in range(1, N + 1):
        for i in range(len(tokens) - k + 1):
            counts[tuple(tokens[i:i + k])] += 1
    return counts


def corpus_cider(hyps: Dict[str, List[str]], refs: Dict[str, List[str]]
                 ) -> Tuple[float, List[float]]:
    vids = list(hyps.keys())
    ctest = [_ngram_counts(hyps[v][0].split()) for v in vids]
    crefs = [[_ngram_counts(r.split()) for r in refs[v]] for v in vids]

    # document frequency over reference sets
    df: Dict[tuple, float] = defaultdict(float)
    for ref_set in crefs:
        for gram in set(g for ref in ref_set for g in ref):
            df[gram] += 1.0
    ref_len = math.log(float(len(crefs)))

    def counts2vec(cnts: Dict[tuple, int]):
        vec = [defaultdict(float) for _ in range(N)]
        norm = [0.0] * N
        length = 0
        for gram, tf in cnts.items():
            idf = ref_len - math.log(max(1.0, df[gram]))
            k = len(gram) - 1
            vec[k][gram] = float(tf) * idf
            norm[k] += vec[k][gram] ** 2
            if k == 1:  # protocol quirk: counts bigrams as "length"
                length += tf
        return vec, [math.sqrt(x) for x in norm], length

    def sim(vh, vr, nh, nr, lh, lr) -> List[float]:
        delta = float(lh - lr)
        val = [0.0] * N
        for k in range(N):
            for gram, w in vh[k].items():
                val[k] += min(w, vr[k][gram]) * vr[k][gram]
            if nh[k] != 0 and nr[k] != 0:
                val[k] /= nh[k] * nr[k]
            val[k] *= math.exp(-(delta ** 2) / (2 * SIGMA ** 2))
        return val

    per_image: List[float] = []
    for test, ref_set in zip(ctest, crefs):
        vh, nh, lh = counts2vec(test)
        score = [0.0] * N
        for ref in ref_set:
            vr, nr, lr = counts2vec(ref)
            s = sim(vh, vr, nh, nr, lh, lr)
            for k in range(N):
                score[k] += s[k]
        avg = sum(score) / N / len(ref_set) * 10.0
        per_image.append(avg)

    return (sum(per_image) / len(per_image) if per_image else 0.0), per_image
