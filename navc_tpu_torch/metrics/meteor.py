"""METEOR-equivalent scorer (exact + Porter-stem matching).

The reference scores METEOR through a Java subprocess (meteor-1.5.jar) that is
absent from its checkout (.MISSING_LARGE_BLOBS:3), so no jar-based scoring is
possible there either. This module implements the published METEOR formula
(Banerjee & Lavie 2005 / Lavie & Agarwal 2007) natively:

  P = m/|hyp|, R = m/|ref|
  Fmean = P*R / (alpha*P + (1-alpha)*R)
  penalty = gamma * (chunks/m)^beta
  score = Fmean * (1 - penalty)

with the standard parameters alpha=0.9, beta=3.0, gamma=0.5 and two matcher
stages (exact surface, then Porter stems). One-to-one alignments are chosen
greedily to prefer monotone matches (fewer chunks). Multiple references score
independently; the best reference wins. This is a documented *equivalent*,
not a bit-exact reimplementation of the (unavailable) METEOR 1.5 jar.

A copy of navc_tpu/metrics/meteor.py: the port imports nothing of navc_tpu.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

ALPHA = 0.9
BETA = 3.0
GAMMA = 0.5

_stemmer = None


def _stem(w: str) -> str:
    global _stemmer
    if _stemmer is None:
        try:
            from nltk.stem.porter import PorterStemmer
            # classic Porter (1980): matches the native C++ stemmer exactly,
            # so the Python and C++ METEOR backends agree bit-for-bit
            _stemmer = PorterStemmer(mode="ORIGINAL_ALGORITHM")
        except Exception:  # fall back to identity stemming
            class _Id:
                def stem(self, w):
                    return w
            _stemmer = _Id()
    return _stemmer.stem(w)


def _align(hyp: List[str], ref: List[str]) -> List[Tuple[int, int]]:
    """One-to-one alignment: exact stage then stem stage, monotone-greedy."""
    matches: List[Tuple[int, int]] = []
    used_h = [False] * len(hyp)
    used_r = [False] * len(ref)

    for keyed in (hyp, [_stem(w) for w in hyp]):
        ref_keyed = ref if keyed is hyp else [_stem(w) for w in ref]
        last_r = -1
        for hi in range(len(hyp)):
            if used_h[hi]:
                continue
            # prefer the first unused ref position after the previous match
            cand: Optional[int] = None
            for ri in range(len(ref)):
                if used_r[ri] or ref_keyed[ri] != keyed[hi]:
                    continue
                if ri > last_r:
                    cand = ri
                    break
                if cand is None:
                    cand = ri
            if cand is not None:
                used_h[hi] = True
                used_r[cand] = True
                matches.append((hi, cand))
                last_r = cand
    matches.sort()
    return matches


def _chunks(matches: List[Tuple[int, int]]) -> int:
    if not matches:
        return 0
    chunks = 1
    for (h0, r0), (h1, r1) in zip(matches, matches[1:]):
        if not (h1 == h0 + 1 and r1 == r0 + 1):
            chunks += 1
    return chunks


def sentence_meteor(hyp: str, refs: List[str]) -> float:
    h = hyp.split()
    best = 0.0
    for ref in refs:
        r = ref.split()
        if not h or not r:
            continue
        matches = _align(h, r)
        m = len(matches)
        if m == 0:
            continue
        p = m / len(h)
        rec = m / len(r)
        fmean = p * rec / (ALPHA * p + (1 - ALPHA) * rec)
        penalty = GAMMA * (_chunks(matches) / m) ** BETA
        best = max(best, fmean * (1 - penalty))
    return best


def corpus_meteor(hyps: Dict[str, List[str]], refs: Dict[str, List[str]]
                  ) -> Tuple[float, List[float]]:
    per_image = [sentence_meteor(hyps[vid][0], refs[vid]) for vid in hyps]
    return (sum(per_image) / len(per_image) if per_image else 0.0), per_image
