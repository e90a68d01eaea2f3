"""PTB-style caption tokenizer.

Replaces the Stanford-CoreNLP PTBTokenizer subprocess used by the reference
(coco-caption/pycocoevalcap/tokenizer/ptbtokenizer.py — the jar is absent from
the reference checkout). Behavior replicated for caption-style text:
tokenize with Penn-Treebank conventions, lowercase, and drop the standard
caption-evaluation punctuation set.

A copy of navc_tpu/metrics/tokenizer.py: ``tokenize_corpus`` runs the C++
tokenizer of the native library (``native/lib.py``, the same rules; a
caption that is not ASCII through ``ptb_tokenize``).
"""

from __future__ import annotations

import re
from typing import Dict, List

# Punctuation dropped from tokenized captions (same set the coco evaluation
# protocol removes).
PUNCTUATIONS = {
    "''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
    ".", "?", "!", ",", ":", "-", "--", "...", ";",
}

_CONTRACTIONS = re.compile(
    r"\b(can)(not)\b|\b(d')(ye)\b|\b(gim)(me)\b|\b(gon)(na)\b|"
    r"\b(got)(ta)\b|\b(lem)(me)\b|\b(wan)(na)\b", re.IGNORECASE)

# PTB-style splitting rules for caption text.
_RULES = [
    (re.compile(r"(\.\.\.)"), r" \1 "),
    (re.compile(r"([;@#$%&])"), r" \1 "),
    (re.compile(r"([^\.])(\.)([\]\)}>\"']*)\s*$"), r"\1 \2\3 "),
    (re.compile(r"([?!])"), r" \1 "),
    (re.compile(r"([\]\[\(\){}<>])"), r" \1 "),
    (re.compile(r"(--)"), r" \1 "),
    (re.compile(r"([^'])' "), r"\1 ' "),
    (re.compile(r"'([sSmMdD]) "), r" '\1 "),
    (re.compile(r"('ll|'LL|'re|'RE|'ve|'VE|n't|N'T) "), r" \1 "),
    (re.compile(r"([,:])(?!\d)"), r" \1 "),
]


def ptb_tokenize(text: str) -> List[str]:
    """Tokenize one caption: PTB rules -> lowercase -> drop punctuation."""
    s = " " + text.strip() + " "
    s = _CONTRACTIONS.sub(lambda m: " ".join(g for g in m.groups() if g), s)
    s = s.replace('"', " '' ")
    for rx, repl in _RULES:
        s = rx.sub(repl, s)
    tokens = [t.lower() for t in s.split()]
    return [t for t in tokens if t not in PUNCTUATIONS]


def tokenize_corpus(captions_for_image: Dict[str, List[dict]]) -> Dict[str, List[str]]:
    """{vid: [{'caption': str}, ...]} -> {vid: ['tok1 tok2 ...', ...]}.

    Same shape contract as the reference PTBTokenizer.tokenize
    (ptbtokenizer.py:28-87).
    """
    from ..native import lib as native

    out: Dict[str, List[str]] = {}
    for vid, caps in captions_for_image.items():
        out[vid] = [" ".join(native.tokenize(c["caption"])) for c in caps]
    return out
