"""COCO-style caption scorer façade.

Capability parity with reference misc/cocoeval.py COCOScorer: tokenize
ground-truth and predictions, run Bleu_1..4 + METEOR + ROUGE_L + CIDEr, and
return (summary dict, per-image detail dict) in the same shapes
(cocoeval.py:51-106).

A copy of navc_tpu/metrics/scorer.py: CIDEr and ROUGE-L come from the
native library (``native/lib.py``, built at first use; a failed build
raises), BLEU from the Python scorer for its per-image detail, METEOR from
the METEOR 1.5 model (``meteor15``) unless ``NAVC_METEOR_LEGACY`` is set,
which selects the legacy two-stage METEOR in C++. A corpus that is not
ASCII takes each scorer's Python path (navc_tpu's rule, ``native/lib.py``).
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

from ..native import lib as native
from .bleu import corpus_bleu
from .meteor15 import corpus_meteor15
from .tokenizer import tokenize_corpus


class COCOScorer:
    def __init__(self, verbose: bool = False):
        self.verbose = verbose
        self.eval: Dict[str, float] = {}
        self.img_to_eval: Dict[str, Dict[str, float]] = {}

    def score(self, GT: Dict[str, List[dict]], RES: Dict[str, List[dict]],
              IDs) -> Tuple[Dict[str, float], Dict[str, Dict[str, float]]]:
        ids = list(IDs)
        gts = {i: GT[i] for i in ids}
        res = {i: RES[i] for i in ids}

        gts_tok = tokenize_corpus(gts)
        res_tok = tokenize_corpus(res)

        self.eval = {}
        self.img_to_eval = {}

        # BLEU from corpus_bleu: the per-image detail needs the Python pass,
        # so summary and detail stay one implementation
        bleu_scores, bleu_per_img = corpus_bleu(res_tok, gts_tok)
        cider, cider_per = native.cider_corpus(res_tok, gts_tok)
        rouge, rouge_per = native.rouge_corpus(res_tok, gts_tok)
        if os.environ.get("NAVC_METEOR_LEGACY"):
            meteor, meteor_per = native.meteor_corpus(res_tok, gts_tok)
        else:
            meteor, meteor_per = corpus_meteor15(res_tok, gts_tok)

        for k, s in enumerate(bleu_scores):
            self._set("Bleu_%d" % (k + 1), s, ids, bleu_per_img[k])
        self._set("METEOR", meteor, ids, meteor_per)
        self._set("ROUGE_L", rouge, ids, rouge_per)
        self._set("CIDEr", cider, ids, cider_per)

        for i, vid in enumerate(ids):
            self.img_to_eval.setdefault(vid, {"image_id": vid})
        return self.eval, self.img_to_eval

    def _set(self, name: str, score: float, ids, per_image) -> None:
        self.eval[name] = float(score)
        for vid, s in zip(ids, per_image):
            self.img_to_eval.setdefault(vid, {"image_id": vid})[name] = float(s)
        if self.verbose:
            print("%s: %.4f" % (name, score))
