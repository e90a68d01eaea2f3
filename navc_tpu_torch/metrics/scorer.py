"""COCO-style caption scorer façade.

Capability parity with reference misc/cocoeval.py COCOScorer: tokenize
ground-truth and predictions, run Bleu_1..4 + METEOR + ROUGE_L + CIDEr, and
return (summary dict, per-image detail dict) in the same shapes
(cocoeval.py:51-106).

A copy of navc_tpu/metrics/scorer.py on its Python path only: navc_tpu's
optional C++ CIDEr/ROUGE (navc_tpu/native) and the ``NAVC_METEOR_LEGACY``
switch are not carried; METEOR is always the METEOR 1.5 model (meteor15).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from .bleu import corpus_bleu
from .cider import corpus_cider
from .meteor15 import corpus_meteor15
from .rouge import corpus_rouge_l
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

        bleu_scores, bleu_per_img = corpus_bleu(res_tok, gts_tok)
        cider, cider_per = corpus_cider(res_tok, gts_tok)
        rouge, rouge_per = corpus_rouge_l(res_tok, gts_tok)
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
