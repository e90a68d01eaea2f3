"""Evaluation loop: encode -> decode -> sentences -> metrics.

Port of navc_tpu/runtime/evaluate.py (reference misc/run.py run_eval,
run.py:99-246): encode-only forward, the teacher's encode, batched decoding
(AR beam search or NAR refinement), id -> sentence, optional 4-gram dedup,
COCO metrics + the weighted 'Sum', diversity diagnostics, and the latency
protocol (batch_size = 1: mean wall clock of the decode call, its host copy
of the hypotheses inside the timed region, the encodes outside it).

The decodes snapshot their kernel operands (bf16 weights) when they are
built, so ``run_eval`` rebuilds them from the models' current weights
(``Evaluator.refresh``) before every pass over a split. navc_tpu's collect
modes are not ported.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Any, Dict, Optional

import torch

from ..config import Config
from ..decoding import make_ar_generator, make_nar_generator
from ..metrics import COCOScorer
from .crit import kl_length_loss
from .sentence import analyze_length_novel_unique, duplicate, to_sentence
from .serving import make_encode_fn


class Evaluator:
    """The encode and decode of one model (and its rescoring teacher)."""

    def __init__(self, cfg: Config, model, teacher_cfg: Optional[Config] = None,
                 teacher_model=None):
        self.cfg = cfg
        self.model = model
        self.teacher_model = teacher_model
        self.device = next(model.parameters()).device
        self.encode = make_encode_fn(cfg, model)
        self.teacher_encode = (make_encode_fn(teacher_cfg or cfg, teacher_model)
                               if teacher_model is not None else None)
        self.generate = None

    def refresh(self) -> None:
        """Build the decode from the models' current weights."""
        if self.cfg.decoding_type == "NARFormer":
            self.generate = make_nar_generator(self.cfg, self.model, self.teacher_model)
        else:
            self.generate = make_ar_generator(self.cfg, self.model)

    def decode_batch(self, batch):
        """(hyp numpy, scores, enc, gen_time): ``gen_time`` times only the
        decode call and its host copy (reference run.py:130-143)."""
        if self.generate is None:
            self.refresh()
        feats = [torch.as_tensor(batch["feats_%s" % ch]).to(self.device)
                 for ch in self.cfg.modality.lower()]
        category = (torch.as_tensor(batch["category"]).to(self.device)
                    if self.cfg.with_category else None)
        enc = self.encode(feats)
        scores = None
        if self.cfg.decoding_type == "NARFormer":
            tenc = None if self.teacher_encode is None else self.teacher_encode(feats)
            t0 = time.perf_counter()
            hyp = self.generate(enc, category, tenc)
        else:
            t0 = time.perf_counter()
            hyp, scores = self.generate(enc, category)
        hyp = hyp.cpu().numpy()  # the host sync belongs to the timed region
        return hyp, scores, enc, time.perf_counter() - t0


def run_eval(cfg: Config, evaluator: Evaluator, loader, vocab,
             analyze: bool = False) -> Dict[str, Any]:
    """Decode ``loader``'s split and score it: the COCO metrics, their
    weighted 'Sum', the NAR length loss, and with ``analyze`` the caption
    statistics (reference run.py:99-246)."""
    evaluator.refresh()
    gt_captions = loader.dataset.get_references()
    pred_captions: Dict[str, list] = defaultdict(list)
    all_time = 0.0
    n_batches = 0
    length_loss_sum, length_loss_n = 0.0, 0

    for batch in loader:
        if n_batches == 0 and cfg.batch_size == 1:
            evaluator.decode_batch(batch)  # warm-up outside the timed region
        hyp, _, enc, gen_time = evaluator.decode_batch(batch)
        all_time += gen_time
        n_batches += 1
        hyp3 = hyp[:, None, :] if hyp.ndim == 2 else hyp  # (B, L) or n-best

        if cfg.decoding_type == "NARFormer" and "length_target" in batch:
            dev = enc["pred_length"].device
            ll = kl_length_loss(enc["pred_length"],
                                torch.as_tensor(batch["length_target"]).to(dev),
                                torch.as_tensor(batch["valid_mask"]).to(dev))
            length_loss_sum += float(ll) * batch["num_valid"]
            length_loss_n += batch["num_valid"]

        if hyp3.shape[1] != 1:
            # the reference asserts one hypothesis per video when scoring
            # (run.py:158)
            raise ValueError(
                "scoring requires topk == 1 (got %d hypotheses/video)" % hyp3.shape[1])
        for k in range(batch["num_valid"]):
            vid = batch["video_ids"][k]
            for j in range(hyp3.shape[1]):
                sent = to_sentence(hyp3[k, j], vocab)
                # 4-gram dedup only when asked (reference run.py:163)
                if cfg.duplicate and cfg.decoding_type == "NARFormer":
                    sent, _ = duplicate(sent)
                pred_captions[vid].append({"image_id": vid, "caption": sent})

    res: Dict[str, Any] = {}
    if cfg.batch_size == 1 and n_batches:
        res["latency"] = all_time / n_batches
    if analyze:
        ave_length, novel, unique, usage, _, gram4 = analyze_length_novel_unique(
            loader.dataset.captions, pred_captions, vocab,
            splits=loader.dataset.splits, n=1)
        res.update({"ave_length": ave_length, "novel": novel, "unique": unique,
                    "usage": usage, "gram4": gram4})
    valid_score, _ = COCOScorer().score(gt_captions, pred_captions, pred_captions.keys())
    res.update(valid_score)
    candidate = [res["Bleu_4"], res["METEOR"], res["ROUGE_L"], res["CIDEr"]]
    res["Sum"] = sum(v for i, v in enumerate(candidate) if cfg.metric_sum[i])
    if length_loss_n:
        res["Length Loss"] = length_loss_sum / length_loss_n
    return res
