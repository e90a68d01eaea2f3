"""Evaluation loop: encode -> decode -> sentences -> metrics.

Port of navc_tpu/runtime/evaluate.py (reference misc/run.py run_eval,
run.py:99-246): encode-only forward, the teacher's encode, batched decoding
(AR beam search or NAR refinement), id -> sentence, optional 4-gram dedup,
COCO metrics + the weighted 'Sum', diversity diagnostics, the latency
protocol (batch_size = 1: mean wall clock of the decode call, its host copy
of the hypotheses inside the timed region, the encodes outside it), and the
collect modes: the NAR decode's per-iteration candidates, or the AR beam's
captions with their scores, pickled to ``collect_path``.

The decodes snapshot their kernel operands (bf16 weights) when they are
built, so ``run_eval`` rebuilds them from the models' current weights
(``Evaluator.refresh``) before every pass over a split.
"""

from __future__ import annotations

import pickle
import time
from collections import defaultdict
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..config import Config
from ..decoding import make_ar_generator, make_nar_generator
from ..metrics import COCOScorer
from .crit import kl_length_loss
from .sentence import analyze_length_novel_unique, duplicate, to_sentence
from .serving import make_encode_fn


class Evaluator:
    """The encode and decode of one model (and its rescoring teacher).

    ``dict_mapping``: the student -> teacher vocab id map
    (``sentence.get_dict_mapping``), kept as a tensor on the model's device.
    ``collect``: the NAR decode also returns its per-iteration candidates.
    """

    def __init__(self, cfg: Config, model, teacher_cfg: Optional[Config] = None,
                 teacher_model=None, dict_mapping: Optional[np.ndarray] = None,
                 collect: bool = False):
        self.cfg = cfg
        self.model = model
        self.teacher_cfg = teacher_cfg or cfg
        self.teacher_model = teacher_model
        self.collect = collect
        self.device = next(model.parameters()).device
        self.dict_mapping = (None if dict_mapping is None else
                             torch.as_tensor(np.asarray(dict_mapping), dtype=torch.int64,
                                             device=self.device))
        self.encode = self.teacher_encode = self.generate = None

    def refresh(self) -> None:
        """Build the encodes and the decode from the models' current
        weights. On the card each is captured per batch signature at its
        first call (``jit=True``, as navc_tpu's); the old ones' graphs go
        with them, so no graph replays the addresses of stale weights."""
        self.encode = make_encode_fn(self.cfg, self.model)
        self.teacher_encode = (make_encode_fn(self.teacher_cfg, self.teacher_model)
                               if self.teacher_model is not None else None)
        if self.cfg.decoding_type == "NARFormer":
            self.generate = make_nar_generator(self.cfg, self.model, self.teacher_model,
                                               collect=self.collect)
        else:
            self.generate = make_ar_generator(self.cfg, self.model)

    def decode_batch(self, batch):
        """(hyp numpy, scores, enc, collected, gen_time): ``gen_time`` times
        only the decode call and its host copy (reference run.py:130-143);
        ``collected`` is the NAR collect mode's (iteration tokens, iteration
        probs), each (B, T, max_len), else None."""
        if self.generate is None:
            self.refresh()
        feats = [torch.as_tensor(batch["feats_%s" % ch]).to(self.device)
                 for ch in self.cfg.modality.lower()]
        category = (torch.as_tensor(batch["category"]).to(self.device)
                    if self.cfg.with_category else None)
        enc = self.encode(feats)
        scores = collected = None
        if self.cfg.decoding_type == "NARFormer":
            tenc = None if self.teacher_encode is None else self.teacher_encode(feats)
            t0 = time.perf_counter()
            hyp = self.generate(enc, category, tenc, self.dict_mapping)
            if self.collect:
                hyp, collected = hyp
        else:
            t0 = time.perf_counter()
            hyp, scores = self.generate(enc, category)
        hyp = hyp.cpu().numpy()  # the host sync belongs to the timed region
        return hyp, scores, enc, collected, time.perf_counter() - t0


def run_eval(cfg: Config, evaluator: Evaluator, loader, vocab,
             scorer: Optional[COCOScorer] = None, no_score: bool = False,
             analyze: bool = False, print_sent: bool = False,
             collect_path: Optional[str] = None) -> Dict[str, Any]:
    """Decode ``loader``'s split and score it: the COCO metrics, their
    weighted 'Sum', the NAR length loss, and with ``analyze`` the caption
    statistics (reference run.py:99-246). With ``collect_path`` an AR
    evaluator pickles {video: [{caption, score}, ...]} (every beam
    hypothesis, run.py:126) and returns only the count; a collecting NAR
    evaluator pickles [{video: per-iteration sentences}, {video:
    per-iteration probs}] and still scores."""
    evaluator.refresh()
    scorer = scorer or COCOScorer()
    gt_captions = loader.dataset.get_references()
    pred_captions: Dict[str, list] = defaultdict(list)
    best_candidate_sents: Dict[str, list] = defaultdict(list)
    best_candidate_score: Dict[str, list] = defaultdict(list)
    # AR captions are collected whenever a path is given, topk 1 included
    # (reference run.py:126)
    collect_ar = (cfg.decoding_type == "ARFormer" and evaluator.collect is False
                  and collect_path is not None)
    all_time = 0.0
    n_batches = 0
    length_loss_sum, length_loss_n = 0.0, 0

    for batch in loader:
        if n_batches == 0 and cfg.batch_size == 1:
            evaluator.decode_batch(batch)  # warm-up outside the timed region
        hyp, hyp_scores, enc, collected, gen_time = evaluator.decode_batch(batch)
        all_time += gen_time
        n_batches += 1

        if collected is not None:
            iter_toks, iter_probs = (c.cpu().numpy() for c in collected)
            for k in range(batch["num_valid"]):
                vid = batch["video_ids"][k]
                for t in range(iter_toks.shape[1]):
                    best_candidate_sents[vid].append(to_sentence(iter_toks[k, t], vocab))
                    best_candidate_score[vid].append(iter_probs[k, t].tolist())
        hyp3 = hyp[:, None, :] if hyp.ndim == 2 else hyp  # (B, L) or n-best
        scores3 = None
        if hyp_scores is not None:
            scores3 = hyp_scores.cpu().numpy()
            if scores3.ndim == 1:
                scores3 = scores3[:, None]

        if collect_ar and scores3 is not None:
            for k in range(batch["num_valid"]):
                vid = batch["video_ids"][k]
                for j in range(hyp3.shape[1]):
                    pred_captions[vid].append({
                        "caption": to_sentence(hyp3[k, j], vocab),
                        "score": float(scores3[k, j])})

        if cfg.decoding_type == "NARFormer" and "length_target" in batch:
            dev = enc["pred_length"].device
            ll = kl_length_loss(enc["pred_length"],
                                torch.as_tensor(batch["length_target"]).to(dev),
                                torch.as_tensor(batch["valid_mask"]).to(dev))
            length_loss_sum += float(ll) * batch["num_valid"]
            length_loss_n += batch["num_valid"]

        if not collect_ar:
            if not no_score and hyp3.shape[1] != 1:
                # the reference asserts one hypothesis per video when
                # scoring (run.py:158)
                raise ValueError(
                    "scoring requires topk == 1 (got %d hypotheses/video); "
                    "use no_score or collect mode" % hyp3.shape[1])
            for k in range(batch["num_valid"]):
                vid = batch["video_ids"][k]
                for j in range(hyp3.shape[1]):
                    sent = to_sentence(hyp3[k, j], vocab)
                    # 4-gram dedup only when asked (reference run.py:163)
                    if cfg.duplicate and cfg.decoding_type == "NARFormer":
                        sent, _ = duplicate(sent)
                    if print_sent:
                        print("%s: %s" % (vid, sent))
                    pred_captions[vid].append({"image_id": vid, "caption": sent})

    if collect_path is not None:
        with open(collect_path, "wb") as f:
            if collect_ar:
                pickle.dump(dict(pred_captions), f)
            else:
                pickle.dump([dict(best_candidate_sents), dict(best_candidate_score)], f)
        if collect_ar:
            return {"collected": len(pred_captions)}

    res: Dict[str, Any] = {}
    if cfg.batch_size == 1 and n_batches:
        res["latency"] = all_time / n_batches
    if analyze:
        ave_length, novel, unique, usage, _, gram4 = analyze_length_novel_unique(
            loader.dataset.captions, pred_captions, vocab,
            splits=loader.dataset.splits, n=1)
        res.update({"ave_length": ave_length, "novel": novel, "unique": unique,
                    "usage": usage, "gram4": gram4})
    if not no_score:
        valid_score, _ = scorer.score(gt_captions, pred_captions, pred_captions.keys())
        res.update(valid_score)
        candidate = [res["Bleu_4"], res["METEOR"], res["ROUGE_L"], res["CIDEr"]]
        res["Sum"] = sum(v for i, v in enumerate(candidate) if cfg.metric_sum[i])
        if length_loss_n:
            res["Length Loss"] = length_loss_sum / length_loss_n
    return res
