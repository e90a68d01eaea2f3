"""High-level inference API: checkpoint -> captions.

Port of navc_tpu/api.py: a serving façade over the decode stack. It loads a
self-describing ``.ckpt`` (and the optional AR teacher for NACF/NAB
rescoring) onto a device, builds the decode once, and captions batches of
pre-extracted features. Weights live in the models, so the pipeline takes
no ``variables``; ``device`` says where they live ("cuda" unless the
caller asks for the CPU).

Example:
    pipe = CaptionPipeline.from_checkpoints("best.ckpt", teacher="arb.ckpt",
                                            info_corpus="info_corpus.pkl")
    sentences = pipe.caption({"feats_i": fi, "feats_m": fm}, category=cats)
"""

from __future__ import annotations

import pickle
from typing import Dict, List, Optional

import numpy as np

from .config import Config
from .runtime.checkpoint import load_model_and_config
from .runtime.evaluate import Evaluator
from .runtime.sentence import duplicate, get_dict_mapping, to_sentence


class CaptionPipeline:
    def __init__(self, model, cfg: Config, vocab: Dict[int, str],
                 teacher_model=None, teacher_cfg: Optional[Config] = None,
                 dict_mapping: Optional[np.ndarray] = None,
                 use_pallas: Optional[bool] = None, dedup_ngrams: bool = True):
        if use_pallas is not None:
            cfg = cfg.replace(use_pallas=use_pallas)
        self.cfg = cfg
        self.vocab = vocab
        self.dedup_ngrams = dedup_ngrams
        self.evaluator = Evaluator(cfg, model, teacher_cfg, teacher_model, dict_mapping)

    # ------------------------------------------------------------------
    @classmethod
    def from_checkpoints(cls, model_path: str, teacher: Optional[str] = None,
                         info_corpus: Optional[str] = None,
                         use_pallas: Optional[bool] = None, device="cuda",
                         **kw) -> "CaptionPipeline":
        """The model (and teacher) of navc_tpu ``.ckpt`` files on
        ``device``; the vocabulary from ``info_corpus`` or the checkpoint's
        own corpus path; the student -> teacher id map when the teacher's
        corpus has another vocabulary (reference misc/utils.py:33-51)."""
        model, cfg, _ = load_model_and_config(model_path, device=device)
        tm = tc = None
        dict_mapping = None
        student_corpus = None
        vocab: Dict[int, str] = {}
        corpus_path = info_corpus or cfg.info_corpus
        if corpus_path:
            with open(corpus_path, "rb") as f:
                student_corpus = pickle.load(f)
            vocab = student_corpus["info"]["itow"]
        if teacher:
            tm, tc, _ = load_model_and_config(teacher, device=device)
            # teacher rescoring indexes teacher logits with student ids: a
            # teacher trained on another vocabulary needs the id remap
            if student_corpus is not None and tc.info_corpus:
                with open(tc.info_corpus, "rb") as f:
                    teacher_corpus = pickle.load(f)
                dict_mapping = get_dict_mapping(cfg, tc, student_corpus, teacher_corpus)
        return cls(model, cfg, vocab, tm, tc, dict_mapping=dict_mapping,
                   use_pallas=use_pallas, **kw)

    # ------------------------------------------------------------------
    def caption_ids(self, feats: Dict[str, np.ndarray],
                    category: Optional[np.ndarray] = None) -> np.ndarray:
        """(B,) batches of features -> (B, max_len) token ids."""
        b = next(iter(feats.values())).shape[0]
        batch: Dict[str, np.ndarray] = {
            k: np.asarray(v, np.float32) for k, v in feats.items()}
        batch["category"] = (np.asarray(category, np.int32).reshape(b, 1)
                             if category is not None
                             else np.zeros((b, 1), np.int32))
        hyp = self.evaluator.decode_batch(batch)[0]
        if hyp.ndim == 3:
            # AR checkpoints saved with topk > 1 return the (B, topk, L)
            # n-best in descending score; one caption per item: the best
            hyp = hyp[:, 0]
        return hyp

    def caption(self, feats: Dict[str, np.ndarray],
                category: Optional[np.ndarray] = None) -> List[str]:
        """(B,) batches of features -> list of caption strings."""
        assert self.vocab, "a vocabulary (info_corpus) is required for text"
        out = []
        for row in self.caption_ids(feats, category):
            sent = to_sentence(row, self.vocab)
            if self.cfg.decoding_type == "NARFormer" and self.dedup_ngrams:
                sent, _ = duplicate(sent)
            out.append(sent)
        return out
