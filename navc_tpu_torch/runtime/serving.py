"""Pipelined streaming inference over a stream of requests.

Port of navc_tpu/runtime/serving.py. ``submit`` enqueues one request's
encode + decode on the card and returns at once (CUDA launches are
asynchronous); the host waits for request i — its ``.cpu()`` copy — only
after requests i+1 .. i+depth are in flight, so the host's work on one
request overlaps the card's on the next. Results still come back strictly
in submission order. ``depth=0`` is the reference's sequential protocol
(translate.py:149-151).

NAR models decode by mask-predict (optionally with an AR teacher's
rescoring), AR models (ARB, ARB2) by beam search; a request's result is the
(B, max_len) or (B, max_len - 1) token ids of one caption per video. On the
card the encodes and the decode replay CUDA graphs (``jit=True``,
``runtime/graphs.py``), and each request's features reach the card through
page-locked buffers, one set per request in flight, copied asynchronously.
"""

from __future__ import annotations

import collections
import time
from typing import Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..decoding import make_ar_generator, make_nar_generator
from ..device import resolve_device
from . import graphs


def make_encode_fn(cfg: Config, model, jit: bool = True):
    """Encode-only forward for decoding (reference run.py:59 only_data).
    ``jit``: on the card a CUDA graph per feature signature, as navc_tpu's
    encode is ``jax.jit``-ed (``runtime/graphs.py``); it reads the model's
    weights where they lie, so an update in place reaches it."""

    @torch.no_grad()
    def encode(feats):
        return model.encode(feats)

    return graphs.Jitted(encode) if jit else encode


class StreamingCaptioner:
    """Bounded-depth pipelined captioning over a stream of requests.

    cfg, model: the model (any ported method), weights in the model.
    teacher: optional (teacher_cfg, teacher_model) for NAR teacher
        rescoring (reference algorithms.py:136-204); AR models take none.
    dict_mapping: optional student->teacher vocab id map.
    depth: max requests in flight before ``submit`` waits on the oldest.
    device: where the models live and the requests run; "cuda" unless the
        caller asks for the CPU.
    jit: the encodes and the decode as CUDA graphs on the card (False: the
        eager route, every op issued from the host).
    """

    def __init__(self, cfg: Config, model, teacher: Optional[tuple] = None,
                 dict_mapping: Optional[np.ndarray] = None, depth: int = 2,
                 device="cuda", jit: bool = True):
        self.device = resolve_device(device)
        self.ar = cfg.decoding_type != "NARFormer"
        if self.ar:
            teacher = None
        for m in (model,) + (() if teacher is None else (teacher[1],)):
            dev = next(m.parameters()).device
            if dev.type != self.device.type:
                raise ValueError("model on %s, captioner on %s"
                                 % (dev, self.device))
        self.cfg = cfg
        self.depth = max(0, int(depth))
        self._encode = make_encode_fn(cfg, model, jit)
        self._teacher_encode = (None if teacher is None
                                else make_encode_fn(teacher[0], teacher[1], jit))
        self._dict_mapping = (None if dict_mapping is None else
                              torch.as_tensor(dict_mapping, device=self.device))
        # the decode; its ``steps_run`` counts an AR decode's beam steps
        self.generate = (make_ar_generator(cfg, model, jit) if self.ar else
                         make_nar_generator(
                             cfg, model, None if teacher is None else teacher[1], jit))
        self._staging = (graphs.PinnedSlots(self.depth + 1)
                         if self.device.type == "cuda" else None)
        self._inflight = collections.deque()  # (ticket, device hyp)
        self._next_ticket = 0

    # -- pipeline core ----------------------------------------------------

    def _dispatch(self, feats, category):
        with_cat = self.cfg.with_category and category is not None
        if self._staging is None:
            feats = [torch.as_tensor(f, dtype=torch.float32) for f in feats]
            cat = torch.as_tensor(category) if with_cat else None
        else:
            arrays = [np.asarray(f, dtype=np.float32) for f in feats]
            arrays += [np.asarray(category)] if with_cat else []
            staged = self._staging.to_device(arrays, self.device)
            feats, cat = staged[:len(feats)], (staged[-1] if with_cat else None)
        enc = self._encode(feats)
        # device tensors, not synced: they stay in flight
        if self.ar:
            hyp, _ = self.generate(enc, cat)
            return hyp
        tenc = None if self._teacher_encode is None else self._teacher_encode(feats)
        return self.generate(enc, cat, tenc, self._dict_mapping)

    @staticmethod
    def _sync(hyp: torch.Tensor) -> np.ndarray:
        return hyp.cpu().numpy()

    def submit(self, feats, category=None) -> Tuple[int, List[Tuple[int, np.ndarray]]]:
        """Enqueue one request. Returns (ticket, completed): ``completed``
        holds any (ticket, hypotheses) forced out of the pipeline to respect
        ``depth`` — in submission order."""
        ticket = self._next_ticket
        self._next_ticket += 1
        self._inflight.append((ticket, self._dispatch(feats, category)))
        done = []
        while len(self._inflight) > self.depth:
            t, hyp = self._inflight.popleft()
            done.append((t, self._sync(hyp)))
        return ticket, done

    def flush(self) -> List[Tuple[int, np.ndarray]]:
        """Sync every in-flight request, in submission order."""
        done = []
        while self._inflight:
            t, hyp = self._inflight.popleft()
            done.append((t, self._sync(hyp)))
        return done

    # -- conveniences ------------------------------------------------------

    def map_stream(self, requests: Iterable[tuple]) -> Iterator[np.ndarray]:
        """Hypotheses for an iterable of (feats, category) requests, in
        order, keeping ``depth`` requests in flight."""
        for req in requests:
            feats, category = req if isinstance(req, tuple) else (req, None)
            _, done = self.submit(feats, category)
            for _, hyp in done:
                yield hyp
        for _, hyp in self.flush():
            yield hyp

    def timed_stream(self, requests: List[tuple]) -> Tuple[List[np.ndarray], float]:
        """(results, mean host seconds per request) of a request list."""
        t0 = time.perf_counter()
        out = list(self.map_stream(requests))
        return out, (time.perf_counter() - t0) / max(1, len(out))
