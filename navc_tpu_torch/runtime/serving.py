"""Pipelined streaming inference over a stream of requests.

Port of navc_tpu/runtime/serving.py. ``submit`` enqueues one request's
encode + decode on the card and returns at once (CUDA launches are
asynchronous); the host waits for request i only after requests
i+1 .. i+depth are queued. On the card each request's tokens come back
through a copy of their own into page-locked memory, queued right behind
its decode, with an event after it: reading request i waits for that event
alone, not for the newer requests queued behind it, so the host stages the
next request while the card still runs them (``navc.inflight_at_result``
below counts them). Results come back strictly in submission order.
``depth=0`` is the reference's sequential protocol (translate.py:149-151).

NAR models decode by mask-predict (optionally with an AR teacher's
rescoring), AR models (ARB, ARB2) by beam search; a request's result is the
(B, max_len) or (B, max_len - 1) token ids of one caption per video. The
MLAMoE language model (``cfg.is_lm``) decodes by the same beam search over
a prefilled latent cache (``decoding/lm_beam.py``), and its result is the
pair (token ids (B, max_len - 1), their log-probabilities, float32, the
same shape), both copied back behind the decode as the tokens are. On the
card the encodes and the decode replay CUDA graphs (``jit=True``,
``runtime/graphs.py``), and each request's features reach the card through
page-locked buffers, one set per request in flight, copied asynchronously.

While a profile records, a request's host work lies in ``summary.span``s
that carry its ticket: ``navc.submit`` (the root), ``navc.stage``,
``navc.encode``, ``navc.teacher_encode``, ``navc.decode`` (the language
model's ``navc.prefill`` inside it: the host issuing the prefill), then
``navc.result`` (the host waiting for its tokens) and ``navc.flush``. On the
card it also records two CUDA events a request, one before its features'
copy to the card and one after its tokens' copy back is queued. Once its
tokens are on the host these are complete, and the captioner counts in the
record

* ``navc.request_gap_s``: the device seconds between the previous request's
  end and this one's start (the card idle, waiting for the request);
* ``navc.inflight_at_result``: how many of the newer requests in flight had
  not finished on the card, one count per result read;
* ``navc.moe.expert_tokens`` (the language model, each result read while a
  profile records): the tokens routed to each expert of each MoE layer in
  the request's prefill and steps, an (MoE layers, experts) array, summed
  on the card and copied back with the tokens;
* ``navc.walk.live_rows`` (NAR models on the card, each result read while a
  profile records): the live rows the request's decode walked in K1 and K2
  (``ops/fused_layer.walk_rows``, zeroed before the decode and copied back
  with the tokens) as its total, the rows a walk without its plan takes as
  its count: the counter's mean is the share of the walk's rows computed.
"""

from __future__ import annotations

import collections
from typing import Any, Iterable, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..decoding import make_ar_generator, make_nar_generator
from ..device import resolve_device
from ..ops.fused_layer import walk_rows
from . import graphs, summary


class _OnHost(NamedTuple):
    """A card request's result on its way to page-locked memory: the
    buffer (or the language model's buffers) and the event after the copy."""
    host: Any
    copied: Any


def _pinned_copy(x: torch.Tensor) -> torch.Tensor:
    """``x``'s copy into a new page-locked buffer, queued on the stream."""
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x, non_blocking=True)
    return host


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
        self._lm = self.ar and cfg.is_lm
        self.generate = (make_ar_generator(cfg, model, jit) if self.ar else
                         make_nar_generator(
                             cfg, model, None if teacher is None else teacher[1], jit))
        self._staging = (graphs.PinnedSlots(self.depth + 1)
                         if self.device.type == "cuda" else None)
        # the NAR decode's running count of walked rows, made before any capture
        self._walk = (walk_rows(self.device)
                      if not self.ar and self._staging is not None else None)
        self._inflight = collections.deque()  # (ticket, hyp or its host copy, marks)
        self._next_ticket = 0
        self._last_end: Optional[torch.cuda.Event] = None  # the last result's end mark

    # -- pipeline core ----------------------------------------------------

    def _dispatch(self, feats, category):
        """Stages and queues one request: (its hyp on the CPU, or on the card
        (page-locked host buffer, event after the copy into it); its (start,
        end) CUDA events, or None where none are recorded)."""
        with_cat = self.cfg.with_category and category is not None
        marks = None
        with summary.span("navc.stage"):
            if self._staging is None:
                feats = [torch.as_tensor(f, dtype=torch.float32) for f in feats]
                cat = torch.as_tensor(category) if with_cat else None
            else:
                if summary.recording():
                    marks = tuple(torch.cuda.Event(enable_timing=True) for _ in range(2))
                arrays = [np.asarray(f, dtype=np.float32) for f in feats]
                arrays += [np.asarray(category)] if with_cat else []
                staged = self._staging.to_device(arrays, self.device,
                                                 start=None if marks is None else marks[0])
                feats, cat = staged[:len(feats)], (staged[-1] if with_cat else None)
        with summary.span("navc.encode"):
            enc = self._encode(feats)
        # device tensors, not synced: they stay in flight
        if self.ar:
            with summary.span("navc.decode"):
                hyp = self.generate(enc, cat)
            # the language model's: tokens, their log-probabilities, tokens per expert
            hyp = (hyp[0], hyp[2], hyp[3]) if self._lm else hyp[0]
        else:
            tenc = None
            if self._teacher_encode is not None:
                with summary.span("navc.teacher_encode"):
                    tenc = self._teacher_encode(feats)
            if marks is not None:
                self._walk.zero_()
            with summary.span("navc.decode"):
                hyp = self.generate(enc, cat, tenc, self._dict_mapping)
            if marks is not None:
                hyp = (hyp, self._walk)  # the count copied back with the tokens
        if self._staging is not None:
            # the tokens' own copy, behind this decode: reading them waits
            # for the event after it (the end mark where one is taken), not
            # for the requests queued later
            host = (tuple(map(_pinned_copy, hyp)) if isinstance(hyp, tuple)
                    else _pinned_copy(hyp))
            copied = torch.cuda.Event() if marks is None else marks[1]
            copied.record()
            hyp = _OnHost(host, copied)
        return hyp, marks

    @staticmethod
    def _sync(hyp) -> np.ndarray:
        """A request's tokens as an array the caller owns: a CPU tensor's
        own, or a card request's copied out of its page-locked buffer (which
        goes back to torch's pinned cache) once that copy has run. The
        language model's request: (tokens, log-probabilities, tokens per
        expert), each so."""
        if isinstance(hyp, _OnHost):
            hyp.copied.synchronize()
            if isinstance(hyp.host, tuple):
                return tuple(x.numpy().copy() for x in hyp.host)
            return hyp.host.numpy().copy()
        if isinstance(hyp, tuple):
            return tuple(x.cpu().numpy() for x in hyp)
        return hyp.cpu().numpy()

    def _complete(self) -> Tuple[int, np.ndarray]:
        """The oldest request's (ticket, hypotheses), its marks counted."""
        ticket, hyp, marks = self._inflight.popleft()
        with summary.span("navc.result", ticket):
            out = self._sync(hyp)
        if self._lm:
            tokens, logprobs, expert_tokens = out
            if summary.recording():
                summary.count("navc.moe.expert_tokens", expert_tokens.astype(np.int64))
            out = (tokens, logprobs)
        elif not self.ar and marks is not None:  # a NAR decode's, with its walked rows
            out, (live, dense) = out
            if dense:
                summary.count("navc.walk.live_rows", int(live), int(dense))
        if marks is not None:
            if self._last_end is not None:
                summary.count("navc.request_gap_s",
                              self._last_end.elapsed_time(marks[0]) / 1e3)
            summary.count("navc.inflight_at_result",
                          sum(not m[1].query() for _, _, m in self._inflight if m))
        self._last_end = None if marks is None else marks[1]
        return ticket, out

    def submit(self, feats, category=None) -> Tuple[int, List[Tuple[int, np.ndarray]]]:
        """Enqueue one request. Returns (ticket, completed): ``completed``
        holds any (ticket, hypotheses) forced out of the pipeline to respect
        ``depth`` — in submission order."""
        ticket = self._next_ticket
        self._next_ticket += 1
        with summary.span("navc.submit", ticket):
            self._inflight.append((ticket, *self._dispatch(feats, category)))
            done = []
            while len(self._inflight) > self.depth:
                done.append(self._complete())
        return ticket, done

    def flush(self) -> List[Tuple[int, np.ndarray]]:
        """Sync every in-flight request, in submission order."""
        with summary.span("navc.flush"):
            return [self._complete() for _ in range(len(self._inflight))]

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
