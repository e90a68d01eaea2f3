"""Beam search over the MLAMoE language model (``models/mla_moe.py``), with
each caption token's log-probability.

``make_ar_generator`` hands a configuration whose decoder is the MLAMoE
language model (``Config.is_lm``) to ``make_lm_generator``. The beam's
semantics are ARB's (``beam.py``: ``choose`` and ``advance``, the
first-best ranking by score / length**alpha); what differs is the step:

  * prefill: the P prefix positions of each video (the encoder's outputs)
    go once through every layer, which leaves the per-video latent cache
    (layers, B, P, 576), shared by the video's K beam rows, never copied
    per beam;
  * each step t: one position per beam row (the last token, at sequence
    position P + t - 1) through every layer against the prefix cache and
    the rows' caption cache (B * K, layers, max_len - 1, 576), whose
    position t - 1 the step writes (``MLAMoELM.decode_step``, absorbed
    attention); the caption cache follows beam ancestry by a row gather
    (``index_select``) after the choice;
  * the projection and the k best log-probs of every row: with the
    kernels (``cfg.use_pallas``, bf16, ``NAVC_NO_TOPK_KERNEL`` off) K5
    (``project_topk``, its streamed walk at D > 768), which writes no
    logits; else float32 logits of the (B * K, V) rows and their
    log-softmax's k best by ``torch.topk`` (the k re-sorted by value, then
    lower id, K5's and ``lax.top_k``'s order; a tie across the k-th place
    is left to ``torch.topk``).

The beam rows carry each chosen token's log-probability beside the token:
the state's ``seqs`` are (B, K, 2 * max_len) int32, the tokens then the
float32 bits of their log-probabilities, so ancestry, the finished
snapshots and the ranking move both alike. The routed tokens per expert are
summed on the device over the prefill and the steps.

``generate(enc_results, category=None) -> (hypotheses (B, max_len - 1)
int32, scores (B,), log-probabilities (B, max_len - 1) float32, tokens per
expert (MoE layers, E) int32)``; ``category`` is not read. With ``jit``
on the card the prefill is one CUDA graph (``graphs.Jitted``, in the
``navc.prefill`` span) and the steps ``graphs.JittedLoop`` blocks of
``block`` steps under ``graphs.lagged_blocks``, as ARB's.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from .. import constants as C
from ..config import Config
from ..runtime import graphs, summary
from ..ops.eligibility import fused_vocab_eligible
from ..ops.vocab_fused import MAX_D_TOPK, MAX_K, project_topk
from .beam import (DONE_LAG, NEG_BIG, BeamState, Switches, _BeamLoop, advance, block_spans,
                   choose)


def topk_logprobs(logits: torch.Tensor, k: int):
    """(log-probs (R, k) descending, ids (R, k) int32) of the k best
    entries of log_softmax(logits), lower id first among equal values
    inside the k."""
    m = logits.amax(-1, keepdim=True)
    lse = torch.log(torch.exp(logits - m).sum(-1, keepdim=True))
    top, ids = torch.topk(logits, k, dim=-1)
    ids, by_id = ids.sort(-1)
    top, by_val = top.gather(-1, by_id).sort(dim=-1, descending=True, stable=True)
    return (top - m) - lse, ids.gather(-1, by_val).to(torch.int32)


class _LMLoop(_BeamLoop):
    """``beam._BeamLoop`` whose head takes the prefill's outputs (the prefix
    cache and its tokens per expert, in the places of the encoder output
    and the category) and whose tail adds the tokens per expert the carry
    summed."""

    def tail(self):
        return self.finish(self.state) + (self.carry[-1],)


def make_lm_generator(cfg: Config, model, jit: bool = True, *, block: int = DONE_LAG):
    """The batched beam search over ``model`` (a ``CaptionLM``); see the
    module docstring. ``NAVC_NO_TOPK_KERNEL`` is read here, once.
    ``generate.topk_kernel`` says whether the steps project through K5,
    ``generate.steps_run`` counts the steps run,
    ``generate.graphs`` holds the step loop's captured sets,
    ``generate.prefill_graphs`` the prefill's, and
    ``generate.token_logprobs`` is True (the captioner returns the
    log-probabilities beside the tokens)."""
    lm = model.lm
    k, max_len = cfg.beam_size, cfg.max_len
    specific = max(k, cfg.topk)
    alpha = cfg.beam_alpha
    spans = block_spans(max_len, block)
    d = cfg.dim_hidden
    topk_kernel = (fused_vocab_eligible(cfg) and cfg.compute_dtype == "bfloat16"
                   and k <= MAX_K and d % 16 == 0 and d <= MAX_D_TOPK
                   and not Switches.read().no_topk)

    @torch.no_grad()
    def prefill(enc_output: torch.Tensor):
        return lm.prefill(enc_output)

    def start(prefix: torch.Tensor, counts: torch.Tensor):
        dev = prefix.device
        b = prefix.shape[1]
        n = b * k
        i32 = dict(dtype=torch.int32, device=dev)
        seqs = torch.zeros((b, k, 2 * max_len), **i32)
        seqs[:, :, 0] = C.BOS
        scores = torch.full((b, k), NEG_BIG, dtype=torch.float32, device=dev)
        scores[:, 0] = 0.0
        state = BeamState(
            seqs=seqs, scores=scores,
            fin_seqs=torch.zeros((b, specific, 2 * max_len), **i32),
            fin_scores=torch.zeros((b, specific), dtype=torch.float32, device=dev),
            fin_lens=torch.zeros((b, specific), **i32),
            fin_count=torch.zeros((b,), **i32),
            done=torch.zeros((b,), dtype=torch.bool, device=dev))
        caption = torch.zeros((n, prefix.shape[0], max_len - 1, prefix.shape[-1]),
                              dtype=prefix.dtype, device=dev)
        last = torch.full((b, k), C.BOS, **i32)
        slot = torch.arange(k, **i32)[None, None, :]
        pos = torch.arange(2 * max_len, device=dev)[None, None, :]
        rows = torch.arange(b, device=dev)[:, None] * k

        def step(carry, t):
            state, last, caption, counts = carry
            hidden, routed = lm.decode_step(last.reshape(n), t, prefix, caption, k)
            if topk_kernel:
                wp_k, ids_k = project_topk(lm.head_input(hidden).contiguous(),
                                           lm.lm_head.weight, k)
            else:
                wp_k, ids_k = topk_logprobs(lm.logits(hidden), k)
            best_scores, best_flat, prev_k, next_word = choose(state, last, wp_k, ids_k, slot)
            chosen_lp = torch.gather(wp_k.view(b, k * k), 1, best_flat)
            caption = caption.index_select(0, (rows + prev_k).reshape(n))
            reordered = torch.gather(
                state.seqs, 1, prev_k.long()[:, :, None].expand(b, k, 2 * max_len))
            new_seqs = torch.where(pos == t, next_word[:, :, None], reordered)
            new_seqs = torch.where(pos == max_len + t,
                                   chosen_lp.view(torch.int32)[:, :, None], new_seqs)
            st = advance(state, new_seqs, next_word, best_scores, t,
                         t == max_len - 1, specific)
            return st, next_word, caption, counts + routed

        return step, (state, last, caption, counts.clone())

    def finish(state: BeamState):
        """The first best by score / length**alpha (Beam.py:123-130):
        (tokens, score, token log-probabilities)."""
        b = state.fin_count.shape[0]
        dev = state.fin_count.device
        valid = (torch.arange(specific, device=dev)[None, :]
                 < state.fin_count[:, None])
        norm = state.fin_scores / torch.pow(
            state.fin_lens.clamp(min=1).to(torch.float32), alpha)
        norm = torch.where(valid, norm, -math.inf)
        rows = torch.arange(b, device=dev)
        best = norm.argmax(1)
        seq = state.fin_seqs[rows, best]
        return (seq[:, 1:max_len], norm[rows, best],
                seq[:, max_len + 1:].contiguous().view(torch.float32))

    def make_loop(prefix, counts):
        return _LMLoop(start, finish, spans, prefix, counts)

    prefill_fn = graphs.Jitted(prefill) if jit else prefill
    jitted = graphs.JittedLoop(make_loop)

    @torch.no_grad()
    def generate(enc_results: Dict[str, torch.Tensor],
                 category: Optional[torch.Tensor] = None):
        enc_output = enc_results["enc_output"]
        with summary.span("navc.prefill"):
            prefix, counts = prefill_fn(enc_output)
        if jit:
            out, blocks, _ = jitted(prefix, counts)
        else:
            out, blocks, _ = graphs.run_loop(make_loop(prefix, counts),
                                             pinned=prefix.device.type == "cuda")
        generate.steps_run += sum(t1 - t0 for t0, t1 in spans[:blocks])
        return out

    generate.steps_run = 0
    generate.graphed = jit
    generate.graphs = jitted.graphs
    generate.prefill_graphs = prefill_fn.graphs if jit else {}
    generate.token_logprobs = True
    generate.topk_kernel = topk_kernel
    return generate
