"""Autoregressive beam search (the ARB and ARB2 methods' decoding).

Port of navc_tpu/decoding/beam.py (reference models/Beam.py +
models/Translator.py). Semantics kept exactly:
  * step 1 draws the top-k from beam slot 0 only (Beam.py:78-79): slots
    1..k-1 start at -1e20, so slot 0's candidates win the generic step;
  * beams whose last token is EOS have their whole candidate row set to
    -1e20 and their candidate ids pinned to 0..k-1 (Beam.py:74-77 + the
    flat top-k's tie order);
  * an instance finishes once max(beam, topk) hypotheses are collected,
    scanning beam slots in order (Beam.py:95-99);
  * at max_len, instances with no finished hypothesis take every beam slot
    (Beam.py:111-116);
  * the final ranking is score / length**alpha, the first best on ties
    (Beam.py:123-130).
Every ``lax.top_k`` of the JAX package is a stable descending sort here.

Configurations inside ``kv_cached_beam_eligible`` decode one new position
per step from a K/V cache (``_make_cached_step``); the others (and every
configuration under navc_tpu's ``NAVC_NO_KVCACHE`` switch) recompute the
whole prefix each step: on the card through the fused layer (K1, causal,
``static=`` the position + category rows, the cross K/V hoisted once per
decode) where ``fused_layer_eligible(cfg, causal=True)``, as navc_tpu's
full-prefix step runs it on the device (``prefix_hidden``), else, and on
the CPU, with the model's own ARFormer forward. With ``cfg.use_pallas``
the cached step runs the hand-written kernels, on navc_tpu's routes: the
projection + top-k (K5) every step; when the batch is a multiple of 16 and
the width of 128 (the structural terms of navc_tpu's gate), the fused
permute + append + self-attention step (K6) and the cross-attention (K7);
otherwise the cache permute (K8) and the plain attention of both kinds, as
navc_tpu's XLA route computes them (bf16 softmax weights in bf16 mode). The
dense projections stay ``torch.matmul``. navc_tpu's kernel switches take
kernels off this route (``Switches``, ``plan_routes``), with navc_tpu's
precedence (beam.py:373-402): ``NAVC_NO_ATTEND_KERNEL`` drops K6 and K7
with it, and the step then permutes through K8 unless
``NAVC_NO_PERMUTE_KERNEL`` is set too; ``NAVC_NO_TOPK_KERNEL`` drops K5,
and the step projects raw logits and takes their stable top-k. A generator
reads them when it is made.

The JAX package stops its ``while_loop`` once every instance is done. Here
the host reads that flag without stalling the card. With ``jit=True`` (the
default, navc_tpu's ``jax.jit``) the steps run in blocks of DONE_LAG, each
a CUDA graph on the card, and block j's flag is read after block j + 1 is
queued (``graphs.lagged_blocks``, eager on the CPU). With ``jit=False`` each
step is issued from the host and queues a copy of the flag to pinned
memory, and step t waits only for the flag of step t - DONE_LAG (the card
still has the steps in between queued); on the CPU the lag is 0. Steps
after every instance is done change nothing — done instances are frozen —
so the tokens are those of the exact early exit. The generator counts the steps
it ran in ``generate.steps_run``.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import os
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from .. import constants as C
from ..config import Config
from ..models.layers import ACT2FN, MASK_FILL
from ..ops.beam_attend import (beam_attend_eligible, beam_attend_step,
                               cross_attend, kernel_shape_ok)
from ..ops.beam_permute import permute_beam_caches, permute_beam_caches_plain
from ..ops.eligibility import (fused_layer_eligible, fused_vocab_eligible,
                               kv_cached_beam_eligible)
from ..ops.fused_layer import LayerWeights, fused_layer, layer_weights
from ..ops.select import top_k_stable
from ..ops.vocab_fused import MAX_D, MAX_K, project_topk, projection_weights
from ..runtime import graphs
from .length_beam import enlarge
from .operands import KernelOperands

NEG_BIG = -1e20
DONE_LAG = 4  # steps between queuing the all-done flag and reading it


class BeamState(NamedTuple):
    seqs: torch.Tensor        # (B, K, L) int32; pos 0 = BOS, step t writes pos t
    scores: torch.Tensor      # (B, K) float32 cumulative log-probs
    fin_seqs: torch.Tensor    # (B, F, L) snapshots at finish time
    fin_scores: torch.Tensor  # (B, F)
    fin_lens: torch.Tensor    # (B, F) int32 hypothesis length (incl. EOS)
    fin_count: torch.Tensor   # (B,) int32
    done: torch.Tensor        # (B,) bool


def _append_finished(state: BeamState, eligible: torch.Tensor,
                     scores: torch.Tensor, seqs: torch.Tensor, t: int,
                     capacity_limit: int) -> BeamState:
    """Append the eligible (B, K) slots in beam order, up to each row's
    capacity: accepted slot j of row i lands in finished slot fin_count +
    its rank among the accepted (Beam.py:95-99)."""
    f = state.fin_scores.shape[1]
    rank = eligible.cumsum(1, dtype=torch.int32) - 1
    capacity = capacity_limit - state.fin_count
    accept = eligible & (rank < capacity[:, None])
    slot = torch.where(accept, state.fin_count[:, None] + rank, f)
    onehot = slot[:, :, None] == torch.arange(f, device=slot.device)  # (B, K, F)
    written = onehot.any(1)
    upd_scores = torch.where(onehot, scores[:, :, None], 0.0).sum(1)
    upd_seqs = torch.where(onehot[..., None], seqs[:, :, None, :], 0).sum(1)
    return state._replace(
        fin_seqs=torch.where(written[..., None], upd_seqs.to(torch.int32),
                             state.fin_seqs),
        fin_scores=torch.where(written, upd_scores, state.fin_scores),
        fin_lens=torch.where(written, t, state.fin_lens).to(torch.int32),
        fin_count=(state.fin_count + accept.sum(1)).to(torch.int32))


@dataclass
class Routes:
    """Which kernels a cached decode runs (all False on the plain route)."""
    topk: bool = False      # K5: projection + top-k
    cross: bool = False     # K7: cross-attention (with K6, as navc_tpu)
    attend: bool = False    # K6: permute + append + self-attention
    permute: bool = False   # K8: cache permute, then plain self-attention


@dataclass(frozen=True)
class Switches:
    """navc_tpu's beam kernel switches (beam.py:373-402): a non-empty
    ``NAVC_NO_ATTEND_KERNEL``, ``NAVC_NO_PERMUTE_KERNEL`` or
    ``NAVC_NO_TOPK_KERNEL`` in the environment takes its kernel off the
    cached step."""
    no_attend: bool = False
    no_permute: bool = False
    no_topk: bool = False

    @classmethod
    def read(cls) -> "Switches":
        return cls(*(bool(os.environ.get("NAVC_NO_%s_KERNEL" % name))
                     for name in ("ATTEND", "PERMUTE", "TOPK")))


def topk_route(cfg: Config, switches: Switches) -> bool:
    """Does the cached step project through K5 (its shape limits, the
    kernels on, ``NAVC_NO_TOPK_KERNEL`` off)?"""
    h = cfg.dim_hidden
    return (fused_vocab_eligible(cfg) and cfg.beam_size <= MAX_K and h % 16 == 0
            and h <= MAX_D and not switches.no_topk)


def plan_routes(cfg: Config, b: int, switches: Switches) -> Routes:
    """The kernels a KV-cached decode of ``b`` videos runs: K6 (and K7
    with it) where its shapes fit and ``NAVC_NO_ATTEND_KERNEL`` is off,
    else K8 unless ``NAVC_NO_PERMUTE_KERNEL`` is set; K5 by
    ``topk_route``."""
    h = cfg.dim_hidden
    itemsize = 4 if cfg.compute_dtype == "float32" else 2
    attend = (cfg.use_pallas
              and kernel_shape_ok(cfg.beam_size, h, cfg.num_attention_heads, itemsize)
              and beam_attend_eligible(b, h) and not switches.no_attend)
    return Routes(topk=topk_route(cfg, switches), cross=attend, attend=attend,
                  permute=cfg.use_pallas and not attend and not switches.no_permute)


def _make_cached_step(cfg: Config, model, w: LayerWeights, qkv,
                      enc: torch.Tensor, cat_tiled: Optional[torch.Tensor],
                      k: int, routes: Routes):
    """Incremental (KV-cached) decode step for the 1-layer decoder.

    Step t computes only position t-1: its Q/K/V from the embedding of the
    previous token, the cache append, self-attention over the cached keys
    with the -10e6 masking, cross-attention over K/V projected once per
    decode, and the FFN. In bf16 mode ``dense`` mirrors flax
    ``Dense(dtype=bf16)`` (bf16 product, bf16 bias add, then the float32
    cast) and the embedding LayerNorm is flax's fast-variance formula (the
    model's own LayerNorm), as navc_tpu's cached step does.

    ``w`` holds the layer's matrices in the compute dtype, ``qkv`` the
    (matrix, bias) of the Q/K/V projections concatenated (per column the
    same dots as three products, in one launch).

    Returns ``step(seqs_flat, tok, kc, vc, pk, t) -> (out, kc, vc)``: ``out``
    is the hidden state (N, H) when ``routes.topk`` (K5 projects it), else
    the raw logits (N, V); kc, vc are the (N, L*H) caches; pk the previous
    step's ancestry, which K6 applies lazily (unused on other routes).
    """
    emb = model.decoder.embedding
    nh = cfg.num_attention_heads
    h = cfg.dim_hidden
    dh = h // nh
    f32 = cfg.compute_dtype == "float32"
    dt = torch.float32 if f32 else torch.bfloat16
    act = ACT2FN[cfg.hidden_act]
    word = emb.word_embeddings.weight
    pos_table = emb.position_embeddings.weight

    def dense(x, mat, bias):
        if f32:
            return x @ mat.t() + bias
        return ((x.to(torch.bfloat16) @ mat.t()) + bias.to(torch.bfloat16)
                ).to(torch.float32)

    b = enc.shape[0]
    n = b * k
    cat_vec = None
    if cfg.with_category and cat_tiled is not None:
        cat_vec = emb.category_embeddings.weight[
            cat_tiled.reshape(n, -1)[:, 0].long()]

    # cross K/V: position-invariant and shared by an instance's k beams, so
    # projected once per decode over b rows
    ke = dense(enc, w.wk_c, w.bk_c)
    ve = dense(enc, w.wv_c, w.bv_c)
    if routes.cross:
        ke_c, ve_c = ke.to(dt).contiguous(), ve.to(dt).contiguous()

    def softmax(x):
        e = torch.exp(x - x.amax(-1, keepdim=True))
        return e / e.sum(-1, keepdim=True)

    def attend(q, kc, vc, mask):
        """navc_tpu's XLA ``attend``: ``dt`` operands, float32 sums."""
        l = mask.shape[1]
        scores = torch.einsum(
            "nhd,nlhd->nhl", q.to(dt).float().view(n, nh, dh),
            kc.view(n, l, nh, dh).to(dt).float()) / math.sqrt(dh)
        scores = torch.where(mask[:, None, :], MASK_FILL, scores)
        out = torch.einsum("nhl,nlhd->nhd", softmax(scores).to(dt).float(),
                           vc.view(n, l, nh, dh).to(dt).float())
        return out.reshape(n, h)

    def attend_cross(q):
        """navc_tpu's XLA ``attend_cross``: the beam axis as a batch axis."""
        qb = q.to(dt).float().view(b, k, nh, dh)
        kb = ke.to(dt).float().view(b, -1, nh, dh)
        vb = ve.to(dt).float().view(b, -1, nh, dh)
        scores = torch.einsum("bkhd,blhd->bkhl", qb, kb) / math.sqrt(dh)
        out = torch.einsum("bkhl,blhd->bkhd", softmax(scores).to(dt).float(), vb)
        return out.reshape(n, h)

    def finish_layer(self_att, x, npm):
        att = (dense(self_att, w.wo_s, w.bo_s) + x) * npm
        qc = dense(att, w.wq_c, w.bq_c)
        crossed = (cross_attend(qc.contiguous(), ke_c, ve_c, nh) if routes.cross
                   else attend_cross(qc))
        att = (dense(crossed, w.wo_c, w.bo_c) + att) * npm
        inter = act(dense(att, w.wi, w.bi))
        h_t = (dense(inter, w.wo2, w.bo2) + att) * npm
        return h_t if routes.topk else model.project(h_t)

    def step(seqs_flat, tok, kc, vc, pk, t):
        e = word[tok.long()] + pos_table[t - 1][None, :]
        if cat_vec is not None:
            e = e + cat_vec
        x = emb.LayerNorm(e)
        npm = (tok != C.PAD).to(torch.float32)[:, None]
        qkv_t = dense(x, *qkv)
        q, kt, vt = (qkv_t[:, i * h:(i + 1) * h].contiguous() for i in range(3))
        l = seqs_flat.shape[1]
        # key mask: not yet written (j > t-1) or PAD
        mask = ((torch.arange(l, device=tok.device)[None, :] > t - 1)
                | (seqs_flat == C.PAD))
        if routes.attend:
            amask = torch.where(mask, MASK_FILL, 0.0).to(torch.float32)
            kc, vc, self_att = beam_attend_step(kc, vc, q, kt, vt, pk, amask,
                                                t - 1, nh)
        else:
            kc.view(n, l, h)[:, t - 1] = kt.to(kc.dtype)
            vc.view(n, l, h)[:, t - 1] = vt.to(vc.dtype)
            self_att = attend(q, kc, vc, mask)
        return finish_layer(self_att, x, npm), kc, vc

    return step


class _DoneWatch:
    """Reads the all-done flag ``lag`` steps late, so the host never drains
    the card's queue to decide whether to go on (CUDA), or at once (CPU)."""

    def __init__(self, device: torch.device, steps: int):
        self.cuda = device.type == "cuda"
        self.lag = DONE_LAG if self.cuda else 0
        self.flags = (torch.zeros(steps + 1, dtype=torch.bool, pin_memory=True)
                      if self.cuda else None)
        self.pending = collections.deque()

    def push(self, t: int, done: torch.Tensor) -> None:
        if not self.cuda:
            self.pending.append(bool(done.all()))
            return
        self.flags[t:t + 1].copy_(done.all().reshape(1), non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        self.pending.append((t, event))

    def finished(self) -> bool:
        """Whether every instance was done after the step ``lag`` steps
        back (False while fewer steps ran)."""
        if len(self.pending) <= self.lag:
            return False
        item = self.pending.popleft()
        if not self.cuda:
            return item
        t, event = item
        event.synchronize()
        return bool(self.flags[t])


def block_spans(max_len: int, block: int) -> List[Tuple[int, int]]:
    """Steps 1 .. max_len - 1 cut into blocks of ``block`` steps: [(first,
    end)]."""
    return [(t0, min(t0 + block, max_len)) for t0 in range(1, max_len, block)]


def prefix_static(ops: KernelOperands, n: int, l: int,
                  category: Optional[torch.Tensor]) -> torch.Tensor:
    """K1's ``static`` on a full-prefix beam step, bf16 (N, L, H): the
    position rows, plus the category's row when a category is given
    (navc_tpu beam.py:323-331)."""
    if category is None:
        ops = dataclasses.replace(ops, cat_table=None)
    return ops.static(n, l, category)


def prefix_hidden(ops: KernelOperands, seqs_flat: torch.Tensor, static: torch.Tensor,
                  ke: torch.Tensor, ve: torch.Tensor) -> torch.Tensor:
    """The full-prefix step's decoder layer through K1, causal, over the
    whole (N, L) prefix: the raw bf16 word rows, ``static`` (``prefix_static``),
    PAD keys masked and the hoisted cross K/V (N, Le, H); float32 (N, L, H)
    hidden states, as navc_tpu's ``fused_nar_decoder_layer(..., causal=True,
    static=...)`` returns them (beam.py:332-337). On CPU tensors, K1's
    plain version."""
    return fused_layer(ops.word16[seqs_flat.long()], static, seqs_flat == C.PAD, ke, ve,
                       ops.layer, ops.ln_scale, ops.ln_bias, n_head=ops.n_head,
                       causal=True, ln_eps=ops.ln_eps, out_dtype=torch.float32)


class _BeamLoop(graphs.Loop):
    """One request's blocked beam search as a ``graphs.Loop``: ``head()``
    makes the step and its carry (the cross K/V, the start state);
    ``block(j)`` runs the steps of ``spans[j]``, writes the beam state back
    in place (the tail reads it whichever block ran last) and returns the
    all-done flag; ``tail()`` ranks the finished hypotheses. The caches
    pass from block to block as the previous block's outputs."""

    def __init__(self, start, finish, spans, enc_output, category):
        self.start, self.finish, self.spans = start, finish, spans
        self.enc_output, self.category = enc_output, category
        self.n_blocks = len(spans)

    def head(self):
        self.step, self.carry = self.start(self.enc_output, self.category)
        self.state = self.carry[0]

    def block(self, j: int) -> torch.Tensor:
        carry = self.carry
        for t in range(*self.spans[j]):
            carry = self.step(carry, t)
        for old, new in zip(self.state, carry[0]):
            old.copy_(new)
        self.carry = (self.state,) + carry[1:]
        return self.state.done.all()

    def tail(self):
        return self.finish(self.state)


def make_ar_generator(cfg: Config, model, jit: bool = True, *,
                      block: int = DONE_LAG):
    """Build the batched beam-search decode (Translator.translate_batch).

    Returns ``generate(enc_results, category=None) -> (hypotheses, scores)``:
    (B, max_len - 1) int32 and (B,) float32 for topk <= 1, else the n-best
    (B, topk, max_len - 1) and (B, topk). ``enc_results`` carries
    'enc_output' (``Seq2Seq.encode``). Kernel operands are made here from
    the model's current weights, once.

    ``jit`` (navc_tpu's ``jax.jit`` around its ``while_loop``): the steps
    run in blocks of ``block`` under ``graphs.lagged_blocks``'s stop rule
    (``_BeamLoop``). On the card the set-up, each block and the ranking of
    the finished hypotheses are CUDA graphs (``graphs.JittedLoop``, one set
    per request signature, the K6 and K8 routes apart by width); on the
    CPU the phases run eagerly. ``jit=False`` issues every step from the
    host, reading the all-done flag ``DONE_LAG`` steps late.
    ``generate.graphed`` says whether calls on the card replay graphs,
    ``generate.steps_run`` counts the steps run, ``generate.graphs``
    holds the captured sets and ``generate.routes`` is the ``Routes`` of
    the last request set up (None on the full-prefix route).

    navc_tpu's switches (``NAVC_NO_KVCACHE``, ``Switches``) are read here,
    once; flipping one later changes neither this generator's eager calls
    nor its graphs' replays.

    The full-prefix route runs its layer through K1 on the card where
    ``fused_layer_eligible(cfg, causal=True)``, and the model's own forward
    on the CPU, as navc_tpu does.
    """
    k = cfg.beam_size
    max_len = cfg.max_len
    specific = max(k, cfg.topk)
    alpha = cfg.beam_alpha
    h = cfg.dim_hidden
    use_cache = kv_cached_beam_eligible(cfg)
    switches = Switches.read()
    cdt = torch.float32 if cfg.compute_dtype == "float32" else torch.bfloat16
    weights = qkv = None
    if use_cache:
        weights = layer_weights(model.decoder.layers[0], cdt)
        qkv = (torch.cat([weights.wq_s, weights.wk_s, weights.wv_s]),
               torch.cat([weights.bq_s, weights.bk_s, weights.bv_s]))
    proj = (projection_weights(model) if use_cache and topk_route(cfg, switches)
            else None)
    prefix_ops = (KernelOperands.of(model) if not use_cache
                  and fused_layer_eligible(cfg, causal=True) else None)
    spans = block_spans(max_len, block)

    def decode_step(seqs_flat, enc_tiled, cat_tiled, t, prefix):
        """Full-prefix route: the layer over the whole prefix (K1 with
        ``prefix`` = (static, ke, ve), else the ARFormer forward),
        projected at position t-1 only; log_softmax as
        jax.nn.log_softmax."""
        if prefix is not None:
            hidden = prefix_hidden(prefix_ops, seqs_flat, *prefix)
        else:
            hidden, _ = model.decode(seqs_flat, enc_tiled, cat_tiled, "ARFormer")
        logits = model.project(hidden[:, t - 1])
        shifted = logits - logits.amax(-1, keepdim=True)
        return shifted - torch.log(torch.exp(shifted).sum(-1, keepdim=True))

    def start(enc_output: torch.Tensor, category: Optional[torch.Tensor]):
        """A request's beam step and its carry before step 1: ``step(carry,
        t) -> carry``, carry = (BeamState, last tokens, K cache, V cache,
        pending ancestry)."""
        dev = enc_output.device
        b = enc_output.shape[0]
        n = b * k
        cat_tiled = None if category is None else enlarge(category, k)
        routes = generate.routes = None
        if use_cache:
            routes = generate.routes = plan_routes(cfg, b, switches)
            cached_step = _make_cached_step(cfg, model, weights, qkv,
                                            enc_output, cat_tiled, k, routes)
        else:
            enc_tiled = enlarge(enc_output, k)
            prefix = None
            if prefix_ops is not None and dev.type == "cuda":
                # navc_tpu runs the fused layer only on the device
                # (beam.py:315-318); the cross K/V are step-invariant
                cat = cat_tiled if cfg.with_category else None
                prefix = ((prefix_static(prefix_ops, n, max_len, cat),)
                          + prefix_ops.cross_kv(enc_output, k))

        i32 = dict(dtype=torch.int32, device=dev)
        seqs = torch.zeros((b, k, max_len), **i32)
        seqs[:, :, 0] = C.BOS
        scores = torch.full((b, k), NEG_BIG, dtype=torch.float32, device=dev)
        scores[:, 0] = 0.0
        state = BeamState(
            seqs=seqs, scores=scores,
            fin_seqs=torch.zeros((b, specific, max_len), **i32),
            fin_scores=torch.zeros((b, specific), dtype=torch.float32, device=dev),
            fin_lens=torch.zeros((b, specific), **i32),
            fin_count=torch.zeros((b,), **i32),
            done=torch.zeros((b,), dtype=torch.bool, device=dev))
        # the caches start at zero; the pending ancestry is the identity
        kc = torch.zeros((n, max_len * h), dtype=cdt, device=dev) if use_cache else None
        vc = torch.zeros_like(kc) if use_cache else None
        pk = torch.zeros((b, k), **i32)
        last = torch.full((b, k), C.BOS, **i32)
        slot = torch.arange(k, **i32)[None, None, :]

        def step(carry, t):
            state, last, kc, vc, pk = carry
            if use_cache:
                out, kc, vc = cached_step(state.seqs.reshape(n, max_len),
                                          last.reshape(n), kc, vc, pk, t)
                if routes.topk:
                    wp_k, ids_k = project_topk(out.to(torch.bfloat16), proj[0],
                                               k, proj[1])
                else:
                    # top-k on raw logits; only the candidates get the
                    # log_softmax arithmetic (x - max) - lse
                    mrow = out.amax(-1, keepdim=True)
                    lse = torch.log(torch.exp(out - mrow).sum(-1, keepdim=True))
                    top_logit, top_idx = top_k_stable(out, k)
                    wp_k, ids_k = (top_logit - mrow) - lse, top_idx.to(torch.int32)
                wp_top, ids_top = wp_k.view(b, k, k), ids_k.view(b, k, k)
                killed = (last == C.EOS)[:, :, None]
                ids_top = torch.where(killed, slot, ids_top)
                cand = torch.where(killed, NEG_BIG,
                                   wp_top + state.scores[:, :, None])
                best_scores, best_flat = top_k_stable(cand.reshape(b, k * k), k)
                prev_k = (best_flat // k).to(torch.int32)
                next_word = torch.gather(ids_top.reshape(b, k * k), 1, best_flat)
            else:
                wp = decode_step(state.seqs.reshape(n, max_len), enc_tiled,
                                 cat_tiled, t, prefix).view(b, k, -1)
                v = wp.shape[-1]
                beam_lk = torch.where((last == C.EOS)[:, :, None], NEG_BIG,
                                      wp + state.scores[:, :, None])
                best_scores, best_ids = top_k_stable(beam_lk.reshape(b, k * v), k)
                prev_k = (best_ids // v).to(torch.int32)
                next_word = (best_ids - prev_k * v).to(torch.int32)

            if use_cache:
                if routes.attend:
                    pk = prev_k  # the next step's K6 applies it
                elif routes.permute:
                    kc, vc = permute_beam_caches(kc, vc, prev_k)
                else:
                    kc, vc = permute_beam_caches_plain(kc, vc, prev_k)

            reordered = torch.gather(
                state.seqs, 1, prev_k.long()[:, :, None].expand(b, k, max_len))
            at_t = torch.arange(max_len, device=dev)[None, None, :] == t
            new_seqs = torch.where(at_t, next_word[:, :, None], reordered)

            active = ~state.done
            st = state._replace(
                seqs=torch.where(active[:, None, None], new_seqs, state.seqs),
                scores=torch.where(active[:, None], best_scores, state.scores))
            eligible = (next_word == C.EOS) & active[:, None]
            st = _append_finished(st, eligible, best_scores, new_seqs, t, specific)
            newly_done = st.fin_count >= specific
            if t == max_len - 1:
                empty = (st.fin_count == 0) & active
                st = _append_finished(st, empty[:, None].expand(b, k),
                                      best_scores, new_seqs, t, specific)
            st = st._replace(done=st.done | newly_done)
            return st, next_word, kc, vc, pk

        return step, (state, last, kc, vc, pk)

    def finish(state: BeamState):
        """sort_finished (Beam.py:123-130)."""
        b = state.fin_count.shape[0]
        dev = state.fin_count.device
        valid = (torch.arange(specific, device=dev)[None, :]
                 < state.fin_count[:, None])
        norm = state.fin_scores / torch.pow(
            state.fin_lens.clamp(min=1).to(torch.float32), alpha)
        norm = torch.where(valid, norm, -math.inf)
        rows = torch.arange(b, device=dev)
        if cfg.topk <= 1:
            best = norm.argmax(1)  # the first maximum
            return state.fin_seqs[rows, best][:, 1:], norm[rows, best]
        top_scores, top_idx = top_k_stable(norm, cfg.topk)
        top_seqs = torch.gather(state.fin_seqs, 1,
                                top_idx[:, :, None].expand(-1, -1, max_len))
        return top_seqs[:, :, 1:], top_scores

    def eager(enc_output, category):
        step, carry = start(enc_output, category)
        watch = _DoneWatch(enc_output.device, max_len)
        for t in range(1, max_len):
            if watch.finished():
                break
            carry = step(carry, t)
            generate.steps_run += 1
            watch.push(t, carry[0].done)
        return carry[0]

    jitted = graphs.JittedLoop(
        lambda enc_output, category: _BeamLoop(start, finish, spans, enc_output, category))

    @torch.no_grad()
    def generate(enc_results: Dict[str, torch.Tensor],
                 category: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        if not jit:
            return finish(eager(enc_results["enc_output"], category))
        out, blocks, _ = jitted(enc_results["enc_output"], category)
        generate.steps_run += sum(t1 - t0 for t0, t1 in spans[:blocks])
        return out

    generate.steps_run = 0
    generate.routes = None
    generate.graphed = jit
    generate.graphs = jitted.graphs
    return generate
