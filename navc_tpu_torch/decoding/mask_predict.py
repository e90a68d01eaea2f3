"""Non-autoregressive refinement decoding.

Port of navc_tpu/decoding/mask_predict.py (reference decoding/algorithms.py
MaskPredict, Left2Right and EasyFirst, and decoding/na_generate.py).
Semantics kept exactly:
  * the CT first pass replaces <mask> with <vis>, predicts once, and zeroes
    the probs of slots still predicted <mask> (algorithms.py:136-141); the
    loop then runs one extra iteration whose first step re-masks exactly the
    still-<mask> set (algorithms.py:242, 250-254);
  * the mask count is floor(len * ratio) with a floor of 1, the ratio
    1 - t/T computed in float64 on the host and cast to float32
    (algorithms.py:255-257, 213);
  * teacher gates: ``masking_decision`` for intermediate steps, ``not
    no_candidate_decision`` for the final step (algorithms.py:175-204);
  * PAD slots keep prob 1.0 / token PAD (algorithms.py:154-155);
  * best length beam by sum(log p) / len**alpha (na_generate.py:66-77).

With ``cfg.use_pallas`` and the kernels' configuration (ops/eligibility.py)
every forward goes through the hand-written kernels: the fused layer (K1)
with the embedding prologue and hoisted cross K/V, the sparse-query layer
(K2) for refinement steps, the projection+argmax (K3) and the teacher's
causal K1 + gather-prob (K4); the whole decode then runs on an 8-aligned
canvas. Other configurations take the plain ``decode_logprobs`` route.

Refinement step t of the sparse path re-predicts only its re-masked slots:
an index tensor (N, K) names their canvas positions (−1 = unused) and the
results are scattered back — the JAX package's one-hot selection and
multiply-sum merge were a TPU workaround (mask_predict.py:397-402).

The l2r and ef paradigms (algorithms.py:275-417) reveal q masks per round
— the leftmost, or the most confident — then refine q_iterations times;
they call the same ``predict`` and teacher as mp (dense K1 + K3, the
teacher's causal K1 + K4), never the sparse step. Compiled (``jit``), as
navc_tpu compiles them, their rounds are decided on the device: l2r's
ceil(L / q) rounds each under an IF node on whether it reveals anything,
ef's rounds in blocks, each round under an IF node on the reference's
stop rule, the blocks ended by a lagged flag read (``make_nar_generator``).
Eagerly, l2r runs exactly the rounds that reveal something, from one host
read of the largest mask count, and ef reads the batch's remaining mask
count each round. The collect modes keep every iteration's tokens and
probs (all steps dense) and, with ``collect_attentions``, layer 0's maps
from the plain decoder on the unaligned canvas.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from .. import constants as C
from ..config import Config
from ..ops.eligibility import (fused_decode_eligible, fused_layer_eligible,
                               fused_sparse_eligible, fused_teacher_eligible,
                               fused_vocab_eligible)
from ..ops.fused_layer import fused_layer, fused_layer_qsub
from ..ops.select import rank_mask_largest, rank_mask_smallest
from ..ops.vocab_fused import (project_argmax, project_gather_prob,
                               projection_weights)
from ..runtime import graphs
from .length_beam import (build_canvas, enlarge, predict_length_beam,
                          select_best_length_beam)
from .operands import KernelOperands


class NARContext(NamedTuple):
    """Everything the refinement loop needs per call."""
    enc_output: torch.Tensor                   # (B*lbs, T, H)
    category: Optional[torch.Tensor]           # (B*lbs, 1) or None
    teacher_enc_output: Optional[torch.Tensor]
    teacher_category: Optional[torch.Tensor]
    dict_mapping: Optional[torch.Tensor]       # (vocab,) student->teacher ids


def _predict_fn(cfg: Config, model, ops: Optional[KernelOperands], proj,
                ctx: NARContext, canvas_len: int, enc_unique: torch.Tensor,
                want_attentions: bool = False, sparse: bool = False):
    """One NAR decoder forward: tokens (N, L) -> (argmax ids, max probs)
    (reference algorithms.py:7-15, 143-167), the pad overwrite left to the
    caller. ``predict.predict_sub`` is the sparse-query forward on the
    kernel route when ``sparse`` (``fused_sparse_eligible``, read when the
    generator is made). ``want_attentions`` (the plain route)
    returns layer 0's (self, cross) attention maps third, each
    (N, n_head, L, L_k)."""
    if want_attentions:
        def predict(tokens):
            logprobs, _, attns = model.decode_logprobs(
                tokens, ctx.enc_output, ctx.category, "NARFormer",
                output_attentions=True)
            probs = torch.exp(logprobs)
            return (probs.argmax(dim=-1).to(torch.int32), probs.amax(dim=-1),
                    (attns[0][0], attns[0][-1]))
        return predict

    if ops is not None:  # every stage in the kernels
        n_rows = ctx.enc_output.shape[0]
        static = ops.static(n_rows, canvas_len, ctx.category,
                            ctx.enc_output if cfg.enhance_input == 2 else None)
        ke, ve = ops.cross_kv(enc_unique, cfg.length_beam_size)
        mask_row = ops.word16[C.MASK].contiguous()

        def predict(tokens):
            hidden = fused_layer(
                ops.word16[tokens.long()], static, tokens == C.PAD, ke, ve,
                ops.layer, ops.ln_scale, ops.ln_bias, n_head=ops.n_head,
                ln_eps=ops.ln_eps, out_dtype=torch.bfloat16)
            n, l, h = hidden.shape
            ids, maxp = project_argmax(hidden.view(n * l, h), ops.proj_w,
                                       ops.proj_b)
            return ids.view(n, l), maxp.view(n, l)

        def predict_sub(masked, qidx):
            """Sparse-query forward: qidx (N, K) names the re-masked slots
            (mask-predict discards every other slot's output,
            algorithms.py:260-265)."""
            hidden = fused_layer_qsub(
                qidx, mask_row, ops.word16[masked.long()], static,
                masked == C.PAD, ke, ve, ops.layer, ops.ln_scale, ops.ln_bias,
                n_head=ops.n_head, ln_eps=ops.ln_eps, out_dtype=torch.bfloat16)
            n, k, h = hidden.shape
            ids, maxp = project_argmax(hidden.view(n * k, h), ops.proj_w,
                                       ops.proj_b)
            return ids.view(n, k), maxp.view(n, k)

        if sparse:
            predict.predict_sub = predict_sub
        return predict

    if proj is not None:  # plain decoder, fused projection
        w, b = proj

        def predict(tokens):
            hidden, _ = model.decode(tokens, ctx.enc_output, ctx.category,
                                     "NARFormer")
            n, l, h = hidden.shape
            ids, maxp = project_argmax(
                hidden.reshape(n * l, h).to(torch.bfloat16).contiguous(), w, b)
            return ids.view(n, l), maxp.view(n, l)
        return predict

    def predict(tokens):
        logprobs, _ = model.decode_logprobs(tokens, ctx.enc_output,
                                            ctx.category, "NARFormer")
        probs = torch.exp(logprobs)
        return probs.argmax(dim=-1).to(torch.int32), probs.amax(dim=-1)
    return predict


def _teacher_inputs(tokens, ctx: NARContext):
    t = tokens if ctx.dict_mapping is None else ctx.dict_mapping[tokens.long()]
    t = t.to(torch.int32)
    bos = torch.full((t.shape[0], 1), C.BOS, dtype=t.dtype, device=t.device)
    return t, torch.cat([bos, t], dim=1)[:, :-1]


def _teacher_score_fn(teacher_model, ops: Optional[KernelOperands],
                      ctx: NARContext, enc_unique: torch.Tensor, lbs: int):
    """AR teacher per-token probabilities (algorithms.py:175-204)."""
    if ops is not None:
        ke, ve = ops.cross_kv(enc_unique, lbs)

        def score(tokens, pad_mask):
            t, inp = _teacher_inputs(tokens, ctx)
            n, l = inp.shape
            static = ops.static(n, l, ctx.teacher_category)
            hidden = fused_layer(
                ops.word16[inp.long()], static, inp == C.PAD, ke, ve,
                ops.layer, ops.ln_scale, ops.ln_bias, n_head=ops.n_head,
                causal=True, ln_eps=ops.ln_eps, out_dtype=torch.bfloat16)
            probs = project_gather_prob(hidden.view(n * l, -1), ops.proj_w,
                                        t.reshape(n * l).contiguous(),
                                        ops.proj_b).view(n, l)
            return torch.where(pad_mask, 1.0, probs)
        return score

    def score(tokens, pad_mask):
        t, inp = _teacher_inputs(tokens, ctx)
        hidden, _ = teacher_model.decode(inp, ctx.teacher_enc_output,
                                         ctx.teacher_category, "ARFormer")
        logits = teacher_model.project(hidden)
        lse = torch.logsumexp(logits, dim=-1)
        gathered = logits.gather(-1, t.long()[..., None])[..., 0]
        return torch.where(pad_mask, 1.0, torch.exp(gathered - lse))
    return score


def _apply_pad(ids, probs, pad_mask):
    """tokens[pad]=PAD, probs[pad]=1.0 (algorithms.py:154-155)."""
    return (torch.where(pad_mask, C.PAD, ids).to(torch.int32),
            torch.where(pad_mask, 1.0, probs))


def query_index(mask_ind: torch.Tensor, k: int) -> torch.Tensor:
    """(N, L) re-mask set -> (N, k) int32 canvas positions of the re-masked
    slots in canvas order (slot q = the q-th re-masked position), −1 for
    unused slots. Built by one scatter with no host sync."""
    n, l = mask_ind.shape
    ranks = mask_ind.to(torch.int32).cumsum(1) - 1
    slot = torch.where(mask_ind & (ranks < k), ranks, k).long()
    pos = torch.arange(l, dtype=torch.int32, device=mask_ind.device)
    qidx = torch.full((n, k + 1), -1, dtype=torch.int32, device=mask_ind.device)
    qidx.scatter_(1, slot, pos[None].expand(n, l))
    return qidx[:, :k].contiguous()


def _scatter_rows(base: torch.Tensor, qidx: torch.Tensor, vals: torch.Tensor):
    """base with base[n, qidx[n, q]] = vals[n, q] for every used slot."""
    n, l = base.shape
    col = torch.where(qidx >= 0, qidx, l).long()
    ext = torch.cat([base, base.new_zeros(n, 1)], dim=1)
    return ext.scatter_(1, col, vals.to(base.dtype))[:, :l]


def _final_lprobs(teacher_score, tokens, token_probs, pad_mask, cfg: Config):
    """log p, times the teacher's p for the final candidate decision
    (algorithms.py:175-204)."""
    if teacher_score is not None and not cfg.no_candidate_decision:
        token_probs = token_probs * teacher_score(tokens, pad_mask)
    return torch.log(token_probs)


def _mask_predict(predict, teacher_score, tokens, pad_mask, lengths,
                  cfg: Config, collect: bool = False,
                  collect_attentions: bool = False):
    """Mask-predict refinement (algorithms.py:218-270) -> (tokens, lprobs).

    ``collect`` also returns the per-iteration (tokens, probs) stacks,
    iteration 0 first, (T, N, L) each — the reference's
    collect_best_candidate_iterative_results (algorithms.py:55-75); every
    step is then dense. ``collect_attentions`` appends the layer-0 (self,
    cross) attention maps of each iteration, from a ``predict`` that
    returns them third."""
    use_ct = cfg.use_ct
    T = cfg.iterations + 1 if use_ct else cfg.iterations
    seq_lens = lengths.to(torch.float32)

    def call(toks):
        out = predict(toks)
        return out if collect_attentions else (out[0], out[1], ())

    if use_ct:
        # coarse-grained templates (algorithms.py:136-141)
        ids, probs, attns = call(torch.where(tokens == C.MASK, C.VIS, tokens))
        ids, probs = _apply_pad(ids, probs, pad_mask)
        tokens, token_probs = ids, torch.where(ids == C.MASK, 0.0, probs)
    else:
        ids, probs, attns = call(tokens)
        tokens, token_probs = _apply_pad(ids, probs, pad_mask)
    stacks = [(tokens, token_probs) + tuple(attns)] if collect else None

    def select_worst_set(toks, probs, ratio):
        """Re-mask set of one step (algorithms.py:255-257, teacher gate
        algorithms.py:175-204); ``ratio`` is the f32 cast of the host's f64
        1 - t/T, and the count is an f32 product, as torch takes it."""
        if teacher_score is not None and cfg.masking_decision:
            probs = probs * teacher_score(toks, pad_mask)
        num_mask = (seq_lens * ratio).to(torch.int32)
        return rank_mask_smallest(probs, num_mask.clamp(min=1))

    def dense_substep(toks, probs, mask_ind):
        """Re-mask + full-width re-predict + merge (algorithms.py:258-265)."""
        masked = torch.where(mask_ind, C.MASK, toks).to(torch.int32)
        new_ids, new_probs, new_attns = call(masked)
        new_ids, new_probs = _apply_pad(new_ids, new_probs, pad_mask)
        return (torch.where(mask_ind, new_ids, masked),
                torch.where(mask_ind, new_probs, probs), new_attns)

    predict_sub = None if collect else getattr(predict, "predict_sub", None)
    L = tokens.shape[1]
    for c in range(1, T):
        ratio = float(np.float32(1.0 - c / T))
        if use_ct and c == 1:
            # the first loop step completes the CT canvas (algorithms.py:250-254)
            mask_ind = tokens == C.MASK
        else:
            mask_ind = select_worst_set(tokens, token_probs, ratio)
        if predict_sub is None or (use_ct and c == 1):
            tokens, token_probs, attns = dense_substep(tokens, token_probs,
                                                       mask_ind)
            if collect:
                stacks.append((tokens, token_probs) + tuple(attns))
            continue
        # sparse step: re-predict only the re-masked slots. The query bound
        # must use the same f32 arithmetic as num_mask above (f32 can round
        # one above the f64 floor at exact-integer boundaries); f32 multiply
        # is monotone in L, so the bound at canvas width covers every row.
        masked = torch.where(mask_ind, C.MASK, tokens).to(torch.int32)
        k_f32 = int(np.float32(L) * np.float32(1.0 - c / T))
        k_bound = min(L, -(-max(1, k_f32) // 8) * 8)
        qidx = query_index(mask_ind, k_bound)
        ids_q, probs_q = predict_sub(masked, qidx)
        tokens = _scatter_rows(masked, qidx, ids_q)
        token_probs = _scatter_rows(token_probs, qidx, probs_q)
        tokens, token_probs = _apply_pad(tokens, token_probs, pad_mask)

    lprobs = _final_lprobs(teacher_score, tokens, token_probs, pad_mask, cfg)
    if collect:
        return tokens, lprobs, tuple(torch.stack(s) for s in zip(*stacks))
    return tokens, lprobs


def _refinement_tail(predict, tokens, token_probs, pad_mask, seq_lens,
                     cfg: Config, visual_mask):
    """Shared L2R/EF refinement rounds (algorithms.py:326-339, 400-413); the
    ratio is the f32 cast of the host's f64 0.4 (1 - i/T), as in mp."""
    T = cfg.q_iterations
    for i in range(T):
        if i == 0 and cfg.use_ct:
            mask_ind = visual_mask
        else:
            ratio = float(np.float32(0.4 * (1.0 - i / T)))
            num_mask = (seq_lens * ratio).to(torch.int32)
            mask_ind = rank_mask_smallest(token_probs, num_mask.clamp(min=1))
        masked = torch.where(mask_ind, C.MASK, tokens).to(torch.int32)
        new_ids, new_probs = _apply_pad(*predict(masked), pad_mask)
        tokens = torch.where(mask_ind, new_ids, masked)
        token_probs = torch.where(mask_ind, new_probs, token_probs)
    return tokens, token_probs


def _ct_or_blank(predict, tokens, pad_mask, cfg: Config):
    """Shared L2R/EF initialization (algorithms.py:288-293, 360-365):
    (tokens, probs, the CT pass's visual-word mask or None)."""
    if cfg.use_ct:
        ids, probs = _apply_pad(*predict(torch.where(tokens == C.MASK, C.VIS,
                                                     tokens)), pad_mask)
        probs = torch.where(ids == C.MASK, 0.0, probs)
        return ids, probs, (ids != C.MASK) & (ids != C.PAD)
    return tokens, torch.where(pad_mask, 1.0, 0.0), None


def _left2right(predict, teacher_score, tokens, pad_mask, lengths,
                cfg: Config, jit: bool = False):
    """Reveal the q leftmost masks per round, then refine
    (algorithms.py:275-344).

    ``jit``: navc_tpu's compiled form, a scan of ceil(L / q) rounds, each
    under ``lax.cond(any(sel))`` (``graphs.when``: an IF node in a capture,
    a merge elsewhere), with no host read. Else exactly the rounds with
    work, from one host read of the largest mask count."""
    seq_lens = lengths.to(torch.float32)
    tokens, token_probs, visual_mask = _ct_or_blank(predict, tokens, pad_mask,
                                                    cfg)
    # the initial masked set in left-to-right order (algorithms.py:297-311);
    # round s reveals ordinals [s q, (s + 1) q), so it has work only while
    # some row has more than s q masks
    init_mask = tokens == C.MASK
    ordinal = init_mask.to(torch.int32).cumsum(1) - 1
    q = cfg.q
    if jit:
        n_rounds = -(-tokens.shape[1] // q)
        stage = torch.where(init_mask, ordinal // q, -1)  # the round revealing each mask
        # any(sel) of round s: the stages are 0 .. ceil(count / q) - 1 in every row
        live = torch.arange(n_rounds, device=tokens.device) <= stage.amax()
        for s in range(n_rounds):
            def reveal(toks, probs, s=s):
                sel = stage == s
                masked = torch.where(sel, C.MASK, toks).to(torch.int32)
                new_ids, new_probs = _apply_pad(*predict(masked), pad_mask)
                return torch.where(sel, new_ids, masked), torch.where(sel, new_probs, probs)
            tokens, token_probs = graphs.when(live[s], reveal, (tokens, token_probs))
    else:
        for s in range(-(-int(init_mask.sum(1).max()) // q)):
            sel = init_mask & (ordinal >= s * q) & (ordinal < (s + 1) * q)
            masked = torch.where(sel, C.MASK, tokens).to(torch.int32)
            new_ids, new_probs = _apply_pad(*predict(masked), pad_mask)
            tokens = torch.where(sel, new_ids, masked)
            token_probs = torch.where(sel, new_probs, token_probs)

    tokens, token_probs = _refinement_tail(
        predict, tokens, token_probs, pad_mask, seq_lens, cfg, visual_mask)
    return tokens, _final_lprobs(teacher_score, tokens, token_probs, pad_mask,
                                 cfg)


def _easy_first(predict, teacher_score, tokens, pad_mask, lengths,
                cfg: Config, stats: Optional[dict] = None):
    """Reveal the q most confident masks of each row per round
    (algorithms.py:347-417), reading the batch's remaining mask count on
    the host each round (``jit=False``; ``_EasyFirst`` is the compiled
    form). ``stats["rounds"]``: the reveal rounds run."""
    seq_lens = lengths.to(torch.float32)
    tokens, token_probs, visual_mask = _ct_or_blank(predict, tokens, pad_mask,
                                                    cfg)
    # the rounds run until no mask is left or the batch-global count stops
    # falling (the dead-loop guard, algorithms.py:382-389: a model that
    # predicts <mask> into a revealed slot keeps it masked)
    pre, rounds = 0, 0
    while True:
        mask_ind = tokens == C.MASK
        remain = mask_ind.sum(-1)
        total = int(remain.sum())
        if total == 0 or total == pre:
            break
        pre = total
        rounds += 1
        new_ids, new_probs = _apply_pad(*predict(tokens), pad_mask)
        confid = torch.where(mask_ind, new_probs, 0.0)
        best = rank_mask_largest(confid, remain.clamp(max=cfg.q))
        tokens = torch.where(best, new_ids, tokens)
        token_probs = torch.where(best, new_probs, token_probs)
    if stats is not None:
        stats["rounds"] = rounds

    tokens, token_probs = _refinement_tail(
        predict, tokens, token_probs, pad_mask, seq_lens, cfg, visual_mask)
    return tokens, _final_lprobs(teacher_score, tokens, token_probs, pad_mask,
                                 cfg)


def _ef_go(total: torch.Tensor, pre: torch.Tensor) -> torch.Tensor:
    """navc_tpu's while-loop condition (mask_predict.py:565-568) on the
    batch's mask count: some mask left and the count still falling since
    the last round that ran (0-d bool)."""
    return (total > 0) & (total != pre)


def _ef_round(predict, pad_mask, cfg: Config, carry):
    """One reveal round of the compiled ef under ``_ef_go``. Every round of
    a block is guarded, not only the empty ones: after a stall one more
    round would still reveal. carry = (tokens, probs, the count before the
    last round that ran, the rounds run)."""
    tokens = carry[0]
    mask_ind = tokens == C.MASK
    remain = mask_ind.sum(-1)
    total = remain.sum()

    def reveal(toks, probs, pre, rounds):
        new_ids, new_probs = _apply_pad(*predict(toks), pad_mask)
        confid = torch.where(mask_ind, new_probs, 0.0)
        best = rank_mask_largest(confid, remain.clamp(max=cfg.q))
        return (torch.where(best, new_ids, toks), torch.where(best, new_probs, probs),
                total, rounds + 1)
    return graphs.when(_ef_go(total, carry[2]), reveal, carry)


def _ef_done(carry) -> torch.Tensor:
    """Whether the loop condition fails on the carry (0-d bool)."""
    return ~_ef_go((carry[0] == C.MASK).sum(), carry[2])


def ef_block_cap(canvas_len: int, block: int) -> int:
    """The most blocks of ``block`` rounds the compiled ef can run. A row
    whose revealed slots all come back <mask> has unchanged tokens, so it
    stalls for good; a row progresses at most once per mask it holds, so
    the rounds that run are at most canvas_len + 1 (the last one finds
    every row stalled), and the stop rule reads the last of their blocks
    after one block more."""
    return -(-(canvas_len + 1) // block) + 1


class _EasyFirst(graphs.Loop):
    """One request's compiled ef as a ``graphs.Loop``: ``head()`` builds
    the canvas, the forwards' operands and the carry (the CT pass or the
    blank canvas); ``block(j)`` runs ``rounds`` guarded reveal rounds
    (``_ef_round``), writes the carry back in place and returns its done
    flag; ``tail()`` refines, rescores with the teacher and picks each
    video's best length beam: (hypotheses, the reveal rounds run).
    ``setup`` maps the request to (predict, teacher_score, tokens,
    pad_mask, lengths, bsz); ``finish`` maps (hyp, lprobs, lengths, bsz)
    to (hypotheses, best length beam)."""

    same_blocks = True
    open_ended = True  # the stall guard lets the rounds exceed ceil(L / q)

    def __init__(self, setup, finish, cfg: Config, rounds: int, args, kwargs):
        self.setup, self.finish, self.cfg, self.rounds = setup, finish, cfg, rounds
        self.args, self.kwargs = args, kwargs

    def head(self):
        (self.predict, self.teacher_score, tokens, self.pad_mask, self.lengths,
         self.bsz) = self.setup(*self.args, **self.kwargs)
        tokens, probs, self.visual_mask = _ct_or_blank(self.predict, tokens,
                                                       self.pad_mask, self.cfg)
        # the carry is written in place: it owns its tensors (without CT
        # the tokens are the canvas itself)
        self.carry = (tokens.clone(), probs,
                      torch.zeros((), dtype=torch.int64, device=tokens.device),
                      torch.zeros((), dtype=torch.int32, device=tokens.device))
        self.n_blocks = ef_block_cap(tokens.shape[1], self.rounds)

    def block(self, j: int) -> torch.Tensor:
        carry = self.carry
        for _ in range(self.rounds):
            carry = _ef_round(self.predict, self.pad_mask, self.cfg, carry)
        for c, new in zip(self.carry, carry):
            c.copy_(new)
        return _ef_done(self.carry)

    def tail(self):
        tokens, probs, _, rounds = self.carry
        tokens, probs = _refinement_tail(self.predict, tokens, probs, self.pad_mask,
                                         self.lengths.to(torch.float32), self.cfg,
                                         self.visual_mask)
        lprobs = _final_lprobs(self.teacher_score, tokens, probs, self.pad_mask, self.cfg)
        return self.finish(tokens, lprobs, self.lengths, self.bsz)[0], rounds.clone()


ALGORITHMS = {"mp": _mask_predict, "l2r": _left2right, "ef": _easy_first}


def _gather_best(arr: torch.Tensor, best_idx: torch.Tensor, bsz: int,
                 lbs: int) -> torch.Tensor:
    """(T, B*lbs, *rest) -> (B, T, *rest) at each video's best length beam."""
    a = arr.reshape((arr.shape[0], bsz, lbs) + tuple(arr.shape[2:]))
    return a[:, torch.arange(bsz, device=a.device), best_idx].transpose(0, 1)


EF_BLOCK = 4  # reveal rounds per captured ef block: one lagged flag read each


def make_nar_generator(cfg: Config, model, teacher_model=None,
                       jit: bool = True, collect: bool = False,
                       collect_attentions: bool = False):
    """Build the NAR decode (reference na_generate.py:14-113).

    Returns ``generate(enc_results, category=None, teacher_enc_results=None,
    dict_mapping=None) -> hypotheses (B, max_len) int32``. ``enc_results``
    carries 'enc_output' and 'pred_length' (``Seq2Seq.encode``). With
    ``collect`` (mask-predict only) it returns ``(hypotheses, (iter_tokens
    (B, T, max_len), iter_probs (B, T, max_len)))`` at the best length beam
    (na_generate.py:80-90); ``collect_attentions`` (implies collect) adds
    ``[self_attn, cross_attn]``, each (B, T, n_head, max_len, L_k), the
    layer-0 maps of each iteration from the plain decoder on the max_len
    canvas (na_generate.py:92-106). The kernel operands (bf16 weights) are
    made here from the models' current weights, once; build a new
    generator after loading other weights.

    ``jit`` (navc_tpu's ``jax.jit`` of the decode, which compiles all three
    paradigms): on the card every decode replays CUDA graphs, captured per
    signature (``runtime/graphs.py``: request width, dtypes, which
    optional inputs are None) at the first call. mp (collect modes
    included) and l2r are one graph each, l2r's ceil(L / q) reveal rounds
    each under an IF node (``graphs.when``), with no host read. ef's
    while-loop is a head graph, a block of ``EF_BLOCK`` rounds, each under
    an IF node on navc_tpu's loop condition, replayed in place until the
    lagged stop rule ends it (one flag read per block), and a tail graph
    (``graphs.JittedLoop``). On the CPU the same formulation runs eagerly,
    ``when`` merging. ``jit=False``: l2r reads its largest mask count once
    on the host, ef its remaining count every round. ``generate.graphed``
    says whether calls on the card replay graphs; for ef,
    ``generate.blocks_run`` and ``generate.flag_reads`` count blocks and
    flag reads, and ``generate.rounds`` is the last decode's reveal rounds
    (a 0-d tensor with ``jit``, on the decode's device).

    ``NAVC_DENSE_REFINE`` (ops/eligibility.py) is read here, once: mp's
    refinements then run every canvas row through K1 instead of the
    re-masked rows through K2. Flipping it later changes neither this
    generator's eager calls nor its graphs' replays.
    """
    if cfg.paradigm not in ALGORITHMS:
        raise ValueError("paradigm must be one of %s" % list(ALGORITHMS))
    collect = collect or collect_attentions
    if collect and cfg.paradigm != "mp":
        raise NotImplementedError("iterative collection is mask-predict only")
    algorithm = ALGORITHMS[cfg.paradigm]
    lbs = cfg.length_beam_size
    use_teacher = teacher_model is not None and (
        cfg.masking_decision or not cfg.no_candidate_decision)
    tcfg = teacher_model.cfg if use_teacher else None
    # the attention maps come from the plain decoder, on the unaligned
    # canvas (navc_tpu mask_predict.py:645)
    student_kernels = not collect_attentions
    aligned = student_kernels and fused_decode_eligible(cfg, tcfg)
    run_len = -(-cfg.max_len // 8) * 8 if aligned else cfg.max_len
    ops = (KernelOperands.of(model)
           if student_kernels and fused_layer_eligible(cfg, causal=False)
           and fused_vocab_eligible(cfg) else None)
    proj = (projection_weights(model)
            if student_kernels and ops is None and fused_vocab_eligible(cfg)
            else None)
    tops = (KernelOperands.of(teacher_model)
            if use_teacher and fused_teacher_eligible(cfg, tcfg) else None)
    sparse = ops is not None and fused_sparse_eligible(cfg)  # NAVC_DENSE_REFINE

    def setup(enc_results: Dict[str, torch.Tensor], category=None,
              teacher_enc_results: Optional[Dict[str, torch.Tensor]] = None,
              dict_mapping: Optional[torch.Tensor] = None):
        """A request's canvas and forwards: (predict, teacher_score, tokens,
        pad_mask, lengths, bsz)."""
        pred_length = enc_results["pred_length"]
        bsz = pred_length.shape[0]
        beam = predict_length_beam(pred_length, lbs, cfg.length_bias,
                                   cfg.max_len)
        tokens, pad_mask, lengths = build_canvas(beam, run_len)
        cat = None if category is None else enlarge(category, lbs)
        ctx = NARContext(
            enc_output=enlarge(enc_results["enc_output"], lbs),
            category=cat,
            teacher_enc_output=(
                enlarge(teacher_enc_results["enc_output"], lbs)
                if use_teacher and teacher_enc_results is not None else None),
            teacher_category=cat,
            dict_mapping=dict_mapping)
        predict = _predict_fn(cfg, model, ops, proj, ctx, run_len,
                              enc_results["enc_output"], collect_attentions, sparse)
        teacher_score = None
        if ctx.teacher_enc_output is not None:
            teacher_score = _teacher_score_fn(
                teacher_model, tops, ctx, teacher_enc_results["enc_output"], lbs)
        return predict, teacher_score, tokens, pad_mask, lengths, bsz

    def finish(hyp, lprobs, lengths, bsz):
        """(each video's best hypothesis, its length beam)."""
        best, best_idx = select_best_length_beam(hyp, lprobs, lengths, bsz, lbs,
                                                 cfg.beam_alpha)
        return best[:, :cfg.max_len], best_idx  # drop the aligned-canvas PAD tail

    @torch.no_grad()
    def generate(*args, **kwargs):
        predict, teacher_score, tokens, pad_mask, lengths, bsz = setup(*args, **kwargs)
        if collect:
            hyp, lprobs, collected = algorithm(
                predict, teacher_score, tokens, pad_mask, lengths, cfg,
                collect=True, collect_attentions=collect_attentions)
        elif cfg.paradigm == "l2r":
            hyp, lprobs = algorithm(predict, teacher_score, tokens, pad_mask,
                                    lengths, cfg, jit=jit)
        elif cfg.paradigm == "ef":
            stats = {}
            hyp, lprobs = algorithm(predict, teacher_score, tokens, pad_mask,
                                    lengths, cfg, stats=stats)
            generate.rounds = stats["rounds"]
        else:
            hyp, lprobs = algorithm(predict, teacher_score, tokens, pad_mask,
                                    lengths, cfg)
        best, best_idx = finish(hyp, lprobs, lengths, bsz)
        if not collect:
            return best
        toks, probs = (_gather_best(s, best_idx, bsz, lbs)[..., :cfg.max_len]
                       for s in collected[:2])
        if collect_attentions:
            return best, (toks, probs), [_gather_best(a, best_idx, bsz, lbs)
                                         for a in collected[2:]]
        return best, (toks, probs)

    if jit and cfg.paradigm == "ef":
        return _ef_generator(setup, finish, cfg)
    if jit:
        return graphs.Jitted(generate)
    generate.graphed = False
    return generate


def _ef_generator(setup, finish, cfg: Config):
    """The compiled ef decode: ``_EasyFirst``'s phases captured per
    signature on the card (``graphs.JittedLoop``), run eagerly on the CPU."""
    jitted = graphs.JittedLoop(
        lambda *args, **kwargs: _EasyFirst(setup, finish, cfg, EF_BLOCK, args, kwargs))

    @torch.no_grad()
    def generate(*args, **kwargs):
        (hyp, generate.rounds), blocks, reads = jitted(*args, **kwargs)
        generate.blocks_run += blocks
        generate.flag_reads += reads
        return hyp

    generate.graphed = True
    generate.graphs = jitted.graphs
    generate.blocks_run = generate.flag_reads = 0
    generate.rounds = None
    return generate
