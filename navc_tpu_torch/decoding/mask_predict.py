"""Non-autoregressive mask-predict decoding.

Port of the 'mp' paradigm of navc_tpu/decoding/mask_predict.py (reference
decoding/algorithms.py MaskPredict and decoding/na_generate.py). Semantics
kept exactly:
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

The l2r and ef paradigms and the collect modes are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from .. import constants as C
from ..config import Config
from ..ops.eligibility import (fused_decode_eligible, fused_layer_eligible,
                               fused_sparse_eligible, fused_teacher_eligible,
                               fused_vocab_eligible)
from ..ops.fused_layer import (LayerWeights, fused_layer, fused_layer_qsub,
                               hoist_cross_kv, layer_weights)
from ..ops.select import rank_mask_smallest
from ..ops.vocab_fused import (project_argmax, project_gather_prob,
                               projection_weights)
from .length_beam import (build_canvas, enlarge, predict_length_beam,
                          select_best_length_beam)


class NARContext(NamedTuple):
    """Everything the refinement loop needs per call."""
    enc_output: torch.Tensor                   # (B*lbs, T, H)
    category: Optional[torch.Tensor]           # (B*lbs, 1) or None
    teacher_enc_output: Optional[torch.Tensor]
    teacher_category: Optional[torch.Tensor]
    dict_mapping: Optional[torch.Tensor]       # (vocab,) student->teacher ids


@dataclass
class KernelOperands:
    """A model's kernel operands, made once per generator: bf16 layer
    weights and word table, float32 embedding LN, position and category
    tables, and the (V, D) bf16 projection."""
    layer: LayerWeights
    word16: torch.Tensor
    ln_scale: torch.Tensor
    ln_bias: torch.Tensor
    pos_table: torch.Tensor
    cat_table: Optional[torch.Tensor]
    proj_w: torch.Tensor
    proj_b: Optional[torch.Tensor]
    n_head: int
    ln_eps: float

    @classmethod
    def of(cls, model) -> "KernelOperands":
        emb = model.decoder.embedding
        cat = getattr(emb, "category_embeddings", None)
        w, b = projection_weights(model)
        return cls(
            layer=layer_weights(model.decoder.layers[0]),
            word16=emb.word_embeddings.weight.detach().to(torch.bfloat16),
            ln_scale=emb.LayerNorm.weight.detach().float().contiguous(),
            ln_bias=emb.LayerNorm.bias.detach().float().contiguous(),
            pos_table=emb.position_embeddings.weight.detach().float(),
            cat_table=None if cat is None else cat.weight.detach().float(),
            proj_w=w, proj_b=b, n_head=model.cfg.num_attention_heads,
            ln_eps=model.cfg.layer_norm_eps)

    def static(self, n_rows: int, l: int, category=None, enc_output=None):
        """Iteration-invariant embedding parts as bf16 (N, l, H): position
        rows (zeros past the table end — the 8-aligned canvas tail, always
        PAD) + category + the mean-pooled enc_output (enhance_input 2)."""
        h = self.pos_table.shape[1]
        pos = self.pos_table[:l]
        if l > pos.shape[0]:
            pos = torch.cat([pos, pos.new_zeros(l - pos.shape[0], h)])
        static = pos[None].expand(n_rows, l, h)
        if self.cat_table is not None:
            if category is None:
                raise ValueError("with_category model requires category ids")
            cat = self.cat_table[category.reshape(n_rows, -1)[:, 0].long()]
            static = static + cat[:, None, :]
        if enc_output is not None:
            static = static + enc_output.mean(dim=1, keepdim=True)
        return static.to(torch.bfloat16).contiguous()

    def cross_kv(self, enc_unique: torch.Tensor, lbs: int):
        """Hoisted cross K/V, projected once per video and tiled over the
        length beams."""
        ke, ve = hoist_cross_kv(enc_unique, self.layer)
        return enlarge(ke, lbs).contiguous(), enlarge(ve, lbs).contiguous()


def _predict_fn(cfg: Config, model, ops: Optional[KernelOperands], proj,
                ctx: NARContext, canvas_len: int, enc_unique: torch.Tensor):
    """One NAR decoder forward: tokens (N, L) -> (argmax ids, max probs)
    (reference algorithms.py:7-15, 143-167), the pad overwrite left to the
    caller. ``predict.predict_sub`` is the sparse-query forward when the
    kernels cover the configuration."""
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

        if fused_sparse_eligible(cfg):
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


def _mask_predict(predict, teacher_score, tokens, pad_mask, lengths,
                  cfg: Config):
    """Mask-predict refinement (algorithms.py:218-270) -> (tokens, lprobs)."""
    use_ct = cfg.use_ct
    T = cfg.iterations + 1 if use_ct else cfg.iterations
    seq_lens = lengths.to(torch.float32)

    if use_ct:
        # coarse-grained templates (algorithms.py:136-141)
        ids, probs = _apply_pad(*predict(torch.where(tokens == C.MASK, C.VIS,
                                                     tokens)), pad_mask)
        tokens, token_probs = ids, torch.where(ids == C.MASK, 0.0, probs)
    else:
        tokens, token_probs = _apply_pad(*predict(tokens), pad_mask)

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
        new_ids, new_probs = _apply_pad(*predict(masked), pad_mask)
        return (torch.where(mask_ind, new_ids, masked),
                torch.where(mask_ind, new_probs, probs))

    predict_sub = getattr(predict, "predict_sub", None)
    L = tokens.shape[1]
    for c in range(1, T):
        ratio = float(np.float32(1.0 - c / T))
        if use_ct and c == 1:
            # the first loop step completes the CT canvas (algorithms.py:250-254)
            tokens, token_probs = dense_substep(tokens, token_probs,
                                                tokens == C.MASK)
            continue
        mask_ind = select_worst_set(tokens, token_probs, ratio)
        if predict_sub is None:
            tokens, token_probs = dense_substep(tokens, token_probs, mask_ind)
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

    if teacher_score is not None and not cfg.no_candidate_decision:
        token_probs = token_probs * teacher_score(tokens, pad_mask)
    return tokens, torch.log(token_probs)


def make_nar_generator(cfg: Config, model, teacher_model=None,
                       collect: bool = False, collect_attentions: bool = False):
    """Build the NAR decode (reference na_generate.py:14-113).

    Returns ``generate(enc_results, category=None, teacher_enc_results=None,
    dict_mapping=None) -> hypotheses (B, max_len) int32``. ``enc_results``
    carries 'enc_output' and 'pred_length' (``Seq2Seq.encode``). The kernel
    operands (bf16 weights) are made here from the models' current weights,
    once; build a new generator after loading other weights.
    """
    if cfg.paradigm != "mp":
        raise NotImplementedError(
            "paradigm %r is not ported yet (only 'mp')" % cfg.paradigm)
    if collect or collect_attentions:
        raise NotImplementedError("the collect modes are not ported yet")
    lbs = cfg.length_beam_size
    use_teacher = teacher_model is not None and (
        cfg.masking_decision or not cfg.no_candidate_decision)
    tcfg = teacher_model.cfg if use_teacher else None
    aligned = fused_decode_eligible(cfg, tcfg)
    run_len = -(-cfg.max_len // 8) * 8 if aligned else cfg.max_len
    ops = (KernelOperands.of(model)
           if fused_layer_eligible(cfg, causal=False) and fused_vocab_eligible(cfg)
           else None)
    proj = (projection_weights(model)
            if ops is None and fused_vocab_eligible(cfg) else None)
    tops = (KernelOperands.of(teacher_model)
            if use_teacher and fused_teacher_eligible(cfg, tcfg) else None)

    @torch.no_grad()
    def generate(enc_results: Dict[str, torch.Tensor], category=None,
                 teacher_enc_results: Optional[Dict[str, torch.Tensor]] = None,
                 dict_mapping: Optional[torch.Tensor] = None) -> torch.Tensor:
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
                              enc_results["enc_output"])
        teacher_score = None
        if ctx.teacher_enc_output is not None:
            teacher_score = _teacher_score_fn(
                teacher_model, tops, ctx, teacher_enc_results["enc_output"], lbs)
        hyp, lprobs = _mask_predict(predict, teacher_score, tokens, pad_mask,
                                    lengths, cfg)
        best, _ = select_best_length_beam(hyp, lprobs, lengths, bsz, lbs,
                                          cfg.beam_alpha)
        return best[:, :cfg.max_len]  # drop the aligned-canvas PAD tail

    return generate
