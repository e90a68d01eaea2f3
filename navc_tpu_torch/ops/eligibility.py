"""Single source of truth for the kernel gates.

Port of navc_tpu/ops/eligibility.py with the same predicates, so the gates
of the two packages cannot drift apart. ``cfg.use_pallas`` keeps its name
and means "use the hand-written CUDA kernels".

navc_tpu's A/B switches are read here as there: a non-empty environment
variable turns a route off.

  * ``NAVC_NO_KVCACHE``: the beam search recomputes the whole prefix each
    step instead of decoding from its K/V cache;
  * ``NAVC_DENSE_REFINE``: mask-predict refines every canvas row through
    K1 instead of the re-masked rows through K2;
  * ``NAVC_NO_FUSED_TRAIN``: the training step runs the module decoder
    layer instead of K11 / K12a / K12b;
  * ``NAVC_NO_FUSED_CE``: the training step writes the logits for
    ``runtime.crit`` instead of running K9 / K10.

The beam step's kernel switches (``NAVC_NO_ATTEND_KERNEL``,
``NAVC_NO_PERMUTE_KERNEL``, ``NAVC_NO_TOPK_KERNEL``) are read in
``decoding/beam.py``. The generators and steps read a switch when they are
made (navc_tpu's when ``jit`` traces), so a switch flipped later does not
change what they run, nor what their captured graphs replay.
"""

from __future__ import annotations

import os

from ..config import Config


def fused_layer_eligible(cfg: Config, causal: bool) -> bool:
    """Can the fused decoder-layer kernel replace ``BertDecoder``?

    The kernel covers 1 decoder layer, no pos-attention, no attention
    LayerNorm, softmax attention and gelu_new; ``causal`` forwards need
    ``watch == 0`` (Decoder.py:23-39), NAR forwards enhance_input 0 or 2
    (the resampling gather, Decoder.py:41-54, is not in the kernel).
    """
    ok = (cfg.use_pallas
          and cfg.num_hidden_layers_decoder == 1
          and not cfg.pos_attention
          and not cfg.with_layernorm
          and not cfg.use_sigmoid_to_get_attprob
          and cfg.hidden_act == "gelu_new")
    if causal:
        return ok and cfg.watch == 0
    return ok and cfg.enhance_input in (0, 2)


def kv_cached_beam_eligible(cfg: Config) -> bool:
    """Can AR beam search use the incremental KV-cached decode step? The
    configuration the fused causal layer covers (1 decoder layer, no
    pos-attention, no attention LayerNorm, gelu_new, no sigmoid attention,
    watch == 0), with or without the kernels. A non-empty
    ``NAVC_NO_KVCACHE`` in the environment turns it off (navc_tpu's A/B
    switch): the beam then recomputes the whole prefix every step."""
    return (cfg.num_hidden_layers_decoder == 1
            and not cfg.pos_attention
            and not cfg.with_layernorm
            and not cfg.use_sigmoid_to_get_attprob
            and cfg.hidden_act == "gelu_new"
            and cfg.watch == 0
            and not os.environ.get("NAVC_NO_KVCACHE"))


def fused_vocab_eligible(cfg: Config) -> bool:
    """Can the fused projection (+argmax / gather) kernels be used? Both the
    untied and the tied (table + bias) projections are covered."""
    return cfg.use_pallas


def fused_teacher_eligible(cfg: Config, teacher_cfg: Config) -> bool:
    """Can the AR teacher rescoring use the causal layer kernel + the
    gather-prob kernel? (the student cfg carries the switch)"""
    t = teacher_cfg.replace(use_pallas=True)
    return (cfg.use_pallas
            and fused_layer_eligible(t, causal=True)
            and fused_vocab_eligible(t))


def fused_decode_eligible(cfg: Config, teacher_cfg: Config = None) -> bool:
    """Does the ENTIRE NAR decode run through the kernels (student forward,
    and teacher rescoring when a teacher takes part)? Only then does the
    generator run on an 8-aligned canvas — the plain paths index the position
    table at canvas width."""
    ok = fused_layer_eligible(cfg, causal=False) and fused_vocab_eligible(cfg)
    if teacher_cfg is not None:
        ok = ok and fused_teacher_eligible(cfg, teacher_cfg)
    return ok


def fused_sparse_eligible(cfg: Config) -> bool:
    """Can mask-predict use the sparse-query refinement steps? Needs the
    fused NAR layer + projection and the 'mp' paradigm, whose mask counts
    shrink per iteration (algorithms.py:255-257); ``NAVC_DENSE_REFINE``
    turns it off."""
    return (fused_layer_eligible(cfg, causal=False)
            and fused_vocab_eligible(cfg)
            and cfg.paradigm == "mp"
            and not os.environ.get("NAVC_DENSE_REFINE"))


def fused_train_eligible(cfg: Config) -> bool:
    """Can the training step run the fused training layer
    (ops/fused_layer_train: K11, K12a, K12b) instead of the module
    BertLayer? The structure the decode kernel covers, plus attention-probs
    dropout 0 (the kernels implement the four hidden-dropout sites and the
    input site only) and a NARFormer or ARFormer (watch == 0) decoder. The
    embedding stage stays in modules, so enhance_input is free. SelfMask
    takes the module route. ``NAVC_NO_FUSED_TRAIN`` turns it off."""
    ok = (cfg.use_pallas
          and cfg.num_hidden_layers_decoder == 1
          and not cfg.pos_attention
          and not cfg.with_layernorm
          and not cfg.use_sigmoid_to_get_attprob
          and cfg.hidden_act == "gelu_new"
          and cfg.attention_probs_dropout_prob == 0.0
          and not os.environ.get("NAVC_NO_FUSED_TRAIN"))
    if cfg.decoding_type == "ARFormer":
        return ok and cfg.watch == 0
    return ok and cfg.decoding_type == "NARFormer"


def fused_vocab_ce_eligible(cfg: Config) -> bool:
    """Can the train step fuse the vocab projection with the cross-entropy
    (ops/vocab_ce, K9/K10) instead of writing (B, L, V) logits for
    ``runtime.crit``? navc_tpu's rule without its VMEM residency gate (a TPU
    fact: the CUDA kernels stream W in tiles). ``NAVC_NO_FUSED_CE`` turns it
    off."""
    return cfg.use_pallas and not os.environ.get("NAVC_NO_FUSED_CE")
