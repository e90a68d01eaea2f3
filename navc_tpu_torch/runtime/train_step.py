"""The training step.

Port of navc_tpu/runtime/train_step.py: forward, losses, backward, value
clip, optimizer update and the BatchNorm running-statistic update, per
batch. ``make_train_step`` returns ``step(batch, generator) -> metrics``:

  * the batch (numpy arrays or tensors) goes to the model's device, through
    pinned memory on the card;
  * ``generator`` is a CPU ``torch.Generator``; each step draws from it a
    seed for the device generator of the dropout masks and one seed per
    decoder pass for the fused layer's hash dropout. navc_tpu draws these
    from threefry, so dropout-on steps of the two packages agree in
    distribution only;
  * with ``fused_train_eligible`` the decoder layer runs as the fused
    training layer (ops/fused_layer_train: K11 forward, K12a/K12b + the
    weight-gradient reduction backward) on the live parameters of
    ``decoder.layers[0]``; the embeddings run deterministic, their dropout
    being the kernel's input site (``p_input``); otherwise every module runs
    in train mode;
  * on that route, with ``fused_vocab_ce_eligible``, the vocab projection
    is fused with the cross-entropy (ops/vocab_ce: K9 forward, K10
    backward): the logits are never written, and the results carry each
    pass's per-row (label log-prob, argmax) as ``tgt_word_rowstats``;
    otherwise raw logits go to ``runtime.crit`` (``tgt_word_logits``);
  * metrics stay tensors on the device: the step never waits for the card.

``cfg.remat`` is not read: the backward recomputes what the fused layer
needs, and the module route keeps its activations.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List

import numpy as np
import torch

from .. import constants as C
from ..config import Config
from ..models.seq2seq import Seq2Seq, compute_dtype
from ..ops.eligibility import fused_train_eligible, fused_vocab_ce_eligible
from ..ops.fused_layer_train import fused_bert_layer_train, layer_train_weights
from ..ops.vocab_ce import vocab_ce_train
from . import optim
from .crit import compute_losses


@dataclass
class TrainState:
    model: Seq2Seq
    optimizer: torch.optim.Optimizer
    step: int = 0


def create_train_state(cfg: Config, model: Seq2Seq) -> TrainState:
    """Put ``model`` in train mode with gradients and make its optimizer."""
    model.train().requires_grad_(True)
    return TrainState(model, optim.make_optimizer(cfg, model.parameters()))


def _device(model: Seq2Seq) -> torch.device:
    return next(model.parameters()).device


def to_device(batch: Dict[str, Any], dev: torch.device) -> Dict[str, torch.Tensor]:
    """The batch's arrays as tensors on ``dev`` (pinned, non-blocking copies
    to the card)."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(v)
            if dev.type == "cuda":
                v = v.pin_memory()
        if torch.is_tensor(v):
            out[k] = v.to(dev, non_blocking=True)
    return out


def _fused_train_apply(cfg: Config, model: Seq2Seq, feats, token_sets, label_sets,
                       category, generator, seeds: List[int]) -> Dict:
    """The train forward with the decoder layer as the fused training layer
    and, where eligible, the projection fused with the loss (navc_tpu
    ``_fused_train_apply``)."""
    assert len(token_sets) == len(label_sets), (len(token_sets), len(label_sets))
    results = model.encode(feats, train=True, generator=generator)
    enc = results["enc_output"]
    causal = cfg.decoding_type == "ARFormer"
    weights = layer_train_weights(model.decoder.layers[0])
    cdt = compute_dtype(cfg)
    use_ce = fused_vocab_ce_eligible(cfg)
    if use_ce:  # the live (V, D) parameter (+ the tied bias)
        w_prj = model.projection_weight()
        b_prj = model.tgt_word_prj_bias if model.tgt_word_prj is None else None
    outs = []
    for tokens, labels, seed in zip(token_sets, label_sets, seeds):
        inp = tokens[:, :-1] if causal else tokens
        emb = (model.ar_embed(inp, category) if causal
               else model.nar_embed(inp, enc, category))
        hidden = fused_bert_layer_train(
            emb, enc, inp == C.PAD, weights, seed,
            n_head=cfg.num_attention_heads, causal=causal,
            p_hidden=cfg.hidden_dropout_prob, p_input=cfg.hidden_dropout_prob,
            compute_dtype=cdt, out_dtype=cdt)
        outs.append(vocab_ce_train(hidden, w_prj, b_prj, labels, cdt) if use_ce
                    else model.project(hidden, raw=True))
    results["tgt_word_rowstats" if use_ce else "tgt_word_logits"] = outs
    return results


def _forward_results(cfg: Config, model: Seq2Seq, batch: Dict, train: bool,
                     generator=None, seeds=None) -> Dict:
    """Model forward + target wiring (reference misc/run.py:40-86)."""
    feats = [batch["feats_%s" % ch] for ch in cfg.modality.lower()]
    vwg = cfg.visual_word_generation
    token_sets = [batch["tokens_1"], batch["tokens"]] if vwg else [batch["tokens"]]
    category = batch.get("category")
    # NAR targets align with the inputs, AR targets shift by one
    start = 0 if cfg.decoding_type == "NARFormer" else 1
    if vwg:
        label_sets = [batch["labels_1"][:, start:], batch["labels"][:, start:]]
    else:
        label_sets = [batch["labels"][:, start:]]

    if train and fused_train_eligible(cfg):
        results = _fused_train_apply(cfg, model, feats, token_sets, label_sets,
                                     category, generator, seeds)
    else:
        results = model(feats, token_sets if vwg else token_sets[0], category,
                        train=train, generator=generator if train else None,
                        return_logits=True)
    results["tgt_word_labels"] = label_sets if vwg else label_sets[0]
    if cfg.decoding_type == "NARFormer":
        results["tgt_length"] = batch["length_target"]
    return results


def make_train_step(cfg: Config, model: Seq2Seq, opt: torch.optim.Optimizer):
    """``step(batch, generator) -> metrics``: one optimizer step on
    ``model`` (see the module docstring)."""
    n_pass = 2 if cfg.visual_word_generation else 1

    def train_step(batch: Dict, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        dev = _device(model)
        batch = to_device(batch, dev)
        draws = torch.randint(0, 2 ** 31 - 1, (n_pass + 1,), generator=generator)
        dropout_gen = torch.Generator(device=dev)
        dropout_gen.manual_seed(int(draws[0]))
        opt.zero_grad(set_to_none=False)
        results = _forward_results(cfg, model, batch, True, dropout_gen,
                                   [int(s) for s in draws[1:]])
        loss, metrics = compute_losses(cfg, results, batch.get("valid_mask"))
        loss.backward()
        optim.step(cfg, opt)
        return metrics

    return train_step


def make_eval_loss_step(cfg: Config, model: Seq2Seq):
    """``eval_step(batch) -> metrics``: the losses of a deterministic
    forward (running BatchNorm statistics, no dropout), for validation
    curves."""

    def eval_step(batch: Dict) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            results = _forward_results(cfg, model, to_device(batch, _device(model)),
                                       False)
            return compute_losses(cfg, results, batch.get("valid_mask"))[1]

    return eval_step
