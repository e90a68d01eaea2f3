"""The training step.

Port of navc_tpu/runtime/train_step.py: forward, losses, backward, value
clip, optimizer update and the BatchNorm running-statistic update, per
batch. ``make_train_step`` returns ``step(batch, generator) -> metrics``:

  * the batch (numpy arrays or tensors) goes to the model's device: numpy
    arrays through page-locked slots on the card, tensors by a copy from
    where they lie;
  * ``generator`` is a CPU ``torch.Generator``; each step draws from it
    ``n_pass + 1`` seeds: the first reseeds the step's one device generator
    (the encoder and embedding dropout), the others are the fused layer's
    hash-dropout seeds, one per decoder pass, which go to the device as a
    (n_pass + 1,) int32 tensor that the kernels read there. navc_tpu draws
    these from threefry, so dropout-on steps of the two packages agree in
    distribution only;
  * ``jit`` (default True, navc_tpu's ``jax.jit``): on the card the step's
    device part, a function of the batch's tensors and the seed tensor
    (forward, losses, backward, clip, optimizer update), is one CUDA graph
    per batch signature (``runtime/graphs.py``). The first call of a
    signature is a real step and then the capture; later calls stage the
    batch and the seeds straight into the graph's inputs, reseed the
    registered device generator and replay. The optimizer's lr is a tensor
    on the card that ``set_learning_rate`` fills (``runtime/optim.py``); an
    optimizer ``load_state_dict`` drops the graphs (the next call captures
    anew). On the CPU, and with ``jit=False``, the same function runs
    eagerly;
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

import weakref
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
from . import graphs, optim
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


def _fused_train_apply(cfg: Config, model: Seq2Seq, feats, token_sets, label_sets,
                       category, generator, seeds: List[torch.Tensor]) -> Dict:
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


def _batch_inputs(batch: Dict[str, Any]) -> Dict[str, Any]:
    """The batch's numpy arrays and tensors, other entries dropped."""
    return {k: v for k, v in batch.items() if isinstance(v, np.ndarray) or torch.is_tensor(v)}


def _torch_dtype(v) -> torch.dtype:
    return v.dtype if torch.is_tensor(v) else torch.from_numpy(np.empty(0, v.dtype)).dtype


class _Inputs:
    """The device part's tensor inputs. On the CPU the arrays themselves
    (tensors as they are). On the card numpy arrays go through page-locked
    slots and tensors are copied as they lie (one already on the card with
    a device copy), into one set of tensors per signature when a graph reads
    them there (``persistent``), else into new ones."""

    def __init__(self, dev: torch.device, persistent: bool):
        self.dev = dev
        self.persistent = persistent
        self.slots = graphs.PinnedSlots(2) if dev.type == "cuda" else None
        self.buffers: Dict[Any, Dict[str, torch.Tensor]] = {}

    def __call__(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        if self.slots is None:
            return {k: v.to(self.dev) if torch.is_tensor(v) else torch.from_numpy(v)
                    for k, v in batch.items()}
        out: Dict[str, torch.Tensor] = {}
        if self.persistent:
            key = tuple((k, tuple(v.shape), _torch_dtype(v)) for k, v in batch.items())
            out = self.buffers.get(key)
            if out is None:
                out = self.buffers[key] = {
                    k: torch.empty(tuple(v.shape), dtype=_torch_dtype(v), device=self.dev)
                    for k, v in batch.items()}
        arrays = [k for k, v in batch.items() if not torch.is_tensor(v)]
        staged = dict(zip(arrays, self.slots.to_device(
            [batch[k] for k in arrays], self.dev, [out[k] for k in arrays] if out else ())))
        for k, v in batch.items():
            if torch.is_tensor(v):
                staged[k] = (out[k].copy_(v, non_blocking=True) if out
                             else v.to(self.dev, non_blocking=True))
        return {k: staged[k] for k in batch}


def _drop_graphs_on_reload(opt: torch.optim.Optimizer, jitted: graphs.Jitted) -> None:
    """An optimizer reload replaces its state tensors, which ``jitted``'s
    graphs read by address: the reload clears them. The hook holds
    ``jitted`` weakly and is removed when ``jitted`` is freed."""
    ref = weakref.ref(jitted)

    def hook(_):
        live = ref()
        if live is not None:
            live.graphs.clear()

    weakref.finalize(jitted, opt.register_load_state_dict_post_hook(hook).remove)


def make_train_step(cfg: Config, model: Seq2Seq, opt: torch.optim.Optimizer, *,
                    jit: bool = True):
    """``step(batch, generator) -> metrics``: one optimizer step on
    ``model`` (see the module docstring). The step's ``jitted`` is its
    ``graphs.Jitted`` (None on the eager route)."""
    n_pass = 2 if cfg.visual_word_generation else 1
    dev = _device(model)
    dropout_gen = torch.Generator(device=dev)

    def device_step(batch: Dict[str, torch.Tensor], seeds: torch.Tensor
                    ) -> Dict[str, torch.Tensor]:
        opt.zero_grad(set_to_none=False)
        results = _forward_results(cfg, model, batch, True, dropout_gen,
                                   [seeds[i:i + 1] for i in range(1, n_pass + 1)])
        loss, metrics = compute_losses(cfg, results, batch.get("valid_mask"))
        loss.backward()
        optim.step(cfg, opt)
        return metrics

    jitted = None
    if jit and dev.type == "cuda":
        jitted = graphs.Jitted(device_step, generators=(dropout_gen,), static_inputs=True)
        _drop_graphs_on_reload(opt, jitted)
    inputs = _Inputs(dev, jitted is not None)

    def train_step(batch: Dict, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        draws = torch.randint(0, 2 ** 31 - 1, (n_pass + 1,), generator=generator)
        dropout_gen.manual_seed(int(draws[0]))
        arrays = _batch_inputs(batch)
        arrays["_seeds"] = draws.numpy().astype(np.int32)
        staged = inputs(arrays)
        seeds = staged.pop("_seeds")
        return (jitted or device_step)(staged, seeds)

    train_step.jitted = jitted
    return train_step


def make_eval_loss_step(cfg: Config, model: Seq2Seq, *, jit: bool = True):
    """``eval_step(batch) -> metrics``: the losses of a deterministic
    forward (running BatchNorm statistics, no dropout), for validation
    curves. ``jit``: one CUDA graph per batch signature on the card, as
    ``make_train_step``'s (``eval_step.jitted``)."""
    dev = _device(model)

    @torch.no_grad()
    def device_eval(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        results = _forward_results(cfg, model, batch, False)
        return compute_losses(cfg, results, batch.get("valid_mask"))[1]

    jitted = (graphs.Jitted(device_eval, static_inputs=True)
              if jit and dev.type == "cuda" else None)
    inputs = _Inputs(dev, jitted is not None)

    def eval_step(batch: Dict) -> Dict[str, torch.Tensor]:
        return (jitted or device_eval)(inputs(_batch_inputs(batch)))

    eval_step.jitted = jitted
    return eval_step
