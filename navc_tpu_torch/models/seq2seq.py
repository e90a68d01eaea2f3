"""Seq2Seq façade: encode -> fuse -> (length head) -> decode -> project.

Port of navc_tpu/models/seq2seq.py (reference models/seq2seq.py and the
factory in models/__init__.py:64-94):
  * ``encode``: per-modality encoder -> fusion -> auxiliary heads,
  * ``decode``: the BertDecoder forward for a decoding type,
  * ``project``: bias-free vocab projection unless weights are tied, which
    projects through the word-embedding table plus a zero-init bias,
  * ``decode_logprobs``: decode -> project -> log_softmax,
  * ``ar_embed`` / ``nar_embed``: the decoder's pre-layer stage, for the
    fused training layer,
  * ``forward``: the teacher-forcing training forward (ARFormer shifts its
    inputs ``[:, :-1]``; visual-word generation runs the shared decoder on
    each token set).

Train mode is explicit: ``encode(..., train=True)`` normalises with batch
statistics and updates the running ones; dropout runs where a forward is
given a ``torch.Generator``.

Weights are made from a ``torch.Generator`` by ``build_model`` (torch's own
init laws) or filled from a flax tree by ``navc_tpu_torch.convert``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from ..config import Config
from ..device import resolve_device
from .decoder import BertDecoder
from .encoder import MultiStreamEncoder
from .fusion import Fusion
from .layers import Dense, LayerNorm, init_linear_
from .predictor import AUXILIARY_PREDICTORS


def compute_dtype(cfg: Config) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


class Seq2Seq(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        dtype = compute_dtype(cfg)
        self.encoder = MultiStreamEncoder(cfg.modality, cfg.modality_dims,
                                          cfg.dim_hidden, cfg.encoder_dropout)
        self.fusion = Fusion(cfg.fusion, cfg.norm_type, cfg.no_encoder_bn,
                             len(cfg.modality), cfg.dim_hidden)
        self.predictors = nn.ModuleDict({
            "predictor_%s" % name: AUXILIARY_PREDICTORS[name](
                cfg.dim_hidden, cfg.max_len, cfg.hidden_dropout_prob)
            for name in cfg.crit if name in AUXILIARY_PREDICTORS})
        self.decoder = BertDecoder(
            vocab_size=cfg.vocab_size, dim_hidden=cfg.dim_hidden,
            max_len=cfg.max_len,
            num_hidden_layers=cfg.num_hidden_layers_decoder,
            num_attention_heads=cfg.num_attention_heads,
            intermediate_size=cfg.intermediate_size,
            hidden_act=cfg.hidden_act, layer_norm_eps=cfg.layer_norm_eps,
            with_layernorm=cfg.with_layernorm,
            with_category=cfg.with_category, num_category=cfg.num_category,
            pos_attention=cfg.pos_attention, enhance_input=cfg.enhance_input,
            watch=cfg.watch, decoding_type=cfg.decoding_type,
            use_sigmoid_to_get_attprob=cfg.use_sigmoid_to_get_attprob,
            parallel_mlm=cfg.parallel_mlm, dtype=dtype,
            hidden_dropout_prob=cfg.hidden_dropout_prob,
            attention_probs_dropout_prob=cfg.attention_probs_dropout_prob)
        if cfg.tie_weights:
            self.tgt_word_prj = None
            self.tgt_word_prj_bias = nn.Parameter(torch.zeros(cfg.vocab_size))
        else:
            self.tgt_word_prj = Dense(cfg.dim_hidden, cfg.vocab_size,
                                      bias=False, compute_dtype=dtype)

    # ------------------------------------------------------------------
    def encode(self, feats: Sequence[torch.Tensor], train: bool = False,
               generator: Optional[torch.Generator] = None
               ) -> Dict[str, torch.Tensor]:
        """``train``: BatchNorm with batch statistics (and the running
        update); dropout where ``generator`` is given."""
        enc_outputs, enc_hiddens = self.encoder(list(feats), generator)
        enc_output, enc_hidden = self.fusion(enc_outputs, enc_hiddens, train)
        results = {"enc_output": enc_output, "enc_hidden": enc_hidden}
        for head in self.predictors.values():
            results.update(head(enc_output, generator))
        return results

    def decode(self, tgt_seq, enc_output, category=None,
               decoding_type: Optional[str] = None, generator=None,
               output_attentions: bool = False):
        return self.decoder(tgt_seq, enc_output, category, decoding_type,
                            generator, output_attentions)

    def ar_embed(self, tgt_seq, category=None):
        """AR pre-layer stage: the embeddings only, deterministic."""
        return self.decoder.embedding(tgt_seq, category)

    def nar_embed(self, tgt_seq, enc_output, category=None):
        """NAR pre-layer stage: enhance-input features + the embeddings,
        deterministic (reference Decoder.py:130-148)."""
        from ..ops import masking as M

        enh, l = self.cfg.enhance_input, tgt_seq.shape[1]
        additional = None
        if enh == 1:
            additional = M.resample_enc_output(enc_output, tgt_seq)
        elif enh == 2:
            additional = M.meanpool_enc_output(enc_output, l)
        return self.decoder.embedding(tgt_seq, category, additional)

    def projection_weight(self) -> torch.Tensor:
        """The (V, D) projection matrix: ``tgt_word_prj.weight`` untied, the
        word-embedding table tied — the same layout either way."""
        if self.tgt_word_prj is not None:
            return self.tgt_word_prj.weight
        return self.decoder.embedding.word_embeddings.weight

    def project(self, hidden: torch.Tensor, raw: bool = False) -> torch.Tensor:
        """Vocab logits in float32 (reference seq2seq.py:27-33); ``raw``
        keeps the compute dtype (the training loss casts inside its
        reductions)."""
        if self.tgt_word_prj is not None:
            out = self.tgt_word_prj(hidden)
        else:
            dt = compute_dtype(self.cfg)
            table = self.decoder.embedding.word_embeddings.weight
            out = hidden.to(dt) @ table.to(dt).t() + self.tgt_word_prj_bias.to(dt)
        return out if raw else out.to(torch.float32)

    def decode_logprobs(self, tgt_seq, enc_output, category=None,
                        decoding_type: Optional[str] = None,
                        output_attentions: bool = False):
        """(logprobs, embs), and with ``output_attentions`` the per-layer
        attention probabilities third."""
        hidden, embs, *attns = self.decode(tgt_seq, enc_output, category,
                                           decoding_type,
                                           output_attentions=output_attentions)
        logprobs = torch.log_softmax(self.project(hidden), dim=-1)
        return (logprobs, embs, *attns)

    def forward(self, feats: Sequence[torch.Tensor], tgt_tokens,
                category=None, train: bool = False,
                generator: Optional[torch.Generator] = None,
                return_logits: bool = False) -> Dict:
        """Teacher-forcing forward (reference seq2seq.py:82-140). A list or
        tuple of token sets runs the shared decoder once per set.
        ``return_logits`` gives raw logits under ``tgt_word_logits``
        instead of ``tgt_word_logprobs``."""
        cfg = self.cfg
        results = self.encode(feats, train, generator)
        token_sets = (list(tgt_tokens) if isinstance(tgt_tokens, (list, tuple))
                      else [tgt_tokens])
        # SelfMask (the parallel-MLM AR variant) feeds tokens[1:], ARFormer
        # shifts off the last position (reference seq2seq.py:115-120)
        if cfg.decoding_type == "SelfMask":
            token_sets = [t[:, 1:] for t in token_sets]
        elif cfg.decoding_type == "ARFormer":
            token_sets = [t[:, :-1] for t in token_sets]
        outs = []
        for tokens in token_sets:
            hidden, _ = self.decode(tokens, results["enc_output"], category,
                                    cfg.decoding_type, generator)
            logits = self.project(hidden, raw=return_logits)
            outs.append(logits if return_logits
                        else torch.log_softmax(logits, dim=-1))
        results["tgt_word_logits" if return_logits else "tgt_word_logprobs"] = outs
        return results


# ---------------------------------------------------------------------------
# Factory
# ---------------------------------------------------------------------------


def init_weights_(model: Seq2Seq, generator: torch.Generator) -> None:
    """torch's default laws, drawn in module order from ``generator``:
    Linear U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and bias, Embedding
    N(0, 1) with the PAD row of the word table zeroed (reference bert.py:55
    ``padding_idx``), norms at identity, BN running stats at (0, 1), the tied
    projection bias at zero."""
    from .. import constants as C

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Linear):
                init_linear_(mod, generator)
            elif isinstance(mod, nn.Embedding):
                mod.weight.normal_(0.0, 1.0, generator=generator)
            elif isinstance(mod, (LayerNorm, nn.BatchNorm1d)):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                if isinstance(mod, nn.BatchNorm1d):
                    mod.running_mean.zero_()
                    mod.running_var.fill_(1.0)
        model.decoder.embedding.word_embeddings.weight[C.PAD].zero_()
        if model.tgt_word_prj is None:
            model.tgt_word_prj_bias.zero_()


def build_model(cfg: Config, device="cuda",
                generator: Optional[torch.Generator] = None,
                train: bool = False) -> Seq2Seq:
    """Reference models/__init__.py:64-94 ``get_model``: the model on
    ``device`` with weights drawn from ``generator`` (a CPU generator; one
    seeded with 0 when none is given). Raises when CUDA is asked for and
    absent. ``train=False`` gives an inference model (eval mode, no
    gradients); ``train=True`` one whose parameters take gradients."""
    dev = resolve_device(device)
    if cfg.vocab_size <= 0:
        raise ValueError("cfg.vocab_size must be set before building the model")
    for ch in cfg.modality.lower():
        if ch not in "imaot":
            raise ValueError("unknown modality char %r" % ch)
    model = Seq2Seq(cfg)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    init_weights_(model, generator)
    model = model.to(dev)
    if train:
        return model.train().requires_grad_(True)
    return model.eval().requires_grad_(False)
