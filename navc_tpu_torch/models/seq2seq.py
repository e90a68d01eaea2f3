"""Seq2Seq façade: encode -> fuse -> (length head) -> decode -> project.

Port of navc_tpu/models/seq2seq.py (reference models/seq2seq.py and the
factory in models/__init__.py:64-94), inference only:
  * ``encode``: per-modality encoder -> fusion -> auxiliary heads,
  * ``decode``: the BertDecoder forward for a decoding type,
  * ``project``: bias-free vocab projection unless weights are tied, which
    projects through the word-embedding table plus a zero-init bias,
  * ``decode_logprobs``: decode -> project -> log_softmax.

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
                                          cfg.dim_hidden)
        self.fusion = Fusion(cfg.fusion, cfg.norm_type, cfg.no_encoder_bn,
                             len(cfg.modality), cfg.dim_hidden)
        self.predictors = nn.ModuleDict({
            "predictor_%s" % name: AUXILIARY_PREDICTORS[name](
                cfg.dim_hidden, cfg.max_len)
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
            parallel_mlm=cfg.parallel_mlm, dtype=dtype)
        if cfg.tie_weights:
            self.tgt_word_prj = None
            self.tgt_word_prj_bias = nn.Parameter(torch.zeros(cfg.vocab_size))
        else:
            self.tgt_word_prj = Dense(cfg.dim_hidden, cfg.vocab_size,
                                      bias=False, compute_dtype=dtype)

    # ------------------------------------------------------------------
    def encode(self, feats: Sequence[torch.Tensor]) -> Dict[str, torch.Tensor]:
        enc_outputs, enc_hiddens = self.encoder(list(feats))
        enc_output, enc_hidden = self.fusion(enc_outputs, enc_hiddens)
        results = {"enc_output": enc_output, "enc_hidden": enc_hidden}
        for head in self.predictors.values():
            results.update(head(enc_output))
        return results

    def decode(self, tgt_seq, enc_output, category=None,
               decoding_type: Optional[str] = None):
        return self.decoder(tgt_seq, enc_output, category, decoding_type)

    def projection_weight(self) -> torch.Tensor:
        """The (V, D) projection matrix: ``tgt_word_prj.weight`` untied, the
        word-embedding table tied — the same layout either way."""
        if self.tgt_word_prj is not None:
            return self.tgt_word_prj.weight
        return self.decoder.embedding.word_embeddings.weight

    def project(self, hidden: torch.Tensor) -> torch.Tensor:
        """Vocab logits in float32 (reference seq2seq.py:27-33)."""
        if self.tgt_word_prj is not None:
            return self.tgt_word_prj(hidden).to(torch.float32)
        dt = compute_dtype(self.cfg)
        table = self.decoder.embedding.word_embeddings.weight
        out = hidden.to(dt) @ table.to(dt).t() + self.tgt_word_prj_bias.to(dt)
        return out.to(torch.float32)

    def decode_logprobs(self, tgt_seq, enc_output, category=None,
                        decoding_type: Optional[str] = None):
        hidden, embs = self.decode(tgt_seq, enc_output, category,
                                   decoding_type)
        return torch.log_softmax(self.project(hidden), dim=-1), embs


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
                generator: Optional[torch.Generator] = None) -> Seq2Seq:
    """Reference models/__init__.py:64-94 ``get_model``: the model in eval
    mode on ``device`` with weights drawn from ``generator`` (a CPU
    generator; one seeded with 0 when none is given). Raises when CUDA is
    asked for and absent."""
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
    return model.to(dev).eval().requires_grad_(False)
