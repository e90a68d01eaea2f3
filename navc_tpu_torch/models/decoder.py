"""BERT-style caption decoder (AR and NAR modes).

Port of navc_tpu/models/decoder.py (reference models/Decoder.py):
  * mask by decoding type — NARFormer: key-pad only; ARFormer: key-pad +
    causal (+watch) (Decoder.py:105-124); the training-only SelfMask type is
    not ported,
  * NAR input enhancement 0/1/2 (none / resampled / mean-pooled enc_output)
    added to the token embeddings (Decoder.py:130-139),
  * N stacked BertLayers (Decoder.py:150-178).
NACF's disentangled two-pass decoder shares these weights across passes, so
one class serves every method. A forward given a ``torch.Generator`` runs
in train mode (dropout at navc_tpu's sites).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops import masking as M
from .layers import BertEmbeddings, BertLayer


class BertDecoder(nn.Module):
    def __init__(self, vocab_size: int, dim_hidden: int, max_len: int,
                 num_hidden_layers: int = 1, num_attention_heads: int = 8,
                 intermediate_size: int = 2048, hidden_act: str = "gelu_new",
                 layer_norm_eps: float = 1e-5, with_layernorm: bool = False,
                 with_category: bool = False, num_category: int = 20,
                 pos_attention: bool = False, enhance_input: int = 2,
                 watch: int = 0, decoding_type: str = "ARFormer",
                 use_sigmoid_to_get_attprob: bool = False,
                 parallel_mlm: bool = False, dtype=torch.float32,
                 hidden_dropout_prob: float = 0.5,
                 attention_probs_dropout_prob: float = 0.0):
        super().__init__()
        self.enhance_input = enhance_input
        self.watch = watch
        self.decoding_type = decoding_type
        self.pos_attention = pos_attention
        self.embedding = BertEmbeddings(
            vocab_size, dim_hidden, max_len, num_category, with_category,
            layer_norm_eps, return_pos=pos_attention,
            hidden_dropout_prob=hidden_dropout_prob)
        self.layers = nn.ModuleList([
            BertLayer(dim_hidden, num_attention_heads, intermediate_size,
                      hidden_act, with_layernorm, layer_norm_eps,
                      pos_attention, use_sigmoid_to_get_attprob, parallel_mlm,
                      dtype, hidden_dropout_prob, attention_probs_dropout_prob)
            for _ in range(num_hidden_layers)])

    def forward(self, tgt_seq, enc_output, category=None,
                decoding_type: Optional[str] = None, generator=None,
                output_attentions: bool = False):
        """Returns (last hidden states (B, L, H) f32, embs (B, H)); with
        ``output_attentions`` also each layer's attention probabilities, a
        tuple per layer as ``BertLayer`` gives them."""
        decoding_type = decoding_type or self.decoding_type
        b, l = tgt_seq.shape
        kp = M.key_pad_mask(tgt_seq, l)
        if decoding_type == "NARFormer":
            slf_attn_mask = kp
        elif decoding_type == "ARFormer":
            slf_attn_mask = kp | M.subsequent_mask(b, l, self.watch,
                                                   device=tgt_seq.device)
        else:
            raise ValueError("decoding_type %r is not ported" % decoding_type)
        npm = M.non_pad_mask(tgt_seq)

        additional_feats = None
        if decoding_type == "NARFormer":
            if self.enhance_input == 1:
                additional_feats = M.resample_enc_output(enc_output, tgt_seq)
            elif self.enhance_input == 2:
                additional_feats = M.meanpool_enc_output(enc_output, l)
            elif self.enhance_input != 0:
                raise ValueError("enhance_input should be 0, 1 or 2")

        position_embeddings = None
        if self.pos_attention:
            hidden, position_embeddings = self.embedding(
                tgt_seq, category, generator=generator)
        else:
            hidden = self.embedding(tgt_seq, category, additional_feats,
                                    generator)

        embs = None
        attentions = []
        for layer in self.layers:
            out = layer(hidden, npm, slf_attn_mask, enc_output,
                        position_embeddings, generator, output_attentions)
            hidden, embs = out[:2]
            attentions.extend(out[2:])
        if output_attentions:
            return hidden, embs, tuple(attentions)
        return hidden, embs
