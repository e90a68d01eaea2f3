"""Transformer primitives (BERT-style) for the caption decoder.

Port of navc_tpu/models/layers.py (reference models/bert.py). Dropout runs
only when a forward is given a ``torch.Generator`` (train mode), at
navc_tpu's sites: the embedding LayerNorm output (and the pos-attention
stream), attention probabilities, the self/cross output projections, and
twice in BertOutput (bert.py:240-247); without one it is the identity.
Semantics kept:
  * additive masking with the reference's fill value -10e6 (bert.py:161),
  * gelu_new (bert.py:12-13),
  * BertSelfOutput: dense -> +residual, LayerNorm only when
    ``with_layernorm`` (bert.py:182-200),
  * BertLayer multiplies by the non-pad mask after every stage and returns
    the non-pad-averaged sequence embedding (bert.py:262-303),
  * ``compute_dtype`` bf16 runs the decoder's matmuls on bf16 operands the
    way flax ``Dense(dtype=bf16)`` does (bf16 product, bf16 bias add);
    softmax and LayerNorm stay float32.

LayerNorm and the normalisation arithmetic follow flax's order of operations
(fast variance E[x^2] - E[x]^2, then ``(x - mean) * (rsqrt(var + eps) *
scale) + bias``) so the float32 forward agrees with the JAX package to a few
ulps.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

# Additive mask fill value (reference models/bert.py:161 uses -10e6 == -1e7).
MASK_FILL = -10e6


def gelu_new(x: torch.Tensor) -> torch.Tensor:
    """Smooth GELU approximation (reference models/bert.py:12-13)."""
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * torch.pow(x, 3.0))))


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    return x * 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


ACT2FN = {"gelu": gelu_exact, "relu": F.relu, "swish": swish,
          "gelu_new": gelu_new}


def dropout(x: torch.Tensor, p: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - p and scale by
    1 / (1 - p), the mask drawn from ``generator`` (on x's device); the
    identity when ``generator`` is None or p is 0."""
    if generator is None or p <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype,
                                                          device=x.device))


def normalize(x, mean, var, eps, scale=None, bias=None):
    """flax ``_normalize``: ``(x - mean) * (rsqrt(var + eps) * scale) + bias``."""
    mul = torch.rsqrt(var + eps)
    if scale is not None:
        mul = mul * scale
    y = (x - mean) * mul
    if bias is not None:
        y = y + bias
    return y


class LayerNorm(nn.Module):
    """LayerNorm over the last axis with flax's statistics (fast variance,
    clipped at 0). ``weight``/``bias`` are flax's ``scale``/``bias``."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float32)
        mean = x.mean(-1, keepdim=True)
        var = ((x * x).mean(-1, keepdim=True) - mean * mean).clamp(min=0.0)
        return normalize(x, mean, var, self.eps, self.weight, self.bias)


class Dense(nn.Linear):
    """``nn.Linear`` whose product runs in ``compute_dtype``.

    float32: ``x @ W^T + b``. bfloat16 mirrors flax ``Dense(dtype=bf16)``:
    operands and bias cast to bf16, bf16 product, bf16 bias add.
    """

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        y = x.to(dt) @ self.weight.to(dt).t()
        if self.bias is not None:
            y = y + self.bias.to(dt)
        return y


class BertEmbeddings(nn.Module):
    """Word + learned position (+ category) embeddings with LayerNorm
    (reference models/bert.py:46-108)."""

    def __init__(self, vocab_size: int, dim_hidden: int, max_len: int,
                 num_category: int = 20, with_category: bool = False,
                 layer_norm_eps: float = 1e-5, return_pos: bool = False,
                 hidden_dropout_prob: float = 0.5):
        super().__init__()
        self.p = hidden_dropout_prob
        self.with_category = with_category
        self.return_pos = return_pos
        self.word_embeddings = nn.Embedding(vocab_size, dim_hidden)
        self.position_embeddings = nn.Embedding(max_len, dim_hidden)
        if with_category:
            self.category_embeddings = nn.Embedding(num_category, dim_hidden)
        self.LayerNorm = LayerNorm(dim_hidden, layer_norm_eps)
        if return_pos:
            self.pos_LN = LayerNorm(dim_hidden, layer_norm_eps)

    def forward(self, input_ids, category=None, additional_feats=None,
                generator=None):
        b, seq_len = input_ids.shape
        words = self.word_embeddings(input_ids)
        pos = self.position_embeddings.weight[:seq_len][None].expand(
            b, seq_len, words.shape[-1])
        emb = words + pos
        if self.with_category:
            if category is None:
                raise ValueError("with_category model requires category ids")
            cat = self.category_embeddings(category.reshape(b, -1)[:, :1])
            emb = emb + cat
        if additional_feats is not None:
            emb = emb + additional_feats
        emb = dropout(self.LayerNorm(emb), self.p, generator)
        if self.return_pos:
            return emb, dropout(self.pos_LN(pos), self.p, generator)
        return emb


def attention_core(q, k, v, mask, dtype=torch.float32, use_sigmoid=False,
                   dropout_fn=None):
    """Scaled-dot attention with the reference's additive -10e6 masking.

    q, k, v: (B, L, n_head, d); mask: (B, Lq, Lk) bool, True = masked out.
    Products take ``dtype`` operands with float32 accumulation; the softmax
    is float32. Returns (out (B, Lq, n_head, d) f32, probs (B, nh, Lq, Lk)).
    """
    d_k = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(dtype).float(),
                          k.to(dtype).float())
    scores = scores / math.sqrt(d_k)
    if mask is not None:
        scores = scores.masked_fill(mask[:, None], MASK_FILL)
    if use_sigmoid:
        probs = torch.sigmoid(scores)
        probs = probs / (probs.sum(-1, keepdim=True) + 1e-12)
    else:
        probs = torch.softmax(scores, dim=-1)
    if dropout_fn is not None:
        probs = dropout_fn(probs)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(dtype).float(),
                       v.to(dtype).float())
    return out, probs


class BertSelfAttention(nn.Module):
    """Multi-head attention (reference models/bert.py:115-179)."""

    def __init__(self, dim_hidden, num_attention_heads, use_sigmoid=False,
                 dtype=torch.float32, attention_probs_dropout_prob=0.0):
        super().__init__()
        self.p = attention_probs_dropout_prob
        if dim_hidden % num_attention_heads != 0:
            raise ValueError("dim_hidden %d not divisible by heads %d"
                             % (dim_hidden, num_attention_heads))
        self.n_head = num_attention_heads
        self.use_sigmoid = use_sigmoid
        self.dtype = dtype
        self.query = Dense(dim_hidden, dim_hidden, compute_dtype=dtype)
        self.key = Dense(dim_hidden, dim_hidden, compute_dtype=dtype)
        self.value = Dense(dim_hidden, dim_hidden, compute_dtype=dtype)

    def forward(self, q_in, k_in, v_in, attention_mask=None, generator=None):
        def heads(x):
            b, l, h = x.shape
            return x.reshape(b, l, self.n_head, h // self.n_head)

        out, probs = attention_core(
            heads(self.query(q_in)), heads(self.key(k_in)),
            heads(self.value(v_in)), attention_mask, dtype=self.dtype,
            use_sigmoid=self.use_sigmoid,
            dropout_fn=(lambda t: dropout(t, self.p, generator))
            if self.p > 0.0 and generator is not None else None)
        return out.reshape(out.shape[0], out.shape[1], -1), probs


class BertSelfOutput(nn.Module):
    """Post-attention projection (reference models/bert.py:182-200)."""

    def __init__(self, dim_hidden, with_layernorm=False, layer_norm_eps=1e-5,
                 dtype=torch.float32, hidden_dropout_prob=0.5):
        super().__init__()
        self.p = hidden_dropout_prob
        self.dense = Dense(dim_hidden, dim_hidden, compute_dtype=dtype)
        self.LayerNorm = (LayerNorm(dim_hidden, layer_norm_eps)
                          if with_layernorm else None)

    def forward(self, hidden_states, input_tensor=None, generator=None):
        hidden_states = dropout(self.dense(hidden_states).to(torch.float32),
                                self.p, generator)
        if input_tensor is not None:
            hidden_states = hidden_states + input_tensor
        if self.LayerNorm is not None:
            hidden_states = self.LayerNorm(hidden_states)
        return hidden_states


class BertAttention(nn.Module):
    """Self-attention + output projection with residual (bert.py:203-215)."""

    def __init__(self, dim_hidden, num_attention_heads, with_layernorm=False,
                 layer_norm_eps=1e-5, with_residual=True, use_sigmoid=False,
                 dtype=torch.float32, hidden_dropout_prob=0.5,
                 attention_probs_dropout_prob=0.0):
        super().__init__()
        self.with_residual = with_residual
        self.self = BertSelfAttention(dim_hidden, num_attention_heads,
                                      use_sigmoid, dtype,
                                      attention_probs_dropout_prob)
        self.output = BertSelfOutput(dim_hidden, with_layernorm,
                                     layer_norm_eps, dtype, hidden_dropout_prob)

    def forward(self, q, k, v, attention_mask=None, generator=None):
        out, probs = self.self(q, k, v, attention_mask, generator)
        return self.output(out, q if self.with_residual else None,
                           generator), probs


class BertIntermediate(nn.Module):
    """FFN up-projection + activation (reference models/bert.py:218-230)."""

    def __init__(self, dim_hidden, intermediate_size, hidden_act="gelu_new",
                 dtype=torch.float32):
        super().__init__()
        self.dense = Dense(dim_hidden, intermediate_size, compute_dtype=dtype)
        self.act = ACT2FN[hidden_act]

    def forward(self, hidden_states):
        return self.act(self.dense(hidden_states).to(torch.float32))


class BertOutput(nn.Module):
    """FFN down-projection + residual (reference models/bert.py:233-247)."""

    def __init__(self, intermediate_size, dim_hidden, with_layernorm=False,
                 layer_norm_eps=1e-5, dtype=torch.float32,
                 hidden_dropout_prob=0.5):
        super().__init__()
        self.p = hidden_dropout_prob
        self.dense = Dense(intermediate_size, dim_hidden, compute_dtype=dtype)
        self.LayerNorm = (LayerNorm(dim_hidden, layer_norm_eps)
                          if with_layernorm else None)

    def forward(self, hidden_states, input_tensor, generator=None):
        hidden_states = dropout(self.dense(hidden_states).to(torch.float32),
                                self.p, generator) + input_tensor
        if self.LayerNorm is not None:
            hidden_states = self.LayerNorm(hidden_states)
        return dropout(hidden_states, self.p, generator)


class BertLayer(nn.Module):
    """One decoder block: self-attn -> (pos-attn) -> cross-attn -> FFN
    (reference models/bert.py:250-303)."""

    def __init__(self, dim_hidden, num_attention_heads, intermediate_size,
                 hidden_act="gelu_new", with_layernorm=False,
                 layer_norm_eps=1e-5, pos_attention=False,
                 use_sigmoid_to_get_attprob=False, parallel_mlm=False,
                 dtype=torch.float32, hidden_dropout_prob=0.5,
                 attention_probs_dropout_prob=0.0):
        super().__init__()
        kw = dict(with_layernorm=with_layernorm, layer_norm_eps=layer_norm_eps,
                  use_sigmoid=use_sigmoid_to_get_attprob, dtype=dtype,
                  hidden_dropout_prob=hidden_dropout_prob,
                  attention_probs_dropout_prob=attention_probs_dropout_prob)
        self.attention = BertAttention(dim_hidden, num_attention_heads,
                                       with_residual=not parallel_mlm, **kw)
        self.pos_attention = (BertAttention(dim_hidden, num_attention_heads, **kw)
                              if pos_attention else None)
        self.attend_to_enc_output = BertAttention(dim_hidden,
                                                  num_attention_heads, **kw)
        self.intermediate = BertIntermediate(dim_hidden, intermediate_size,
                                             hidden_act, dtype)
        self.output = BertOutput(intermediate_size, dim_hidden, with_layernorm,
                                 layer_norm_eps, dtype, hidden_dropout_prob)

    def forward(self, hidden_states, non_pad_mask, attention_mask, enc_output,
                position_embeddings=None, generator=None,
                output_attentions: bool = False):
        """(layer_output, embs); with ``output_attentions`` also the
        attention probabilities (self, [pos], cross), each (B, nh, L, L_k)."""
        att, p_self = self.attention(hidden_states, hidden_states,
                                     hidden_states, attention_mask, generator)
        probs = [p_self]
        att = att * non_pad_mask
        if self.pos_attention is not None:
            att, p_pos = self.pos_attention(position_embeddings,
                                            position_embeddings, att,
                                            attention_mask, generator)
            probs.append(p_pos)
            att = att * non_pad_mask
        # the encoder output is never masked (reference Decoder.py:127-128)
        att, p_cross = self.attend_to_enc_output(att, enc_output, enc_output,
                                                 None, generator)
        probs.append(p_cross)
        att = att * non_pad_mask
        layer_output = self.output(self.intermediate(att), att,
                                   generator) * non_pad_mask
        embs = layer_output.sum(1) / non_pad_mask.sum(1)
        if output_attentions:
            return layer_output, embs, tuple(probs)
        return layer_output, embs


def init_linear_(layer: nn.Linear, generator: Optional[torch.Generator]):
    """torch nn.Linear's default law for weight AND bias,
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)), drawn from ``generator``."""
    bound = 1.0 / math.sqrt(layer.in_features)
    with torch.no_grad():
        layer.weight.uniform_(-bound, bound, generator=generator)
        if layer.bias is not None:
            layer.bias.uniform_(-bound, bound, generator=generator)
