"""The captioning model in plain PyTorch, from a state dict.

The benchmark's reference for navc_tpu_torch's Seq2Seq (the highway
encoder, BatchNorm fusion, the length head and the one-layer BERT-style
decoder of Yang et al., "Non-Autoregressive Coarse-to-Fine Video
Captioning", AAAI 2021). It imports nothing of the program: it follows the
published model (the reference code's models/Encoder.py,
joint_representation.py, Predictor.py, bert.py and Decoder.py) on the
parameter names of the state dict the benchmark makes, with no kernel, no
cache and no batching across requests. The arithmetic is a ``Precision``:
``FP32`` (float32, TF32 off); ``BF16Kernel`` and ``BF16Dense``, the
configuration's bfloat16 at the rounding points the program documents for
its NAR kernels and for its KV-cached beam step; ``FP8``, the control.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

PAD, UNK, BOS, EOS, MASK, VIS = 0, 1, 2, 3, 4, 5
MASK_FILL = -10e6  # the reference code's additive mask (bert.py:161)


class Precision:
    """float32 products (TF32 off while the reference runs)."""

    name = "fp32"

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """An operand of a decoder product."""
        return x.float()

    def enc_q(self, x: torch.Tensor) -> torch.Tensor:
        """An operand of an encoder product."""
        return x.float()

    def r(self, x: torch.Tensor) -> torch.Tensor:
        """A stored activation: the attention's q, k, v and weights, the
        embedding's parts, the layer's output."""
        return x

    def dense(self, x, w, b=None):
        """A decoder Linear, w (out, in)."""
        y = self.q(x) @ self.q(w).t()
        return y if b is None else y + b.float()

    def embed(self, words, static):
        return words + static


def _bf(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


class BF16Kernel(Precision):
    """bfloat16 at the NAR kernels' rounding points (K1-K4 and their
    documented plain arithmetic): bf16 operands with float32 sums and a
    float32 bias; q, k, v, the attention weights, the word rows, the
    static embedding rows and the layer's output rounded to bf16; the
    encoder in float32 (its Linear layers are not bf16)."""

    name = "bf16"

    def q(self, x):
        return _bf(x)

    def r(self, x):
        return _bf(x)

    def embed(self, words, static):
        return _bf(words) + _bf(static)


class BF16Dense(BF16Kernel):
    """bfloat16 as flax's Dense(dtype=bf16) computes it, the KV-cached beam
    step's arithmetic: the product rounded to bf16, the bias added in bf16;
    the embeddings in float32."""

    def dense(self, x, w, b=None):
        y = _bf(_bf(x) @ _bf(w).t())
        return y if b is None else _bf(y + _bf(b))

    def embed(self, words, static):
        return words + static


class FP8(Precision):
    """The control: ``base``'s arithmetic with every product's operands,
    the encoder's included, rounded to float8 e4m3 after scaling the
    tensor's largest magnitude to e4m3's largest (448), the products taken
    in float32 and scaled back: the fp8 route a later change might take
    for the configuration's bfloat16."""

    name = "fp8"

    def __init__(self, base: Precision):
        self.base = base

    def q(self, x):
        x = x.float()
        scale = 448.0 / x.abs().amax().clamp(min=1e-12)
        return (x * scale).to(torch.float8_e4m3fn).float() / scale

    enc_q = q

    def r(self, x):
        return self.base.r(x)

    def dense(self, x, w, b=None):
        y = self.q(x) @ self.q(w).t()
        if isinstance(self.base, BF16Dense):
            y = _bf(y)
            return y if b is None else _bf(y + _bf(b))
        return y if b is None else y + b.float()

    def embed(self, words, static):
        return self.base.embed(words, static)


FP32 = Precision()
PRECISIONS = {"fp32": lambda kind: FP32,
              "bf16": lambda kind: BF16Kernel() if kind == "nacf" else BF16Dense(),
              "fp8": lambda kind: FP8(BF16Kernel() if kind == "nacf" else BF16Dense())}


def param_shapes(m: Dict) -> Dict[str, tuple]:
    """{state-dict key: shape} of the model the configuration ``m`` (a
    configuration file's "model" entry) describes."""
    d, inter, v, L = m["dim_hidden"], m["intermediate_size"], m["vocab_size"], m["max_len"]
    shapes: Dict[str, tuple] = {}

    def linear(name, n_in, n_out, bias=True):
        shapes[name + ".weight"] = (n_out, n_in)
        if bias:
            shapes[name + ".bias"] = (n_out,)

    for ch, dim in zip(m["modality"], m["modality_dims"]):
        s = "encoder.streams.Encoder_%s." % ch.upper()
        linear(s + "linear", dim, d)
        linear(s + "highway.w1", d, d)
        linear(s + "highway.w2", d, d)
    for i in range(len(m["modality"])):
        for k in ("weight", "bias", "running_mean", "running_var"):
            shapes["fusion.norms.bn%d.%s" % (i, k)] = (d,)
        shapes["fusion.norms.bn%d.num_batches_tracked" % i] = ()
    if m["length_head"]:
        linear("predictors.predictor_length.fc1", d, d)
        linear("predictors.predictor_length.fc2", d, L)
    e = "decoder.embedding."
    shapes[e + "word_embeddings.weight"] = (v, d)
    shapes[e + "position_embeddings.weight"] = (L, d)
    if m["with_category"]:
        shapes[e + "category_embeddings.weight"] = (m["num_category"], d)
    shapes[e + "LayerNorm.weight"] = (d,)
    shapes[e + "LayerNorm.bias"] = (d,)
    lay = "decoder.layers.0."
    for blk in ("attention", "attend_to_enc_output"):
        for p in ("query", "key", "value"):
            linear(lay + blk + ".self." + p, d, d)
        linear(lay + blk + ".output.dense", d, d)
    linear(lay + "intermediate.dense", d, inter)
    linear(lay + "output.dense", inter, d)
    linear("tgt_word_prj", d, v, bias=False)
    return shapes


def _lin(sd, name, x, p: Precision):
    return p.dense(x, sd[name + ".weight"], sd.get(name + ".bias"))


def _enc_lin(sd, name, x, p: Precision):
    y = p.enc_q(x) @ p.enc_q(sd[name + ".weight"]).t()
    return y + sd[name + ".bias"]


def encode(sd: Dict[str, torch.Tensor], m: Dict, feats: List[torch.Tensor],
           p: Precision = FP32) -> Dict[str, torch.Tensor]:
    """Highway streams (Encoder.py:9-25, 47-59), BatchNorm with the running
    statistics and temporal concatenation (joint_representation.py:24-53),
    the length head (Predictor.py:12-30): {'enc_output' (B, T*streams, d),
    'pred_length' (B, max_len) log-probs when the model has the head}."""
    outs = []
    for i, (ch, f) in enumerate(zip(m["modality"], feats)):
        s = "encoder.streams.Encoder_%s." % ch.upper()
        x = _enc_lin(sd, s + "linear", f.float(), p)
        y = torch.tanh(_enc_lin(sd, s + "highway.w1", x, p))
        gate = torch.sigmoid(_enc_lin(sd, s + "highway.w2", x, p))
        x = gate * x + (1.0 - gate) * y
        bn = "fusion.norms.bn%d." % i
        x = ((x - sd[bn + "running_mean"])
             * (torch.rsqrt(sd[bn + "running_var"] + 1e-5) * sd[bn + "weight"]) + sd[bn + "bias"])
        outs.append(x)
    enc = torch.cat(outs, dim=1)
    res = {"enc_output": enc}
    if m["length_head"]:
        hid = torch.relu(_enc_lin(sd, "predictors.predictor_length.fc1", enc.mean(1), p))
        res["pred_length"] = torch.log_softmax(
            _enc_lin(sd, "predictors.predictor_length.fc2", hid, p), dim=-1)
    return res


def _layer_norm(x, w, b, eps):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * w + b


def _softmax(x):
    e = torch.exp(x - x.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def _attend(sd, name, q_in, kv, mask, n_head, p: Precision):
    """Multi-head attention + output projection (bert.py:115-200), no
    residual; ``kv`` the (keys, values) rows; ``mask`` (B, Lq, Lk) True =
    masked out, or None."""
    b, lq, d = q_in.shape
    dh = d // n_head

    def heads(x):
        return x.reshape(x.shape[0], x.shape[1], n_head, dh).transpose(1, 2)

    q = heads(p.r(_lin(sd, name + ".self.query", q_in, p)))
    k, v = (heads(x) for x in kv)
    scores = (p.q(q) @ p.q(k).transpose(-1, -2)) * (1.0 / math.sqrt(dh))
    if mask is not None:
        scores = scores.masked_fill(mask[:, None], MASK_FILL)
    out = (p.q(p.r(_softmax(scores))) @ p.q(v)).transpose(1, 2).reshape(b, lq, d)
    return _lin(sd, name + ".output.dense", out, p)


def cross_kv(sd, enc_output, p: Precision = FP32):
    """The cross-attention's keys and values of the encoder output."""
    name = "decoder.layers.0.attend_to_enc_output.self."
    return tuple(p.r(_lin(sd, name + k, enc_output, p)) for k in ("key", "value"))


def _gelu_new(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x * x * x)))


def decode(sd: Dict[str, torch.Tensor], m: Dict, tokens: torch.Tensor,
           enc_output: torch.Tensor, category: Optional[torch.Tensor], causal: bool,
           p: Precision = FP32, enc_kv=None) -> torch.Tensor:
    """The decoder's last hidden states (N, L, d) for token ids (N, L)
    (Decoder.py:100-178): NAR (``causal`` False) masks PAD keys and adds the
    temporal mean of the encoder output to the embeddings (enhance_input 2);
    AR masks PAD keys and the future. The encoder output is never masked;
    ``enc_kv``: its cross keys and values (``cross_kv``), made here if None."""
    n, l = tokens.shape
    e = "decoder.embedding."
    static = sd[e + "position_embeddings.weight"][:l][None].expand(n, l, -1)
    if m["with_category"]:
        static = static + sd[e + "category_embeddings.weight"][
            category.reshape(n, -1)[:, 0].long()][:, None]
    if not causal:
        static = static + enc_output.mean(1, keepdim=True)
    x = p.embed(sd[e + "word_embeddings.weight"][tokens.long()], static)
    x = _layer_norm(x, sd[e + "LayerNorm.weight"], sd[e + "LayerNorm.bias"], m["layer_norm_eps"])
    mask = (tokens == PAD)[:, None, :].expand(n, l, l)
    if causal:
        mask = mask | torch.triu(torch.ones(l, l, dtype=torch.bool, device=tokens.device), 1)
    npm = (tokens != PAD).float()[..., None]
    lay = "decoder.layers.0."
    nh = m["num_attention_heads"]
    self_kv = tuple(p.r(_lin(sd, lay + "attention.self." + k, x, p)) for k in ("key", "value"))
    att = (_attend(sd, lay + "attention", x, self_kv, mask, nh, p) + x) * npm
    if enc_kv is None:
        enc_kv = cross_kv(sd, enc_output, p)
    att = (_attend(sd, lay + "attend_to_enc_output", att, enc_kv, None, nh, p) + att) * npm
    inter = _gelu_new(_lin(sd, lay + "intermediate.dense", att, p))
    return p.r((_lin(sd, lay + "output.dense", inter, p) + att) * npm)


def project(sd, hidden: torch.Tensor, p: Precision = FP32) -> torch.Tensor:
    """Vocabulary logits (the bias-free tgt_word_prj, seq2seq.py:27-33),
    float32 sums."""
    return p.q(hidden) @ p.q(sd["tgt_word_prj.weight"]).t()
