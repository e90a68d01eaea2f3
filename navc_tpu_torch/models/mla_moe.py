"""The MLAMoE decoder: a DeepSeek-V3-type language model that captions a
video from the encoder's outputs as its first positions.

Kimi-VL-A3B-Instruct's language model (and Moonlight-16B-A3B's) is one:
27 layers at width 2048, latent attention with 16 heads, layer 0 a dense
SwiGLU MLP and layers 1-26 64 routed experts (6 a token, sigmoid router)
beside 2 shared ones, a vocabulary of 163,840 (``Config``'s ``lm_*``
fields and the decoder fields it shares with the BERT decoder).

The sequence of a video is ``[e_1 .. e_P, BOS, y_1 .. y_t]`` at positions
0 .. P + t, ``e_i`` the P = n_frames x streams outputs of the highway
encoder and fusion (``encode``, as ``Seq2Seq.encode``). Each layer, with
pre-norm residuals (DeepSeek-V3's modelling code, q_lora_rank null):

  * latent attention: ``q = W_q x`` split per head into ``q_nope``
    (qk_nope_head_dim) and ``q_pe`` (qk_rope_head_dim); ``[c, k_pe] =
    W_kva x`` (kv_lora_rank + qk_rope_head_dim), ``c <- RMSNorm(c)``,
    ``[k_nope, v] = W_kvb c`` per head; RoPE (rope_theta, the modelling
    code's pairing: interleaved pairs regrouped before ``rotate_half``) on
    ``q_pe`` and on ``k_pe``, which the heads share; scores
    ``(q_nope . k_nope + q_pe . k_pe) / sqrt(qk_nope + qk_rope)``, causal over
    the whole sequence (the prefix too), the output through ``W_o``;
  * FFN: the first ``lm_first_k_dense_replace`` layers
    ``W_down(silu(W_gate x) * W_up x)`` at ``intermediate_size``; the
    others the MoE: ``s = sigmoid(W_r x)``, the chosen set
    ``topk(s + b_corr, k)`` (``noaux_tc`` with one group: the correction
    bias only chooses), ``g = scale * s / (sum of the chosen s + 1e-20)``,
    ``y = sum_i g_i E_i(x) + E_shared(x)``, each E a SwiGLU MLP
    (``lm_moe_intermediate_size``; the shared one ``lm_n_shared_experts``
    times as wide);
  * a final RMSNorm, the untied ``lm_head`` and log-softmax.

The decode keeps, per layer and position, the 576-wide latent entry
``[RMSNorm(c), rope(k_pe)]`` (kv_lora_rank + qk_rope_head_dim): ``prefill``
writes the prefix's, ``decode_step`` one caption position a step and
attends in the absorbed form (``q_nope W_uk`` against ``c``, the output
through ``W_uv``), which equals the decompressed form.

Precision (``compute_dtype``; float32 computes all of it in float32): the
parameters are held once, in the compute dtype (the encoder, the fusion's
norms and ``b_corr`` in float32). The residual stream is float32. Every
RMSNorm runs in float32 and its output is rounded to the compute dtype as
the next product's operand. Products take compute-dtype operands, sum in
float32 and round their output to the compute dtype (torch.matmul,
torch._grouped_mm); the rotary products run in float32 and round after.
The router's product, sigmoid, choice and weights are float32 (from the
rounded normed input), the attention softmax float32 with its weights
rounded before the value products (the prefix's product rounded, the
caption's added to it in the same launch), SwiGLU's ``silu(g) * u`` (times
a routed pair's weight) float32 then rounded (K13 with the kernels, else
its plain version), the experts' k outputs of a token summed in float32, the logits
float32 (compute-dtype operands with a float32 output: K5 or a product
with a float32 output, where the card's torch has one), and the
log-softmax float32.

The routed experts run as one grouped product for gate/up and one for
down per MoE layer call: the (token, expert) pairs put in expert order on
the device by counting (the tokens per expert, their running sum the
groups' offsets, each pair's rank within its expert), so nothing is read
on the host and a decode captures as CUDA graphs. No token is dropped and there is no
capacity factor.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from ..config import Config
from .encoder import MultiStreamEncoder
from .fusion import Fusion
from ..ops.swiglu import swiglu, swiglu_plain


def compute_dtype(cfg: Config) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def uses_kernels(cfg: Config) -> bool:
    """Do the MLPs run K13 (the port's kernels on, bfloat16)?"""
    return cfg.use_pallas and cfg.compute_dtype == "bfloat16"


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """float32 RMSNorm of the last axis, ``x * rsqrt(mean(x^2) + eps) * w``."""
    return F.rms_norm(x.float(), (x.shape[-1],), weight.float(), eps)


def rope_tables(positions: torch.Tensor, dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) (S, dim) float32 of ``positions`` (S,), as the modelling
    code's rotary embedding makes them (frequencies repeated, not
    interleaved)."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, device=positions.device).float() / dim))
    ang = positions.float()[:, None] * inv[None, :]
    emb = torch.cat([ang, ang], dim=-1)
    return emb.cos(), emb.sin()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """RoPE on the last axis, float32: the interleaved pairs regrouped
    (evens, then odds) and rotated by ``rotate_half``; cos/sin broadcast."""
    x = x.float()
    d = x.shape[-1]
    x = x.reshape(*x.shape[:-1], d // 2, 2).transpose(-1, -2).reshape(x.shape)
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * cos + rot * sin


def logits_f32(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``h @ w^T`` with a float32 output: on the card from compute-dtype
    operands straight to float32 (``mm(out_dtype=)``), on the CPU the
    product rounded to the compute dtype and widened."""
    if h.dtype == torch.float32:
        return h @ w.t()
    if h.is_cuda:
        return torch.mm(h, w.t(), out_dtype=torch.float32)
    return (h @ w.t()).float()


def grouped_mm(a: torch.Tensor, w: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """Rows ``offs[e-1]:offs[e]`` of ``a`` (M, K) times ``w[e]^T`` ((E, N, K),
    nn.Linear's layout per expert), one launch: (M, N)."""
    return torch._grouped_mm(a, w.transpose(-2, -1), offs=offs)


class Linear(nn.Module):
    """A bias-free projection held in the compute dtype, (out, in)."""

    def __init__(self, n_in: int, n_out: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.in_features = n_in
        self.weight = nn.Parameter(torch.empty(n_out, n_in, dtype=dtype, device=device))
        self.bias = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.weight.dtype) @ self.weight.t()


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, dtype: torch.dtype, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.eps)


def activation(gu: torch.Tensor, w: Optional[torch.Tensor], kernels: bool) -> torch.Tensor:
    """SwiGLU's ``silu(g) * u`` (times a routed pair's weight ``w`` per row)
    of a gate/up product: K13 (``ops/swiglu.py``) with ``kernels``, else its
    plain version."""
    return swiglu(gu, w) if kernels else swiglu_plain(gu, w)


class MLP(nn.Module):
    """SwiGLU MLP, gate and up in one (2 * inter, d) product."""

    def __init__(self, d: int, inter: int, dtype: torch.dtype, device=None,
                 kernels: bool = False):
        super().__init__()
        self.inter, self.kernels = inter, kernels
        self.gate_up_proj = Linear(d, 2 * inter, dtype, device)
        self.down_proj = Linear(inter, d, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gu = self.gate_up_proj(x)
        return self.down_proj(activation(gu, None, self.kernels))


class Router(nn.Module):
    """The sigmoid router with ``noaux_tc``'s correction bias (one group)."""

    def __init__(self, d: int, n_experts: int, top_k: int, scale: float, dtype: torch.dtype,
                 device=None):
        super().__init__()
        self.top_k, self.scale = top_k, scale
        self.weight = nn.Parameter(torch.empty(n_experts, d, dtype=dtype, device=device))
        self.e_score_correction_bias = nn.Parameter(torch.zeros(n_experts, device=device))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(chosen experts (T, k) int64, their weights (T, k) float32)."""
        s = torch.sigmoid(x.float() @ self.weight.float().t())
        idx = torch.topk(s + self.e_score_correction_bias, self.top_k, dim=-1).indices
        g = s.gather(1, idx)
        return idx, g / (g.sum(-1, keepdim=True) + 1e-20) * self.scale


class Experts(nn.Module):
    """The routed experts' weights stacked: gate and up (E, 2 * inter, d),
    down (E, d, inter)."""

    def __init__(self, n_experts: int, d: int, inter: int, dtype: torch.dtype, device=None,
                 kernels: bool = False):
        super().__init__()
        self.inter, self.kernels = inter, kernels
        fk = dict(dtype=dtype, device=device)
        self.gate_up = nn.Parameter(torch.empty(n_experts, 2 * inter, d, **fk))
        self.down = nn.Parameter(torch.empty(n_experts, d, inter, **fk))

    def forward(self, x: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(sum_i g_i E_i(x) (T, d) float32, tokens per expert (E,) int32)
        for x (T, d) in the compute dtype: the pairs put in expert order
        (stable: token order within an expert) by counting, one grouped
        launch each for gate/up and down (each pair's weight g_i applied to
        its activation, before the linear down product), then gathered back
        into token order and summed over the k in float32."""
        t, k = idx.shape
        e = self.gate_up.shape[0]
        flat = idx.reshape(-1)
        hits = (torch.arange(e, device=x.device)[:, None] == flat[None, :]).to(torch.int32)
        counts = hits.sum(1, dtype=torch.int32)
        offs = counts.cumsum(0, dtype=torch.int32)
        # each pair's place in expert order: its expert's start + its rank there
        rank = hits.cumsum(1, dtype=torch.int32).gather(0, flat[None, :])[0] - 1
        place = ((offs - counts)[flat] + rank).long()
        order = torch.empty_like(place).scatter_(0, place, torch.arange(t * k, device=x.device))
        gu = grouped_mm(x[order // k], self.gate_up, offs)
        act = activation(gu, weight.reshape(-1)[order], self.kernels)
        y = grouped_mm(act, self.down, offs)
        return y.index_select(0, place).view(t, k, -1).sum(1, dtype=torch.float32), counts


class MoE(nn.Module):
    def __init__(self, cfg: Config, dtype: torch.dtype, device=None):
        super().__init__()
        d, inter = cfg.dim_hidden, cfg.lm_moe_intermediate_size
        kernels = uses_kernels(cfg)
        self.gate = Router(d, cfg.lm_n_routed_experts, cfg.lm_num_experts_per_tok,
                           cfg.lm_routed_scaling_factor, dtype, device)
        self.experts = Experts(cfg.lm_n_routed_experts, d, inter, dtype, device, kernels)
        self.shared_experts = MLP(d, inter * cfg.lm_n_shared_experts, dtype, device, kernels)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (..., d) compute dtype -> ((..., d) float32, tokens per expert)."""
        flat = x.reshape(-1, x.shape[-1])
        idx, g = self.gate(flat)
        routed, counts = self.experts(flat, idx, g)
        out = routed + self.shared_experts(flat).float()
        return out.view(*x.shape[:-1], -1), counts


class MLAttention(nn.Module):
    """Latent attention, q_lora_rank null."""

    def __init__(self, cfg: Config, dtype: torch.dtype, device=None):
        super().__init__()
        d, h = cfg.dim_hidden, cfg.num_attention_heads
        self.h, self.r = h, cfg.lm_kv_lora_rank
        self.dn, self.dr, self.dv = (cfg.lm_qk_nope_head_dim, cfg.lm_qk_rope_head_dim,
                                     cfg.lm_v_head_dim)
        self.scale = 1.0 / math.sqrt(self.dn + self.dr)
        self.q_proj = Linear(d, h * (self.dn + self.dr), dtype, device)
        self.kv_a_proj_with_mqa = Linear(d, self.r + self.dr, dtype, device)
        self.kv_a_layernorm = RMSNorm(self.r, cfg.lm_rms_norm_eps, dtype, device)
        self.kv_b_proj = Linear(self.r, h * (self.dn + self.dv), dtype, device)
        self.o_proj = Linear(h * self.dv, d, dtype, device)

    def project(self, x: torch.Tensor, cos, sin):
        """x (..., S, d) -> (q_nope (..., S, H, dn), rotated q_pe (..., S, H,
        dr), latent entries (..., S, r + dr)), all in the compute dtype."""
        dt = x.dtype
        q = self.q_proj(x).view(*x.shape[:-1], self.h, self.dn + self.dr)
        q_nope, q_pe = q[..., :self.dn], q[..., self.dn:]
        q_pe = apply_rope(q_pe, cos[:, None, :], sin[:, None, :]).to(dt)
        kva = self.kv_a_proj_with_mqa(x)
        c = self.kv_a_layernorm(kva[..., :self.r]).to(dt)
        k_pe = apply_rope(kva[..., self.r:], cos, sin).to(dt)
        return q_nope, q_pe, torch.cat([c, k_pe], dim=-1)

    def full(self, x: torch.Tensor, cos, sin) -> Tuple[torch.Tensor, torch.Tensor]:
        """Causal attention over the whole (N, S) sequence with the keys and
        values decompressed: (output (N, S, d), latent entries (N, S, r + dr))."""
        n, s, _ = x.shape
        q_nope, q_pe, entry = self.project(x, cos, sin)
        kv = self.kv_b_proj(entry[..., :self.r]).view(n, s, self.h, self.dn + self.dv)
        k_pe = entry[..., None, self.r:].expand(n, s, self.h, self.dr)
        q = torch.cat([q_nope, q_pe], -1).transpose(1, 2)
        k = torch.cat([kv[..., :self.dn], k_pe], -1).transpose(1, 2)
        v = kv[..., self.dn:].transpose(1, 2)
        scores = (q @ k.transpose(-1, -2)).float() * self.scale
        causal = torch.ones(s, s, dtype=torch.bool, device=x.device).triu(1)
        p = torch.softmax(scores.masked_fill(causal, float("-inf")), -1).to(x.dtype)
        out = (p @ v).transpose(1, 2).reshape(n, s, self.h * self.dv)
        return self.o_proj(out), entry

    def absorbed(self):
        """(W_uk (H, dn, r), W_uv (H, dv, r)): kv_b_proj's parts."""
        w = self.kv_b_proj.weight.view(self.h, self.dn + self.dv, self.r)
        return w[:, :self.dn], w[:, self.dn:]

    def cached(self, x: torch.Tensor, cos, sin, prefix: torch.Tensor,
               caption: torch.Tensor, t: int, k: int) -> torch.Tensor:
        """One new position per row of x (n, d), n = b videos x k beams, in
        the absorbed form. ``prefix`` (b, P, r + dr): the video's prefix
        entries, shared by its k rows; ``caption`` (n, T, r + dr): this
        layer's caption entries, position t - 1 written here before the
        attention reads positions 0 .. t - 1. Returns (n, d)."""
        n = x.shape[0]
        b = n // k
        q_nope, q_pe, entry = self.project(x[:, None], cos, sin)
        caption[:, t - 1] = entry[:, 0]
        w_uk, w_uv = self.absorbed()
        q_lat = torch.bmm(q_nope[:, 0].transpose(0, 1), w_uk).transpose(0, 1)  # (n, H, r)
        q = torch.cat([q_lat, q_pe[:, 0]], -1)                                 # (n, H, r + dr)
        cap = caption[:, :t]
        s_pre = torch.bmm(q.reshape(b, k * self.h, -1), prefix.transpose(1, 2))
        s_cap = torch.bmm(q, cap.transpose(1, 2))
        scores = torch.cat([s_pre.view(n, self.h, -1), s_cap], -1).float() * self.scale
        p = torch.softmax(scores, -1).to(x.dtype)
        npre = prefix.shape[1]
        lat = torch.baddbmm(
            torch.bmm(p[..., :npre].reshape(b, k * self.h, npre), prefix[..., :self.r])
            .view(n, self.h, self.r), p[..., npre:], cap[..., :self.r])
        out = torch.bmm(lat.transpose(0, 1), w_uv.transpose(1, 2)).transpose(0, 1)
        return self.o_proj(out.reshape(n, self.h * self.dv))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: Config, dense: bool, dtype: torch.dtype, device=None):
        super().__init__()
        eps = cfg.lm_rms_norm_eps
        self.input_layernorm = RMSNorm(cfg.dim_hidden, eps, dtype, device)
        self.self_attn = MLAttention(cfg, dtype, device)
        self.post_attention_layernorm = RMSNorm(cfg.dim_hidden, eps, dtype, device)
        self.mlp = (MLP(cfg.dim_hidden, cfg.intermediate_size, dtype, device,
                        uses_kernels(cfg)) if dense else MoE(cfg, dtype, device))
        self.dense = dense

    def ffn(self, x: torch.Tensor, dt) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """x + FFN(RMSNorm(x)) and the MoE's tokens per expert (None dense)."""
        h = self.post_attention_layernorm(x).to(dt)
        if self.dense:
            return x + self.mlp(h).float(), None
        out, counts = self.mlp(h)
        return x + out, counts


class MLAMoELM(nn.Module):
    """The language model: token embeddings, the layers, the final norm and
    the untied head."""

    def __init__(self, cfg: Config, dtype: torch.dtype, device=None):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.dim_hidden, dtype=dtype,
                                         device=device, _weight=torch.empty(
                                             cfg.vocab_size, cfg.dim_hidden, dtype=dtype,
                                             device=device))
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, i < cfg.lm_first_k_dense_replace, dtype, device)
            for i in range(cfg.num_hidden_layers_decoder))
        self.norm = RMSNorm(cfg.dim_hidden, cfg.lm_rms_norm_eps, dtype, device)
        self.lm_head = Linear(cfg.dim_hidden, cfg.vocab_size, dtype, device)

    @property
    def n_moe(self) -> int:
        return sum(not layer.dense for layer in self.layers)

    def rope(self, positions: torch.Tensor):
        return rope_tables(positions, self.cfg.lm_qk_rope_head_dim, self.cfg.lm_rope_theta)

    def full(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The layers over the whole (N, S, d) float32 input sequence, causal:
        (final hidden states (N, S, d) float32 before the final norm, latent
        entries (layers, N, S, r + dr), tokens per expert (MoE layers, E))."""
        dt = self.dtype
        cos, sin = self.rope(torch.arange(x.shape[1], device=x.device))
        entries, counts = [], []
        for layer in self.layers:
            att, entry = layer.self_attn.full(layer.input_layernorm(x).to(dt), cos, sin)
            x, c = layer.ffn(x + att.float(), dt)
            entries.append(entry)
            if c is not None:
                counts.append(c)
        return x, torch.stack(entries), torch.stack(counts)

    def embed(self, prefix: torch.Tensor, tokens: Optional[torch.Tensor]) -> torch.Tensor:
        """[prefix, embed(tokens)] as the float32 input sequence."""
        x = prefix.float()
        if tokens is not None:
            x = torch.cat([x, self.embed_tokens(tokens.long()).float()], 1)
        return x

    def head_input(self, hidden: torch.Tensor) -> torch.Tensor:
        """The final RMSNorm of hidden states (..., d), in the compute dtype:
        the head's operand."""
        return self.norm(hidden).to(self.dtype)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """float32 logits of final hidden states (..., d)."""
        h = self.head_input(hidden)
        flat = h.reshape(-1, h.shape[-1])
        return logits_f32(flat, self.lm_head.weight).view(*h.shape[:-1], -1)

    def forward(self, prefix: torch.Tensor, tokens: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """Teacher-forced float32 log-probs (N, P + S, V) of [prefix, tokens]."""
        hidden, _, _ = self.full(self.embed(prefix, tokens))
        return torch.log_softmax(self.logits(hidden), -1)

    def prefill(self, prefix: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The prefix's latent entries (layers, b, P, r + dr) and its tokens
        per expert (MoE layers, E)."""
        _, entries, counts = self.full(self.embed(prefix, None))
        return entries, counts

    def decode_step(self, tokens: torch.Tensor, t: int, prefix: torch.Tensor,
                    caption: torch.Tensor, k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Caption position t - 1 (token ``tokens`` (n,), at sequence
        position P + t - 1) of n = b x k rows through every layer against the
        caches: ``prefix`` (layers, b, P, r + dr) from ``prefill``, ``caption``
        (n, layers, T, r + dr), whose position t - 1 this step writes.
        Returns (the final hidden states (n, d) float32, before the final
        norm, tokens per expert (MoE layers, E))."""
        dt = self.dtype
        pos = torch.full((1,), prefix.shape[2] + t - 1, device=tokens.device)
        cos, sin = self.rope(pos)
        x = self.embed_tokens(tokens.long()).float()
        counts = []
        for i, layer in enumerate(self.layers):
            att = layer.self_attn.cached(layer.input_layernorm(x).to(dt), cos, sin,
                                         prefix[i], caption[:, i], t, k)
            x, c = layer.ffn(x + att.float(), dt)
            if c is not None:
                counts.append(c)
        return x, torch.stack(counts)


class CaptionLM(nn.Module):
    """The highway encoder and fusion (``Seq2Seq``'s, float32) and the
    MLAMoE language model, which reads the encoder's outputs as its
    prefix. Made on ``device``, the language model's parameters left
    unfilled (a caller draws or loads them in place: at the published
    widths they are 31.9 GB)."""

    def __init__(self, cfg: Config, device=None):
        super().__init__()
        self.cfg = cfg
        self.encoder = MultiStreamEncoder(cfg.modality, cfg.modality_dims,
                                          cfg.dim_hidden, cfg.encoder_dropout).to(device)
        self.fusion = Fusion(cfg.fusion, cfg.norm_type, cfg.no_encoder_bn,
                             len(cfg.modality), cfg.dim_hidden).to(device)
        self.lm = MLAMoELM(cfg, compute_dtype(cfg), device)

    def encode(self, feats: Sequence[torch.Tensor], train: bool = False,
               generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        enc_outputs, enc_hiddens = self.encoder(list(feats), generator)
        enc_output, enc_hidden = self.fusion(enc_outputs, enc_hiddens, train)
        return {"enc_output": enc_output, "enc_hidden": enc_hidden}

    def forward(self, feats: Sequence[torch.Tensor], tokens: torch.Tensor) -> torch.Tensor:
        """Teacher-forced log-probs (B, S, V) of ``tokens`` (B, S) after the
        video's prefix: position i predicts token i + 1 (BOS first)."""
        prefix = self.encode(feats)["enc_output"]
        return self.lm(prefix, tokens)[:, prefix.shape[1]:]
