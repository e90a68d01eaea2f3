"""The MLAMoE captioning language model in plain PyTorch, from a state dict.

The benchmark's reference for navc_tpu_torch's CaptionLM: the highway
encoder and BatchNorm fusion (``model.encode``) and a DeepSeek-V3-type
language model (Kimi-VL-A3B-Instruct's, DeepSeek-V3's modelling code,
q_lora_rank null) over ``[e_1 .. e_P, BOS, y_1 ..]``. It imports nothing of
the program and follows the published layer equations on the parameter
names of the state dict the benchmark makes:

  * RMSNorm in float32; RoPE with the modelling code's pairing
    (interleaved pairs regrouped, then ``rotate_half``, frequencies
    repeated), theta from the configuration, no scaling;
  * latent attention in its naive form: ``[k_nope, v] = W_kvb
    RMSNorm(c)`` decompressed per head, the rotary key shared by the
    heads, scores ``(q_nope . k_nope + q_pe . k_pe) / sqrt(dn + dr)``, a
    causal softmax over the whole sequence, prefix included;
  * layer 0 (``first_k_dense_replace``) a dense SwiGLU MLP; the others the
    sigmoid router (``noaux_tc``: the chosen experts ``topk(s + b_corr)``,
    their weights ``scale * s / (sum + 1e-20)``), each chosen expert run in
    a loop over the experts, plus the shared experts;
  * a final RMSNorm, the untied head and log-softmax.

No cache, no kernel, no batching across requests (each sequence stands
alone; a block of them is only stacked). Departures from the published
model, all forced by the system's inputs: the vision tower and its
projector do not run; the prefix is the repo's encoder output; BOS and
EOS are the repo's ids inside the 163,840-id vocabulary; no chat template.

The arithmetic is a ``Precision``: float32 (TF32 off while the reference
runs, ``decode._no_tf32``), or ``FP8``, the control: every product's
operands rounded to float8 e4m3 after scaling each tensor's largest
magnitude to 448, the products taken in float32.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from . import model as R
from .decode import _no_tf32

BOS, EOS = R.BOS, R.EOS


class Precision:
    name = "fp32"

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return x.float()


class FP8(Precision):
    name = "fp8"

    def q(self, x):
        x = x.float()
        scale = 448.0 / x.abs().amax().clamp(min=1e-12)
        return (x * scale).to(torch.float8_e4m3fn).float() / scale


FP32 = Precision()
PRECISIONS = {"fp32": FP32, "fp8": FP8()}


def encoder_entry(m: Dict) -> Dict:
    """The encoder's entry for ``model.encode``/``model.param_shapes``."""
    return {"modality": m["modality"], "modality_dims": m["modality_dims"],
            "n_frames": m["n_frames"], "dim_hidden": m["hidden_size"], "length_head": False}


def param_shapes(m: Dict) -> Dict[str, tuple]:
    """{state-dict key: shape} of the model a configuration file describes
    (the published keys at its top level, the encoder's under their
    names)."""
    d, h, v = m["hidden_size"], m["num_attention_heads"], m["vocab_size"]
    dn, dr, dv, r = (m["qk_nope_head_dim"], m["qk_rope_head_dim"], m["v_head_dim"],
                     m["kv_lora_rank"])
    e, inter = m["n_routed_experts"], m["moe_intermediate_size"]
    shapes = {k: s for k, s in R.param_shapes(dict(
        encoder_entry(m), dim_hidden=d, intermediate_size=1, vocab_size=1, max_len=1,
        with_category=False)).items() if k.startswith(("encoder.", "fusion."))}
    shapes["lm.embed_tokens.weight"] = (v, d)
    for i in range(m["num_hidden_layers"]):
        p = "lm.layers.%d." % i
        shapes[p + "input_layernorm.weight"] = (d,)
        shapes[p + "self_attn.q_proj.weight"] = (h * (dn + dr), d)
        shapes[p + "self_attn.kv_a_proj_with_mqa.weight"] = (r + dr, d)
        shapes[p + "self_attn.kv_a_layernorm.weight"] = (r,)
        shapes[p + "self_attn.kv_b_proj.weight"] = (h * (dn + dv), r)
        shapes[p + "self_attn.o_proj.weight"] = (d, h * dv)
        shapes[p + "post_attention_layernorm.weight"] = (d,)
        if i < m["first_k_dense_replace"]:
            shapes[p + "mlp.gate_up_proj.weight"] = (2 * m["intermediate_size"], d)
            shapes[p + "mlp.down_proj.weight"] = (d, m["intermediate_size"])
        else:
            shared = inter * m["n_shared_experts"]
            shapes[p + "mlp.gate.weight"] = (e, d)
            shapes[p + "mlp.gate.e_score_correction_bias"] = (e,)
            shapes[p + "mlp.experts.gate_up"] = (e, 2 * inter, d)
            shapes[p + "mlp.experts.down"] = (e, d, inter)
            shapes[p + "mlp.shared_experts.gate_up_proj.weight"] = (2 * shared, d)
            shapes[p + "mlp.shared_experts.down_proj.weight"] = (d, shared)
    shapes["lm.norm.weight"] = (d,)
    shapes["lm.lm_head.weight"] = (v, d)
    return shapes


def _rms(x, w, eps):
    x = x.float()
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def _mm(x, w, p: Precision):
    """x @ w^T, w (out, in)."""
    return p.q(x) @ p.q(w).t()


def _swiglu(x, gate_up, down, p):
    gu = _mm(x, gate_up, p)
    inter = gate_up.shape[0] // 2
    return _mm(torch.nn.functional.silu(gu[..., :inter]) * gu[..., inter:], down, p)


def route(sd, pre, x, m, p: Precision = FP32) -> Tuple[torch.Tensor, torch.Tensor]:
    """(chosen experts (T, k), their weights (T, k)) of rows x (T, d)."""
    s = torch.sigmoid(_mm(x, sd[pre + "gate.weight"], p))
    idx = torch.topk(s + sd[pre + "gate.e_score_correction_bias"].float(),
                     m["num_experts_per_tok"], dim=-1).indices
    g = s.gather(1, idx)
    return idx, g / (g.sum(-1, keepdim=True) + 1e-20) * m["routed_scaling_factor"]


def moe(sd, pre, x, m, p: Precision = FP32) -> torch.Tensor:
    """The MoE layer on rows x (T, d): each chosen expert in a loop, plus
    the shared experts."""
    idx, g = route(sd, pre, x, m, p)
    out = torch.zeros_like(x)
    for e in range(m["n_routed_experts"]):
        chosen = idx == e
        rows = chosen.any(1)
        if not bool(rows.any()):
            continue
        y = _swiglu(x[rows], sd[pre + "experts.gate_up"][e], sd[pre + "experts.down"][e], p)
        out[rows] += (g * chosen).sum(1)[rows][:, None] * y
    return out + _swiglu(x, sd[pre + "shared_experts.gate_up_proj.weight"],
                         sd[pre + "shared_experts.down_proj.weight"], p)


def attention(sd, pre, x, m, p: Precision = FP32) -> torch.Tensor:
    """Naive latent attention over (N, S, d), causal, keys and values
    decompressed."""
    n, s, _ = x.shape
    h, dn, dr, dv, r = (m["num_attention_heads"], m["qk_nope_head_dim"], m["qk_rope_head_dim"],
                        m["v_head_dim"], m["kv_lora_rank"])
    pos = torch.arange(s, device=x.device)
    q = _mm(x, sd[pre + "q_proj.weight"], p).view(n, s, h, dn + dr)
    kva = _mm(x, sd[pre + "kv_a_proj_with_mqa.weight"], p)
    c = _rms(kva[..., :r], sd[pre + "kv_a_layernorm.weight"], m["rms_norm_eps"])
    kv = _mm(c, sd[pre + "kv_b_proj.weight"], p).view(n, s, h, dn + dv)
    q_pe = rope(q[..., dn:].transpose(1, 2), pos, dr, m["rope_theta"])      # (n, h, s, dr)
    k_pe = rope(kva[..., r:], pos, dr, m["rope_theta"])[:, None]             # (n, 1, s, dr)
    qh = torch.cat([q[..., :dn].transpose(1, 2), q_pe], -1)
    kh = torch.cat([kv[..., :dn].transpose(1, 2), k_pe.expand(n, h, s, dr)], -1)
    scores = (p.q(qh) @ p.q(kh).transpose(-1, -2)) / math.sqrt(dn + dr)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).triu(1)
    w = torch.softmax(scores.masked_fill(causal, float("-inf")), -1)
    out = (p.q(w) @ p.q(kv[..., dn:].transpose(1, 2))).transpose(1, 2).reshape(n, s, h * dv)
    return _mm(out, sd[pre + "o_proj.weight"], p)


def rope(x, positions, dim, theta):
    """RoPE on the last axis of x (..., S, dim) at ``positions`` (S,)."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, device=x.device).float() / dim))
    ang = positions.float()[:, None] * inv[None, :]
    emb = torch.cat([ang, ang], -1)
    x = x.float()
    x = x.reshape(*x.shape[:-1], dim // 2, 2).transpose(-1, -2).reshape(x.shape)
    rot = torch.cat([-x[..., dim // 2:], x[..., :dim // 2]], -1)
    return x * emb.cos() + rot * emb.sin()


def hidden(sd, m, x: torch.Tensor, p: Precision = FP32) -> torch.Tensor:
    """Every layer over the float32 input sequence x (N, S, d), then the
    final RMSNorm."""
    eps = m["rms_norm_eps"]
    for i in range(m["num_hidden_layers"]):
        pre = "lm.layers.%d." % i
        x = x + attention(sd, pre + "self_attn.", _rms(x, sd[pre + "input_layernorm.weight"],
                                                          eps), m, p)
        h = _rms(x, sd[pre + "post_attention_layernorm.weight"], eps)
        if i < m["first_k_dense_replace"]:
            x = x + _swiglu(h, sd[pre + "mlp.gate_up_proj.weight"],
                            sd[pre + "mlp.down_proj.weight"], p)
        else:
            n, s, d = h.shape
            x = x + moe(sd, pre + "mlp.", h.reshape(n * s, d), m, p).view(n, s, d)
    return _rms(x, sd["lm.norm.weight"], eps)


def logprobs(sd, m, x: torch.Tensor, p: Precision = FP32) -> torch.Tensor:
    """log_softmax of the head over every position of x (N, S, d)."""
    return torch.log_softmax(_mm(hidden(sd, m, x, p), sd["lm.lm_head.weight"], p), -1)


def prefix_of(sd, m, feats: List[torch.Tensor], p: Precision = FP32) -> torch.Tensor:
    """The encoder's outputs (B, P, d), the language model's prefix."""
    enc_p = R.FP32 if p.name == "fp32" else R.FP8(R.FP32)
    return R.encode(sd, encoder_entry(m), [f.float() for f in feats], enc_p)["enc_output"]


def sequence(sd, prefix: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """[prefix, embed(tokens)] float32."""
    return torch.cat([prefix.float(), sd["lm.embed_tokens.weight"][tokens.long()].float()], 1)


def teacher_forced(sd, m, feats: List[torch.Tensor], captions: torch.Tensor, k: int,
                   precision: str = "fp32", block: int = 64, score=None):
    """For captions (B, T) (what follows BOS), at each of their positions:
    (the log-probability of the caption's token, or of ``score``'s (B, T)
    where given, the k-th best log-probability, the best token), each
    (B, T), from one forward over ``[prefix, BOS, captions[:, :-1]]`` per
    block of videos."""
    p = PRECISIONS[precision]
    out = []
    with _no_tf32(), torch.no_grad():
        for s in range(0, captions.shape[0], block):
            part = slice(s, s + block)
            prefix = prefix_of(sd, m, [f[part] for f in feats], p)
            cap = captions[part].long()
            bos = torch.full((cap.shape[0], 1), BOS, dtype=torch.long, device=cap.device)
            lp = logprobs(sd, m, sequence(sd, prefix, torch.cat([bos, cap[:, :-1]], 1)),
                          p)[:, prefix.shape[1]:]
            top = torch.topk(lp, k, dim=-1)
            which = cap if score is None else score[part].long()
            out.append((lp.gather(-1, which[..., None])[..., 0], top.values[..., -1],
                        top.indices[..., 0]))
    return tuple(torch.cat(parts) for parts in zip(*out))


def beam(sd, m, feats: List[torch.Tensor], beam_size: int, max_len: int, alpha: float,
         precision: str = "fp32") -> Tuple[torch.Tensor, torch.Tensor]:
    """(captions (B, max_len - 1), each token's log-probability) by beam
    search (Beam.py, Translator.py), recomputing the whole sequence every
    step: k beams; the first step draws from beam 0 alone; a beam that
    ended in EOS proposes nothing more; a video is done once k hypotheses
    ended; at max_len a video with none takes every beam; the best by score
    / length**alpha."""
    p, k, L = PRECISIONS[precision], beam_size, max_len
    with _no_tf32(), torch.no_grad():
        prefix = prefix_of(sd, m, feats, p)
        b, dev = prefix.shape[0], prefix.device
        n = b * k
        prefix_t = prefix.repeat_interleave(k, 0)
        seqs = torch.zeros((b, k, L), dtype=torch.long, device=dev)
        seqs[:, :, 0] = BOS
        lps = torch.zeros((b, k, L), device=dev)
        scores = torch.full((b, k), -1e20, device=dev)
        scores[:, 0] = 0.0
        last = torch.full((b, k), BOS, dtype=torch.long, device=dev)
        finished: List[List[tuple]] = [[] for _ in range(b)]
        done = torch.zeros(b, dtype=torch.bool, device=dev)
        for t in range(1, L):
            x = sequence(sd, prefix_t, seqs.reshape(n, L)[:, :t])
            logp = logprobs(sd, m, x, p)[:, -1].view(b, k, -1)
            v = logp.shape[-1]
            cand = torch.where((last == EOS)[:, :, None], -1e20, logp + scores[:, :, None])
            best, flat = torch.sort(cand.reshape(b, k * v), dim=-1, descending=True, stable=True)
            best, flat = best[:, :k], flat[:, :k]
            prev, word = flat // v, flat % v
            new = torch.gather(seqs, 1, prev[:, :, None].expand(b, k, L)).clone()
            new[:, :, t] = word
            new_lp = torch.gather(lps, 1, prev[:, :, None].expand(b, k, L)).clone()
            new_lp[:, :, t] = logp.reshape(b, k * v).gather(1, flat)
            active = ~done
            seqs = torch.where(active[:, None, None], new, seqs)
            lps = torch.where(active[:, None, None], new_lp, lps)
            scores = torch.where(active[:, None], best, scores)
            last = torch.where(active[:, None], word, last)
            ended = ((word == EOS) & active[:, None]).cpu().numpy()
            for i, j in zip(*np.nonzero(ended)):
                if len(finished[i]) < k:
                    finished[i].append((float(best[i, j]), t, new[i, j], new_lp[i, j]))
            if t == L - 1:
                for i in np.nonzero(active.cpu().numpy())[0]:
                    if not finished[i]:
                        finished[i] = [(float(best[i, j]), t, new[i, j], new_lp[i, j])
                                       for j in range(k)]
            done |= torch.tensor([len(f) >= k for f in finished], device=dev)
            if bool(done.all()):
                break
        tokens = torch.zeros((b, L - 1), dtype=torch.long, device=dev)
        out_lp = torch.zeros((b, L - 1), device=dev)
        for i, hyps in enumerate(finished):
            norm = [s / max(length, 1) ** alpha for s, length, _, _ in hyps]
            _, _, seq, lp = hyps[int(np.argmax(norm))]
            tokens[i], out_lp[i] = seq[1:], lp[1:]
        return tokens, out_lp
