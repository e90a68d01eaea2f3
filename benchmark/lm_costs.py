"""Operations and bytes of the MLAMoE cells' work, from the configuration's
published sizes (the keys of its config.json) and what a request ran.

FLOPs are the algorithm's matrix products (2 per multiply-add), as the
program computes them: the prefill's latent attention decompressed over the
causal prefix, each step's in the absorbed form against the latent cache
(``q_nope W_uk`` and the scores and values over the 576-wide entries, then
``W_uv``), the router, the k chosen experts and the shared ones, the dense
layer and the vocabulary projection of every beam row. Bytes are the least
a step must move: every weight it uses read once (the experts that tokens
reached; at 240 tokens an expert all 64 are), the caches read once and the
new entries written once. The card's peaks are costs.py's.
"""

from __future__ import annotations

from typing import Dict, Tuple

from .costs import PEAK_BF16_FLOPS, PEAK_BYTES, bound_s, encode_flops  # noqa: F401

BF16 = 2


def _sizes(m: Dict):
    return (m["hidden_size"], m["num_attention_heads"], m["qk_nope_head_dim"],
            m["qk_rope_head_dim"], m["v_head_dim"], m["kv_lora_rank"])


def n_moe(m: Dict) -> int:
    return m["num_hidden_layers"] - m["first_k_dense_replace"]


def prefix_len(m: Dict) -> int:
    return m["n_frames"] * len(m["modality"])


def routed_call(m: Dict, tokens: int, touched: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one MoE layer's routed products over ``tokens``
    tokens with ``touched`` experts reached: gate/up and down of each
    (token, expert) pair; the touched experts' weights read once, the
    gathered inputs read and the outputs written once."""
    d, inter, k = m["hidden_size"], m["moe_intermediate_size"], m["num_experts_per_tok"]
    pairs = tokens * k
    flops = pairs * 3 * 2 * d * inter
    nbytes = touched * 3 * d * inter * BF16 + pairs * (2 * d + 3 * inter) * BF16
    return float(flops), float(nbytes)


def _ffn_flops(m: Dict, tokens: int) -> float:
    d = m["hidden_size"]
    dense = m["first_k_dense_replace"] * tokens * 3 * 2 * d * m["intermediate_size"]
    shared = tokens * 3 * 2 * d * m["moe_intermediate_size"] * m["n_shared_experts"]
    router = tokens * 2 * d * m["n_routed_experts"]
    routed = routed_call(m, tokens, m["n_routed_experts"])[0]
    return float(dense + n_moe(m) * (shared + router + routed))


def prefill_flops(m: Dict, videos: int) -> float:
    """The prefix's positions through every layer, causal, decompressed."""
    d, h, dn, dr, dv, r = _sizes(m)
    p = prefix_len(m)
    tokens = videos * p
    proj = 2 * d * h * (dn + dr) + 2 * d * (r + dr) + 2 * r * h * (dn + dv) + 2 * h * dv * d
    keys = p * (p + 1) // 2  # causal: position i attends to i + 1 positions
    attn = videos * keys * 2 * h * (dn + dr + dv)
    return float(m["num_hidden_layers"] * (tokens * proj + attn) + _ffn_flops(m, tokens))


def step_flops(m: Dict, rows: int, t: int) -> float:
    """Step t (1-based) of ``rows`` beam rows: one position each against
    the prefix and t caption positions, absorbed, then the projection."""
    d, h, dn, dr, dv, r = _sizes(m)
    ctx = prefix_len(m) + t
    proj = (2 * d * h * (dn + dr) + 2 * d * (r + dr) + 2 * h * dn * r + 2 * h * r * dv
            + 2 * h * dv * d)
    attn = ctx * 2 * h * (2 * r + dr)
    layers = m["num_hidden_layers"] * rows * (proj + attn)
    return float(layers + _ffn_flops(m, rows) + rows * 2 * d * m["vocab_size"])


def weight_bytes(m: Dict, embed_rows: int) -> float:
    """The weights a pass through every layer and the head reads: all of
    them but the token embeddings, of which ``embed_rows`` rows."""
    from .reference.mla_moe_lm import param_shapes

    total = 0
    for k, s in param_shapes(m).items():
        if not k.startswith("lm."):
            continue
        n = 1
        for x in s:
            n *= x
        if k == "lm.embed_tokens.weight":
            n = embed_rows * s[1]
        total += n * (4 if k.endswith("e_score_correction_bias") else BF16)
    return float(total)


def step_bytes(m: Dict, videos: int, rows: int, t: int) -> float:
    """Step t's weights, the prefix cache and t caption positions of the
    latent cache read, one entry a row and layer written."""
    r, dr = m["kv_lora_rank"], m["qk_rope_head_dim"]
    entry = (r + dr) * BF16 * m["num_hidden_layers"]
    return (weight_bytes(m, rows) + entry * (videos * prefix_len(m) + rows * t)
            + entry * rows)


def activation_bytes(m: Dict, tokens: int) -> float:
    """Bytes SwiGLU's activation (K13) moves at least over ``tokens``
    tokens through every layer: each MLP's gate/up product read and its
    activation written once (bf16), a routed pair's weight read (float32)."""
    k = m["num_experts_per_tok"]
    dense = m["first_k_dense_replace"] * tokens * 3 * m["intermediate_size"] * BF16
    routed = tokens * k * (3 * m["moe_intermediate_size"] * BF16 + 4)
    shared = tokens * 3 * m["moe_intermediate_size"] * m["n_shared_experts"] * BF16
    return float(dense + n_moe(m) * (routed + shared))


def topk_step(m: Dict, rows: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of a step's projection and top-k (K5): every row's
    logits' products; the head and the rows read once, k (log-prob, id)
    pairs a row written."""
    d, v, k = m["hidden_size"], m["vocab_size"], m["beam_size"]
    return float(2 * rows * d * v), float((v + rows) * d * BF16 + rows * k * 8)


def request_cost(m: Dict, videos: int, steps: int) -> Dict[str, float]:
    """{"flops", "decode_flops", "decode_bound_s", "moe_flops", "moe_bound_s",
    "swiglu_bound_s", "topk_bound_s"} of one request of ``videos`` videos whose beam ran
    ``steps`` steps: the decode is the prefill and the steps, each bounded
    by the larger of its operations over the bf16 peak and its bytes over
    HBM's; the MoE part is the routed products of every MoE layer call,
    each so bounded, as is each step's projection and top-k; SwiGLU's
    activations are bounded by their bytes."""
    k = m["beam_size"]
    rows = videos * k
    enc = videos * encode_flops(dict(dim_hidden=m["hidden_size"], n_frames=m["n_frames"],
                                     modality_dims=m["modality_dims"], length_head=False))
    pre_f = prefill_flops(m, videos)
    pre_b = weight_bytes(m, 0) + videos * prefix_len(m) * m["hidden_size"] * 4
    dec_f, dec_bound = pre_f, bound_s(pre_f, pre_b)
    calls = [videos * prefix_len(m)] + [rows] * steps
    for t in range(1, steps + 1):
        f = step_flops(m, rows, t)
        dec_f += f
        dec_bound += bound_s(f, step_bytes(m, videos, rows, t))
    moe_f = moe_bound = 0.0
    for tokens in calls:
        f, b = routed_call(m, tokens, m["n_routed_experts"])
        moe_f += n_moe(m) * f
        moe_bound += n_moe(m) * bound_s(f, b)
    act = sum(activation_bytes(m, tokens) for tokens in calls)
    return {"flops": enc + dec_f, "decode_flops": dec_f, "decode_bound_s": dec_bound,
            "moe_flops": moe_f, "moe_bound_s": moe_bound, "swiglu_bound_s": act / PEAK_BYTES,
            "topk_bound_s": steps * bound_s(*topk_step(m, rows))}
