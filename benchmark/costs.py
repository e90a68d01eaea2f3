"""Operations and bytes of the work a request needs, and the card's peaks.

Counted from the configuration's sizes and what the decode produced,
whatever implements the work: the matmul FLOPs of the algorithm (bench.py's
counts, bench.py:93-178, written here without JAX and with the encode
added) and the bytes it must move at least (each input byte read once, each
output byte written once). The published peaks of one H100 SXM (dense,
without sparsity): 989 TFLOP/s in bf16 and 3.35 TB/s of HBM.
"""

from __future__ import annotations

import math
from typing import Dict

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def enc_positions(m: Dict) -> int:
    """The encoder output's positions: n_frames per modality stream."""
    return m["n_frames"] * len(m["modality"])


def encode_flops(m: Dict) -> float:
    """One video's encode: each stream's input projection and highway
    gates, and the length head when the model has one."""
    d, tf = m["dim_hidden"], m["n_frames"]
    flops = sum(2 * tf * (dim * d + 2 * d * d) for dim in m["modality_dims"])
    if m["length_head"]:
        flops += 2 * d * d + 2 * d * m["max_len"]
    return float(flops)


def _nar_forward(m: Dict, q: int, te: int) -> float:
    """One decoder forward of one canvas row set with ``q`` query positions
    (the keys and values of all max_len positions) and its vocabulary
    projection (bench.py:106-118)."""
    d, L, v, ffn = m["dim_hidden"], m["max_len"], m["vocab_size"], m["intermediate_size"]
    return float(2 * q * d * d + 2 * 2 * L * d * d + 2 * 2 * q * L * d + 3 * 2 * q * d * d
                 + 2 * 2 * q * te * d + 2 * 2 * q * d * ffn + 2 * q * d * v)


def nacf_decode_flops(m: Dict) -> float:
    """One video's NACF decode (bench.py::decode_flops_per_caption): per
    length beam, the CT pass, the refinements at the widths they re-predict
    (floor(L (1 - c/T)) positions, the CT completion at full width) and the
    teacher's rescoring forward; the cross-attention K/V once per video for
    each model."""
    te, L = enc_positions(m), m["max_len"]
    t = m["iterations"] + (1 if m["use_ct"] else 0)
    widths = [L] + [L if m["use_ct"] and c == 1 else max(1, int(math.floor(L * (1.0 - c / t))))
                    for c in range(1, t)] + [L]
    d = m["dim_hidden"]
    return sum(_nar_forward(m, q, te) for q in widths) * m["length_beam_size"] \
        + 2 * 2 * 2 * te * d * d


def beam_decode_flops(m: Dict, steps: int) -> float:
    """One video's KV-cached beam search over ``steps`` steps
    (bench.py::arb_flops_per_caption, cached): per beam and step one
    position's layer against the cache and its vocabulary projection; the
    cross K/V once."""
    d, v, ffn, k = m["dim_hidden"], m["vocab_size"], m["intermediate_size"], m["beam_size"]
    te, span = enc_positions(m), m["max_len"] - 1
    per_step = (4 * 2 * d * d + 2 * 2 * d * d + 2 * 2 * d * ffn + 2 * 2 * span * d
                + 2 * 2 * te * d + 2 * d * v)
    return float(k * (steps * per_step + 2 * 2 * te * d * d))


def param_count(m: Dict) -> int:
    from .reference.model import param_shapes

    return sum(math.prod(s) for k, s in param_shapes(m).items()
               if not k.endswith(("num_batches_tracked", "running_mean", "running_var")))


def request_cost(config: Dict, videos: int, steps: int = 0) -> Dict[str, float]:
    """{"flops", "bytes", "decode_flops", "decode_bytes"} of one request of
    ``videos`` videos (``steps``: the beam steps a beam decode ran)."""
    m = config["student"]["model"]
    models = [m] + ([config["teacher"]["model"]] if "teacher" in config else [])
    if config["decode"] == "nacf":
        dec = nacf_decode_flops(m) * videos
    else:
        dec = beam_decode_flops(m, steps) * videos
    enc = sum(encode_flops(x) for x in models) * videos
    feats = videos * m["n_frames"] * sum(m["modality_dims"]) * 4
    weights = sum(param_count(x) for x in models) * 2  # bf16 operands
    out = videos * m["max_len"] * 4
    return {"flops": enc + dec, "bytes": float(feats + weights + out),
            "decode_flops": dec, "decode_bytes": float(weights + out)}


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over the bf16 peak and the bytes over HBM's."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)
