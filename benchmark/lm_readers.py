"""Arithmetic the MLAMoE cells' metric readers share (``readers.py``'s
counterparts for answers that are (tokens, log-probabilities)). A reader
returns None where the run has nothing to read."""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from . import lm_costs
from .readers import answered
from .reference.mla_moe_lm import EOS

# the device kernels of torch._grouped_mm, the routed experts' products: CUTLASS
# sm90 GEMMs over a GroupProblemShape
GROUPED_MM = ("GroupProblemShape",)
# K13, SwiGLU's activation (navc_tpu_torch/csrc/swiglu.cu)
SWIGLU = ("swiglu_kernel",)
# K5, the projection's top-k: its walk and its merge (csrc/vocab_fused.cu, MODE 2)
TOPK = ("argmax_kernel<2, ", "argmax_merge_kernel<2, ")


def is_lm(run) -> bool:
    return run.config.get("decode") == "lm_beam"


def steps(run, req) -> int:
    """The steps the beam must have run for these captions: the longest
    through its EOS (all max_len - 1 where one has none)."""
    tokens = np.asarray(req.hyp[0])
    width = tokens.shape[1]
    ends = np.where((tokens == EOS).any(1), (tokens == EOS).argmax(1) + 1, width)
    return int(ends.max()) if len(ends) else width


def cost(run, req):
    return lm_costs.request_cost(run.config, req.videos, steps(run, req))


def decode_roofline(run) -> Optional[float]:
    """The decodes' bound (lm_costs.py) over their device spans, in %."""
    if not is_lm(run):
        return None
    reqs = [r for r in answered(run) if not math.isnan(r.decode_s)]
    span = sum(r.decode_s for r in reqs)
    if not reqs or span <= 0:
        return None
    return 100.0 * sum(cost(run, r)["decode_bound_s"] for r in reqs) / span


def mfu(run) -> Optional[float]:
    if not is_lm(run) or run.trace is None or run.trace.window_s <= 0:
        return None
    flops = sum(cost(run, r)["flops"] for r in answered(run))
    return 100.0 * flops / (lm_costs.PEAK_BF16_FLOPS * run.trace.window_s)


def kernel_roofline(run, names, bound: str) -> Optional[float]:
    """The requests' ``bound`` (lm_costs.request_cost) over the device time
    of the kernels whose names hold one of ``names``, inside the traced
    window, in %: both over the requests answered in it."""
    if not is_lm(run) or run.trace is None:
        return None
    device_s = sum(s for name, (s, _) in run.trace.kernels.items()
                   if any(g in name for g in names))
    reqs = answered(run)
    if device_s <= 0 or not reqs:
        return None
    return 100.0 * sum(cost(run, r)[bound] for r in reqs) / device_s


def moe_roofline(run) -> Optional[float]:
    """The routed products' bound over the grouped launches' device time."""
    return kernel_roofline(run, GROUPED_MM, "moe_bound_s")


def swiglu_roofline(run) -> Optional[float]:
    """SwiGLU's activations' bound (their bytes) over K13's device time."""
    return kernel_roofline(run, SWIGLU, "swiglu_bound_s")


def expert_load(run) -> Optional[float]:
    """The mean over MoE layers of the busiest expert's routed tokens over
    the mean expert's, from the program's ``navc.moe.expert_tokens``."""
    counts = run.extra.get("expert_tokens") if is_lm(run) else None
    if not counts:
        return None
    c = np.asarray(counts, dtype=np.float64)
    if c.ndim != 2 or not c.size or (c.mean(1) <= 0).any():
        return None
    return float((c.max(1) / c.mean(1)).mean())


def topk_roofline(run) -> Optional[float]:
    """The steps' projections and top-k (their bound) over K5's device time."""
    return kernel_roofline(run, TOPK, "topk_bound_s")
