"""Arithmetic the metrics' readers share: over the run's requests and its
trace. A reader returns None where the run has nothing to read (no trace,
no request of the kind), and the harness then leaves its metric out."""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np

from . import costs
from .check import caption_len
from .harness import Request, Run


def answered(run: Run) -> List[Request]:
    return [r for r in run.requests if r.hyp is not None]


def beam_steps(run: Run, req: Request) -> int:
    """The steps a beam decode must have run for these captions: the
    longest caption through its EOS (the whole span where one has none)."""
    from .reference.model import EOS

    hyp = np.asarray(req.hyp)
    width = caption_len(run.config)
    ends = np.where((hyp == EOS).any(1), (hyp == EOS).argmax(1) + 1, width)
    return int(ends.max()) if len(ends) else width


def cost(run: Run, req: Request):
    steps = beam_steps(run, req) if run.config["decode"] == "beam" else 0
    return costs.request_cost(run.config, req.videos, steps)


def mean_dispatch_ms(run: Run) -> Optional[float]:
    vals = [r.dispatch_s for r in run.requests if not math.isnan(r.dispatch_s)]
    return float(np.mean(vals) * 1e3) if vals else None


def htod_ms_per_request(run: Run) -> Optional[float]:
    if run.trace is None or not run.requests:
        return None
    return run.trace.htod_s * 1e3 / len(run.requests)


def decode_roofline(run: Run, decode: str) -> Optional[float]:
    """The decodes' bound (costs.py) over their device spans, in %."""
    if run.config["decode"] != decode:
        return None
    reqs = [r for r in answered(run) if not math.isnan(r.decode_s)]
    span = sum(r.decode_s for r in reqs)
    if not reqs or span <= 0:
        return None
    bound = 0.0
    for r in reqs:
        c = cost(run, r)
        bound += costs.bound_s(c["decode_flops"], c["decode_bytes"])
    return 100.0 * bound / span


def mfu(run: Run) -> Optional[float]:
    """FLOPs of the requests answered in the traced window over the bf16
    peak times the window, in %."""
    if run.trace is None or run.trace.window_s <= 0:
        return None
    flops = sum(cost(run, r)["flops"] for r in answered(run))
    return 100.0 * flops / (costs.PEAK_BF16_FLOPS * run.trace.window_s)


def idle_share(run: Run) -> Optional[float]:
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
