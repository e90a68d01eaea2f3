"""Helpers of the benchmark's CPU tests: a cell's files at a size the CPU
runs in seconds (every width cut, the traffic cut to a few videos)."""

from __future__ import annotations

import copy
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402

TINY_OVERRIDES = dict(dim_hidden=32, num_attention_heads=4, intermediate_size=48,
                      vocab_size=120, n_frames=4, dim_m=16, dim_i=16)
TINY_MODEL = dict(dim_hidden=32, num_attention_heads=4, intermediate_size=48,
                  vocab_size=120, n_frames=4, modality_dims=[16, 16])
TINY_TRAFFIC = {"closed_loop": dict(videos=6, check_videos=4, warm_requests=2),
                "open_loop": dict(rate=20.0, sizes=[2, 3, 5], pool_videos=8, block=6)}
# the open-loop kind, which no cell uses yet: a cell file of it at a tiny size
OPEN_LOOP = {"config": "nacf-msrvtt", "chips": 1, "why": "open loop",
             "traffic": dict(TINY_TRAFFIC["open_loop"], kind="open_loop", schedule_seed=3, depth=2),
             "check": {"limits": {"caption_mismatch": 0.3}}}


def tiny_config(name: str, **extra) -> dict:
    c = copy.deepcopy(harness.config(name))
    for side in ("student", "teacher"):
        if side in c:
            c[side]["overrides"].update(TINY_OVERRIDES, **extra)
            c[side]["model"].update(TINY_MODEL)
            for k, v in extra.items():
                if k in c[side]["model"]:
                    c[side]["model"][k] = v
    return c


def tiny_ctx(cell: str, seed: int = 5, seconds: float = 1.0, **extra) -> dict:
    """A run's context for ``cell`` (a cell's name, or "open_loop")."""
    if cell == "open_loop":
        work = copy.deepcopy(OPEN_LOOP)
    else:
        work = copy.deepcopy(harness.workload(cell))
        work["traffic"].update(TINY_TRAFFIC[work["traffic"]["kind"]])
    return dict(cell=cell, workload=work, seed=seed, seconds=seconds, trace=False,
                device="cpu", t0=time.perf_counter(), config=tiny_config(work["config"], **extra))


def run_tiny(ctx: dict) -> dict:
    from benchmark import serving

    client = harness.traffic(ctx["workload"]["traffic"]["kind"])
    parts = serving.run(ctx, client.Client)
    parts["line"] = harness.result_line(parts["run"], harness.metrics_for(
        harness.spec(), ctx["cell"], False), parts["correct"], parts["attempted"],
        parts["failed"], parts["device"], parts["checks"])
    return parts
