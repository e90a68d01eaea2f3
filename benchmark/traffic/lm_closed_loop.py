"""Closed-loop captioning in bulk by the MLAMoE language model: closed_loop's
client (one client, whole requests of ``videos`` videos cycled through
``distinct`` requests made at set-up, ``depth`` in flight, the window ending
with the last answer) over a run of its own (``run``), which the harness
calls instead of ``serving.run``: the language model's weights come from
``lm_inputs``, its captioner from ``lm_program``, and ``correct`` from
``lm_check`` (log-probabilities against the reference's teacher-forced
forward). Every answer is (tokens, their log-probabilities).

Parameters: closed_loop's (videos, distinct, depth, check_videos,
warm_requests).
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import torch

from benchmark import harness, inputs, lm_check, lm_inputs, lm_program, serving, trace
from benchmark.harness import Run
from benchmark.traffic import closed_loop


class Client(closed_loop.Client):
    def __init__(self, params, config, seed, device):
        self.params, self.seed = params, seed
        m = dict(n_frames=config["n_frames"], modality_dims=config["modality_dims"],
                 num_category=1)
        # no category: the language model reads none
        self.pools = [(inputs.make_videos(m, params["videos"], seed, inputs.FEATURE_STREAM + i,
                                          device)[0], None)
                      for i in range(params["distinct"])]


def run(ctx: Dict) -> Dict:
    """ctx: run.py's (cell, workload, seed, seconds, trace, device, t0; a
    ``config`` or ``extra`` overrides the configuration file, a
    ``captioner`` wraps the program's). Returns the parts of the result
    line."""
    lm_program.require()
    work, device, seed = ctx["workload"], ctx["device"], ctx["seed"]
    config = ctx.get("config") or harness.config(work["config"])
    run_rec = Run(cell=ctx["cell"], workload=work, config=config, seed=seed,
                  seconds=ctx["seconds"], traced=ctx["trace"])
    cuda = torch.device(device).type == "cuda"
    phases = run_rec.extra.setdefault("phases", {})

    def phase(name):
        phases[name] = time.perf_counter() - ctx["t0"] - sum(phases.values())

    phase("start")
    cfg = lm_program.resolve(config, **ctx.get("extra", {}))
    if cuda:
        lm_program.build_kernels()
    phase("build")
    model = lm_program.build(cfg, device)
    weights = lm_inputs.make_weights(config, seed, device, out=model.state_dict())
    phase("weights")
    client = Client(work["traffic"], config, seed, device)
    phase("videos")
    cap = ctx.get("captioner", lm_program.captioner)(cfg, model, device,
                                                     work["traffic"]["depth"])
    phase("captioner")
    client.warm(cap)
    if cuda:
        torch.cuda.synchronize()
        run_rec.capture_s = lm_program.graph_capture_s(cap)
    phase("warm_up")
    marks: List = []
    if ctx["trace"] and cuda:
        serving._instrument(cap, marks)
    run_rec.setup_s = time.perf_counter() - ctx["t0"]

    span = serving._spans(ctx["trace"])
    with trace.traced(ctx["trace"] and cuda) as traced:
        with span(trace.WINDOW):
            t0 = time.perf_counter()
            reqs = client.window(cap, ctx["seconds"], span)
            run_rec.window_s = time.perf_counter() - t0
    phase("window")
    run_rec.requests = reqs
    if traced:
        run_rec.trace = traced[0]
        run_rec.extra["expert_tokens"] = lm_program.expert_tokens()
        disp = [m[0] for m in marks if m[0] is not None]
        dec = [m[1] for m in marks if m[1] is not None]
        for r, d, (e0, e1) in zip(reqs, disp, dec):
            r.dispatch_s, r.decode_s = d, e0.elapsed_time(e1) / 1e3
    device_rec = {"platform": "gpu" if cuda else "cpu", "kind": "cpu", "count": 1,
                  "memory_peak_bytes": 0}
    if cuda:
        device_rec.update(kind=torch.cuda.get_device_name(0),
                          memory_peak_bytes=int(torch.cuda.max_memory_allocated()))
        if run_rec.trace is not None:
            device_rec.update(busy_s=run_rec.trace.busy_s, window_s=run_rec.trace.window_s)
    del cap, model, marks
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    phase("trace_and_free")
    checks, failed, refs = lm_check.lm_checks(config, weights, client, reqs, device,
                                              work["check"])
    phase("reference")
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    return dict(run=run_rec, correct=correct, attempted=len(reqs), failed=failed,
                device=device_rec, checks=checks, client=client, weights=weights, refs=refs)
