"""A serving cell's run: set-up, the measured window, the check.

Set-up makes the weights and the traffic's videos from the seed, builds the
program's StreamingCaptioner and lets the traffic warm every request shape
it will send (the graphs captured, the page-locked slots allocated). The
window is the traffic's client loop. Once it has closed, the peak memory is
read, the program is freed, and the reference captions the videos the
traffic names (``check_rows``); every served row of those videos is held
against them.
"""

from __future__ import annotations

import contextlib
import gc
import time
from typing import Callable, Dict, List

import torch

from . import harness, inputs, program, trace
from .check import serving_checks
from .harness import Run


def _spans(enabled: bool) -> Callable:
    return trace.span if enabled else (lambda name: contextlib.nullcontext())


def _instrument(cap, reqs_sink: List) -> None:
    """Traced runs: each dispatch's host time (the benchmark's span around
    the captioner's staging and dispatch) and each decode's device span
    (CUDA events around the decode call), in submission order."""
    dispatch, generate = cap._dispatch, cap.generate

    def timed_dispatch(feats, category):
        t0 = time.perf_counter()
        with trace.span("bench.dispatch"):
            out = dispatch(feats, category)
        reqs_sink.append([time.perf_counter() - t0, None])
        return out

    def timed_generate(*args, **kwargs):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = generate(*args, **kwargs)
        end.record()
        reqs_sink.append([None, (start, end)])
        return out

    cap._dispatch = timed_dispatch
    cap.generate = timed_generate


def run(ctx: Dict, make_traffic: Callable) -> Dict:
    """ctx: {"cell", "workload", "seed", "seconds", "trace", "device", "t0"};
    ``make_traffic(params, config, seed, device)`` the traffic kind's
    client. Returns the parts of the result line."""
    work, device, seed = ctx["workload"], ctx["device"], ctx["seed"]
    config = ctx.get("config") or harness.config(work["config"])
    run_rec = Run(cell=ctx["cell"], workload=work, config=config, seed=seed,
                  seconds=ctx["seconds"], traced=ctx["trace"])
    cuda = torch.device(device).type == "cuda"
    phases = run_rec.extra.setdefault("phases", {})

    def phase(name):
        phases[name] = time.perf_counter() - ctx["t0"] - sum(phases.values())

    phase("start")
    if cuda:
        program.build_kernels()
    phase("build")
    weights = {"student": inputs.make_weights(config["student"]["model"], seed, device)}
    if "teacher" in config:
        weights["teacher"] = inputs.make_weights(config["teacher"]["model"], seed + 1, device)
    phase("weights")
    client = make_traffic(work["traffic"], config, seed, device)
    phase("videos")
    cap = ctx.get("captioner", program.captioner)(config, weights, device,
                                                  work["traffic"]["depth"])
    phase("captioner")
    client.warm(cap)
    if cuda:
        torch.cuda.synchronize()
        run_rec.capture_s = program.graph_capture_s(cap)
    phase("warm_up")
    marks: List = []
    if ctx["trace"] and cuda:
        _instrument(cap, marks)
    run_rec.setup_s = time.perf_counter() - ctx["t0"]

    with trace.traced(ctx["trace"] and cuda) as traced:
        with _spans(ctx["trace"])(trace.WINDOW):
            t0 = time.perf_counter()
            reqs = client.window(cap, ctx["seconds"], _spans(ctx["trace"]))
            run_rec.window_s = time.perf_counter() - t0
    phase("window")
    run_rec.requests = reqs
    if traced:
        run_rec.trace = traced[0]
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
    del cap, marks
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    phase("trace_and_free")
    checks, failed, refs = serving_checks(config, weights, client, reqs, device,
                                          work["check"]["limits"])
    phase("reference")
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    return dict(run=run_rec, correct=correct, attempted=len(reqs), failed=failed,
                device=device_rec, checks=checks, client=client, weights=weights, refs=refs)
