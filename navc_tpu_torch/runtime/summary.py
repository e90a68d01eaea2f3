"""Scalar summaries, profiling hooks and the serving path's spans (port of
navc_tpu/runtime/summary.py).

Capability parity with the reference's tensorboardX usage (misc/run.py:282,
misc/crit.py:193-196, misc/optim.py:42-43): scalars are appended to a JSONL
events file that any dashboard can tail; if tensorboardX happens to be
installed the same scalars are mirrored to it.

``trace`` wraps a block in a ``torch.profiler`` trace (host and, on the
card, device activity) written to its directory as a ``*.pt.trace.json``,
where navc_tpu's wraps it in a jax.profiler trace; beside it, the spans'
record of the block as ``*.navc.json``.

``span(name, request)`` marks a stretch of host work. While a profile
records, it opens a profiler range of that name (on the trace's clock, with
the request id as its ``request`` argument where the profile records
shapes, as ``trace`` does) and adds its host seconds to the record kept per
span name: count, total and self (total less what its child spans took).
``count(name, value, n)`` adds to a counter of the same record. With no
profile recording, a span costs one check of the profiler's state and does
nothing else. ``record()`` reads the record; ``clear_record()`` empties it.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import time
from typing import Dict, List, Optional

import torch


class SummaryWriter:
    def __init__(self, logdir: str):
        self.logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, "events.jsonl")
        self._tb = None
        try:  # optional mirror
            from tensorboardX import SummaryWriter as TB
            self._tb = TB(logdir)
        except Exception:
            self._tb = None

    def add_scalar(self, tag: str, value, global_step: int = 0) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps({"tag": tag, "value": float(value),
                                "step": int(global_step),
                                "wall_time": time.time()}) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, value, global_step=global_step)

    def add_scalars(self, scalars: Dict[str, float], global_step: int = 0) -> None:
        for k, v in scalars.items():
            self.add_scalar(k, v, global_step)

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()


# the record, process-wide as the profiler it follows: {span name: [count,
# total s, self s]}, {counter: [count, total]}
_SPANS: Dict[str, list] = {}
_COUNTERS: Dict[str, list] = {}
_OPEN: List["_Span"] = []  # the open spans, innermost last
_NULL = contextlib.nullcontext()
_clock = time.perf_counter
recording = torch.autograd._profiler_enabled  # whether a profile records


class _Span:
    __slots__ = ("name", "request", "range", "t0", "children")

    def __init__(self, name: str, request: Optional[int]):
        if request is None and _OPEN:
            request = _OPEN[-1].request
        self.name, self.request, self.children = name, request, 0.0
        self.range = (torch._C._profiler._RecordFunctionFast(name) if request is None else
                      torch._C._profiler._RecordFunctionFast(name, (), {"request": request}))

    def __enter__(self):
        _OPEN.append(self)
        self.range.__enter__()
        self.t0 = _clock()

    def __exit__(self, *exc):
        dt = _clock() - self.t0
        self.range.__exit__(*exc)
        _OPEN.pop()
        if _OPEN:
            _OPEN[-1].children += dt
        entry = _SPANS.setdefault(self.name, [0, 0.0, 0.0])
        entry[0] += 1
        entry[1] += dt
        entry[2] += dt - self.children


def span(name: str, request: Optional[int] = None):
    """A context that marks host work while a profile records (a shared
    no-op context otherwise). ``request``: the request id its range carries;
    None takes the enclosing span's."""
    if not recording():
        return _NULL
    return _Span(name, request)


def count(name: str, value, n: int = 1) -> None:
    """Adds ``value`` (a number, or an array added elementwise) and ``n`` to
    the counter ``name`` of the record."""
    entry = _COUNTERS.setdefault(name, [0, 0.0])
    entry[0] += n
    entry[1] += value


def record() -> Dict[str, Dict[str, Dict[str, float]]]:
    """The record as plain data: {"spans": {name: {"count", "total_s",
    "self_s"}}, "counters": {name: {"count", "total"}}} (an array counter's
    total as nested lists)."""
    return {"spans": {k: {"count": c, "total_s": t, "self_s": s}
                      for k, (c, t, s) in _SPANS.items()},
            "counters": {k: {"count": c, "total": t.tolist() if hasattr(t, "tolist") else t}
                         for k, (c, t) in _COUNTERS.items()}}


def clear_record() -> None:
    _SPANS.clear()
    _COUNTERS.clear()


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """torch.profiler trace of the block into ``logdir``: a
    ``<host>_<pid>.<ns>.pt.trace.json`` file per trace (TensorBoard's
    layout) and the spans' record of the block beside it as
    ``<host>_<pid>.<ns>.navc.json``; no-op when logdir is falsy."""
    if not logdir:
        yield
        return
    os.makedirs(logdir, exist_ok=True)
    base = os.path.join(logdir, "%s_%d.%d" % (socket.gethostname(), os.getpid(), time.time_ns()))
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    clear_record()
    with torch.profiler.profile(
            activities=acts, record_shapes=True,
            on_trace_ready=lambda prof: prof.export_chrome_trace(base + ".pt.trace.json")):
        yield
    with open(base + ".navc.json", "w") as f:
        json.dump(record(), f, indent=1)
