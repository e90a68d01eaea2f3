"""Scalar summaries and profiling hooks (port of navc_tpu/runtime/summary.py).

Capability parity with the reference's tensorboardX usage (misc/run.py:282,
misc/crit.py:193-196, misc/optim.py:42-43): scalars are appended to a JSONL
events file that any dashboard can tail; if tensorboardX happens to be
installed the same scalars are mirrored to it.

``trace`` wraps a block in a ``torch.profiler`` trace (host and, on the
card, device activity) written to its directory in TensorBoard's profile
layout, where navc_tpu's wraps it in a jax.profiler trace; ``StepTimer``
records per-step wall-clock with warm-up skipping: its default ``skip=1``
leaves out the first step, navc_tpu's compile step and the port's warm-up
and capture of the step's CUDA graph.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Optional

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


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """torch.profiler trace of the block into ``logdir`` (a
    ``*.pt.trace.json`` file per trace); no-op when logdir is falsy."""
    if not logdir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts, on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
        yield


class StepTimer:
    """Mean per-step wall clock, skipping the first (warm-up and capture)
    steps. The clock is the host's: a step that the caller does not wait
    for is timed as its enqueue."""

    def __init__(self, skip: int = 1):
        self.skip = skip
        self.times = []
        self._t0 = None
        self._n = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._n += 1
        if self._n > self.skip:
            self.times.append(dt)

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times) if self.times else 0.0

    @property
    def count(self) -> int:
        return len(self.times)
