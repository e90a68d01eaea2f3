"""The traced window: torch.profiler over the measured window, reduced to
the device's busy time, kernel time by name, host-to-device copies, and the
idle gaps labelled by what the host was doing.

The window is the benchmark's own ``bench.window`` span; device events are
the profiler's CUDA activities (kernels, copies, sets), user annotations
left out. Busy time is the union of their intervals inside the window.
"""

from __future__ import annotations

import bisect
import contextlib
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

WINDOW = "bench.window"


@dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: Dict[str, Tuple[float, int]]   # name: (device seconds, count)
    htod_s: float                            # Memcpy HtoD device seconds
    gaps: List[Tuple[str, float]] = field(default_factory=list)  # longest first

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:top]
        return {"device_ops": [[name, s] for name, (s, _) in ops],
                "idle_gaps": [[label, s] for label, s in self.gaps[:top]]}


@contextlib.contextmanager
def traced(enabled: bool):
    """Profile the block when ``enabled``; yields a list that holds the
    Trace once the block has ended."""
    out: List[Trace] = []
    if not enabled:
        yield out
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield out
        torch.cuda.synchronize()
    out.append(reduce(prof.profiler.kineto_results.events()))


def span(name: str):
    """A host span the trace can label idle time with (a no-op context
    outside a profile)."""
    import torch

    return torch.profiler.record_function(name)


def _label(host: List[Tuple[int, int, str]], starts: List[int], t: int) -> str:
    """The benchmark's innermost span and the innermost host operation that
    hold time ``t``."""
    bench, inner, inner_start = "", "", -1
    for s, e, name in host[:bisect.bisect_right(starts, t)]:
        if s <= t < e:
            if name.startswith("bench.") and name != WINDOW:
                bench = name
            if s >= inner_start and name != WINDOW:
                inner, inner_start = name, s
    if bench and inner and inner != bench:
        return "%s > %s" % (bench, inner)
    return bench or inner or "host outside any operation"


def reduce(events) -> Trace:
    """The Trace of the profiler's raw events (``_KinetoEvent``s: name,
    device type, start and end in ns, whether a user annotation)."""
    from torch.autograd import DeviceType

    win = [e for e in events if e.name() == WINDOW and e.device_type() == DeviceType.CPU]
    if not win:
        raise RuntimeError("the profile holds no %s span" % WINDOW)
    w0, w1 = win[0].start_ns(), win[0].end_ns()
    dev, host = [], []
    for e in events:
        s, t = e.start_ns(), e.end_ns()
        if t <= w0 or s >= w1:
            continue
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                dev.append((max(s, w0), min(t, w1), e.name()))
        else:
            host.append((s, t, e.name()))
    dev.sort()
    host.sort()
    kernels: Dict[str, list] = {}
    htod = 0
    for s, t, name in dev:
        acc = kernels.setdefault(name, [0, 0])
        acc[0] += t - s
        acc[1] += 1
        if name.startswith("Memcpy HtoD"):
            htod += t - s
    busy, idle = 0, []
    cur_s = cur_e = w0
    for s, t, _ in dev:
        if s > cur_e:
            busy += cur_e - cur_s
            idle.append((cur_e, s))
            cur_s, cur_e = s, t
        else:
            cur_e = max(cur_e, t)
    busy += cur_e - cur_s
    if cur_e < w1:
        idle.append((cur_e, w1))
    idle.sort(key=lambda g: g[0] - g[1])
    starts = [h[0] for h in host]
    gaps = [(_label(host, starts, s), (t - s) / 1e9) for s, t in idle[:10]]
    return Trace(window_s=(w1 - w0) / 1e9, busy_s=busy / 1e9,
                 kernels={k: (v[0] / 1e9, v[1]) for k, v in kernels.items()},
                 htod_s=htod / 1e9, gaps=gaps)
