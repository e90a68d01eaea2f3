"""The program's own record of its serving path, for the metrics that read it:
the spans and counters navc_tpu_torch.runtime.summary keeps while a profile
records (here, the traced window). Spans: {name: {"count", "total_s",
"self_s"}}; counters: {name: {"count", "total"}}. Every function returns None
where there is nothing to read: an untraced run, a run off the card, or a
program that keeps no such record."""

from __future__ import annotations

from typing import Dict, Optional

from .harness import Run

REQUEST = "navc.submit"  # the root span of a request: one a request


def program_record(run: Run) -> Optional[Dict]:
    if run.trace is None:
        return None
    try:
        from navc_tpu_torch.runtime import summary
    except ImportError:
        return None
    read = getattr(summary, "record", None)
    if read is None:
        return None
    rec = read()
    return rec if rec.get("spans") or rec.get("counters") else None


def span_ms_per_request(run: Run, name: str) -> Optional[float]:
    """Host ms inside the span ``name`` (summed, nested calls counted once
    each) over the requests submitted."""
    rec = program_record(run)
    if rec is None:
        return None
    spans = rec["spans"]
    n = spans.get(REQUEST, {}).get("count", 0)
    if not n or name not in spans:
        return None
    return spans[name]["total_s"] * 1e3 / n


def counter_mean(run: Run, name: str, scale: float = 1.0) -> Optional[float]:
    """A counter's total over its count, times ``scale``."""
    rec = program_record(run)
    c = None if rec is None else rec["counters"].get(name)
    if not c or not c["count"]:
        return None
    return c["total"] * scale / c["count"]
