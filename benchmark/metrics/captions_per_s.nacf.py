"""captions_per_s.nacf (cell nacf-msrvtt.batch-8192): captions returned to the
host over the window, over the window's host seconds (the window ends with
the last answer)."""

from benchmark.readers import answered


def read(run):
    n = sum(r.videos for r in answered(run))
    return n / run.window_s if run.window_s > 0 else None
