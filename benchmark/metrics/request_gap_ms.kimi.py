"""request_gap_ms.kimi (cell kimi-vl-a3b-msrvtt.beam-512): mean device ms
between a request's end and the next one's start (the program's counter
``navc.request_gap_s``): the card idle, waiting for the next request."""

from benchmark.lm_readers import is_lm
from benchmark.spans import counter_mean


def read(run):
    return counter_mean(run, "navc.request_gap_s", 1e3) if is_lm(run) else None
