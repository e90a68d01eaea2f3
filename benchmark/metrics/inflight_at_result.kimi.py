"""inflight_at_result.kimi (cell kimi-vl-a3b-msrvtt.beam-512): mean number of
newer requests still unfinished on the card when a request's tokens reached
the host (the program's counter ``navc.inflight_at_result``; at depth 2 at
most 2)."""

from benchmark.lm_readers import is_lm
from benchmark.spans import counter_mean


def read(run):
    return counter_mean(run, "navc.inflight_at_result") if is_lm(run) else None
