"""inflight_at_result.nacf: mean number of newer requests still unfinished on
the card when a request's tokens reached the host (the program's counter
``navc.inflight_at_result``; at depth 2 at most 2), in the traced window."""

from benchmark.spans import counter_mean


def read(run):
    return counter_mean(run, "navc.inflight_at_result")
