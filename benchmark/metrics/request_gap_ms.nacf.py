"""request_gap_ms.nacf: mean device ms between a request's end and the next
one's start (the program's CUDA events before a request's copy to the card
and after its decode is queued, counted as ``navc.request_gap_s``): the
card idle, waiting for the next request, in the traced window."""

from benchmark.spans import counter_mean


def read(run):
    return counter_mean(run, "navc.request_gap_s", 1e3)
