"""h2d_ms.arb (cell arb-msrvtt.batch-1024): device ms of host-to-device copies
(the profiler's Memcpy HtoD) per request of the traced window: the staging
of its features."""

from benchmark.readers import htod_ms_per_request


def read(run):
    return htod_ms_per_request(run)
