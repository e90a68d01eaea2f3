"""submit_host_ms.arb (cell arb-msrvtt.batch-1024): mean host ms of
StreamingCaptioner's staging and dispatch of a request (the benchmark's span
around ``_dispatch``)."""

from benchmark.readers import mean_dispatch_ms


def read(run):
    return mean_dispatch_ms(run)
