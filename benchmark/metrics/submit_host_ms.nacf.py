"""submit_host_ms.nacf (cell nacf-msrvtt.batch-8192): mean host ms of
StreamingCaptioner's staging and dispatch of a request (the benchmark's span
around ``_dispatch``)."""

from benchmark.readers import mean_dispatch_ms


def read(run):
    return mean_dispatch_ms(run)
