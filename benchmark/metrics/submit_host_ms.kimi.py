"""submit_host_ms.kimi (cell kimi-vl-a3b-msrvtt.beam-512): mean host ms of
StreamingCaptioner's staging and dispatch of a request (the benchmark's span
around ``_dispatch``): the encode, the prefill and the step blocks queued."""

from benchmark.lm_readers import is_lm
from benchmark.readers import mean_dispatch_ms


def read(run):
    return mean_dispatch_ms(run) if is_lm(run) else None
