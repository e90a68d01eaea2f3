"""stage_host_ms.kimi (cell kimi-vl-a3b-msrvtt.beam-512): mean host ms a
request spends staging its features (the program's span ``navc.stage``),
over the requests of the traced window."""

from benchmark.lm_readers import is_lm
from benchmark.spans import span_ms_per_request


def read(run):
    return span_ms_per_request(run, "navc.stage") if is_lm(run) else None
