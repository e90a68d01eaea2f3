"""prefill_host_ms.kimi (cell kimi-vl-a3b-msrvtt.beam-512): mean host ms a
request spends issuing its prefill (the program's span ``navc.prefill``)."""

from benchmark.lm_readers import is_lm
from benchmark.spans import span_ms_per_request


def read(run):
    return span_ms_per_request(run, "navc.prefill") if is_lm(run) else None
