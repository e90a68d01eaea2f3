"""flag_wait_ms.kimi (cell kimi-vl-a3b-msrvtt.beam-512): mean host ms a
request spends waiting for the beam's lagged done flags (the program's span
``navc.decode.flag_wait`` around each read in graphs.lagged_blocks)."""

from benchmark.lm_readers import is_lm
from benchmark.spans import span_ms_per_request


def read(run):
    return span_ms_per_request(run, "navc.decode.flag_wait") if is_lm(run) else None
