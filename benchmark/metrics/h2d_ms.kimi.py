"""h2d_ms.kimi (cell kimi-vl-a3b-msrvtt.beam-512): device ms of host-to-device
copies (the profiler's Memcpy HtoD) per request of the traced window: the
staging of its 512 videos' features."""

from benchmark.lm_readers import is_lm
from benchmark.readers import htod_ms_per_request


def read(run):
    return htod_ms_per_request(run) if is_lm(run) else None
