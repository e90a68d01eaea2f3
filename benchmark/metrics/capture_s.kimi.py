"""capture_s.kimi (cell kimi-vl-a3b-msrvtt.beam-512): seconds the captioner's
CUDA graph captures took in set-up: its encode's, its prefill's and its
step loop's (lm_program.graph_capture_s)."""

import math

from benchmark.lm_readers import is_lm


def read(run):
    return run.capture_s if is_lm(run) and not math.isnan(run.capture_s) else None
