"""mfu.kimi (cell kimi-vl-a3b-msrvtt.beam-512): FLOPs of the captions answered
in the traced window (lm_costs.py: encodes, prefills and beam steps) over
989 TFLOP/s times the window, in %."""

from benchmark.lm_readers import mfu


def read(run):
    return mfu(run)
