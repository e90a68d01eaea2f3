"""mfu.nacf (cell nacf-msrvtt.batch-8192): FLOPs of the captions answered in
the traced window (costs.py: encodes and decodes) over 989 TFLOP/s times the
window, in %."""

from benchmark.readers import mfu


def read(run):
    return mfu(run)
