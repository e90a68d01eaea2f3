"""idle_share.kimi (cell kimi-vl-a3b-msrvtt.beam-512): the share of the traced
window in which no device operation ran, in %."""

from benchmark.lm_readers import is_lm
from benchmark.readers import idle_share


def read(run):
    return idle_share(run) if is_lm(run) else None
